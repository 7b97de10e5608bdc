"""compile() — turn an EmbeddingPlan into an executable EmbeddingEngine
(port of ``repro.engine.engine``, the single-card subset).

* ``lookup`` — all-tables GnR: one packed launch (K1 / K3 / K2) on packable
  sets, the per-table loop of ``embedding_bag.bag_lookup`` otherwise;
* ``cached_lookup`` — one table's cached GnR, the per-table serving unit:
  the scheduler's slots route each access (K4b for QR, K4a for dense, K5 for
  TT; hashed tables serve uncached through ``bag_lookup``);
* ``serve_gather`` — the batched serving path: the prefetch scheduler's slot
  maps route each access into the packed cache block, and the whole batch's
  embedding layer is ONE kernel launch (``ops.packed_multi_pooled``).

PyTorch runs eagerly, so the port has no counterpart of ``repro``'s
plan-keyed jit.  ``lookup`` is the training entry: gradients reach the
tables through the kernels' plain-version recompute (``kernels/ops.py``).

Telemetry (``repro_torch.obs``, one bool check each while it is off): the
dispatch sites bump ``engine/dispatch/{lookup,cached_lookup,pack,
serve_gather}`` once per call, and ``__init__`` attaches the plan summary.
``repro`` bumps ``engine/compile/serve_gather`` while jax traces its
plan-keyed jit, once per distinct plan in the process; the port, which
traces nothing, bumps it on the first ``serve_gather`` of each distinct
plan in the process, which is what that cache amounts to.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import embedding_bag, hashing, packed_tables, tt_embedding
from repro_torch.engine.plan import EmbeddingPlan, plan as _plan
from repro_torch.engine.spec import EngineSpec
from repro_torch.kernels import ops

# plans whose serve_gather has run in this process (engine/compile/serve_gather)
_SERVED_PLANS: set = set()


class EmbeddingEngine:
    """Executable embedding layer compiled from an ``EmbeddingPlan``."""

    def __init__(self, plan: EmbeddingPlan):
        self.plan = plan
        self.spec = plan.spec
        self.bags = list(plan.spec.bags)
        self._served = False
        self._scales: dict = {}           # device -> (T,) fp32 combiner scale
        if obs.enabled():
            obs.attach("engine_plan", plan.summary())

    def lookup(self, tables: Sequence[dict], indices: torch.Tensor, *,
               lengths: torch.Tensor | None = None) -> torch.Tensor:
        """All-tables GnR, (B, T, K) indices -> (B, T, dim) in the compute
        dtype.  Packed plans make one launch (``packed_multi_bag_lookup``);
        per-table plans run the semantic loop.  Differentiable in the
        tables: DLRM training runs through it."""
        obs.inc("engine/dispatch/lookup")
        if self.plan.packed:
            return packed_tables.packed_multi_bag_lookup(tables, indices, self.bags,
                                                         lengths=lengths)
        if lengths is not None:
            raise NotImplementedError("ragged bags need a packable bag set")
        return embedding_bag.multi_bag_lookup(tables, indices, self.bags)

    def cached_lookup(self, params: dict, idx: torch.Tensor, table: int = 0, *,
                      cache_rows: torch.Tensor | None = None,
                      slot: torch.Tensor | None = None) -> torch.Tensor:
        """Cached GnR for one table, the per-table serving unit.

        Consumes the prefetch scheduler's staged state: ``cache_rows``
        (slots,) names the big-subtable rows resident this batch, ``slot``
        (..., K) routes each access (-1 = miss), both int32 tensors on the
        params' device.  QR runs K4b, dense K4a, TT ``ops.tt_pooled_auto``
        under the config's ``tt_exec`` (its outer cores need no cache),
        hashed tables serve uncached through ``bag_lookup`` (a k-ary
        expansion does not fit the one-row slot map).  Returns (..., dim) in
        the table dtype (hashed: the compute dtype).
        """
        obs.inc("engine/dispatch/cached_lookup")
        bag = self.bags[table]
        emb = bag.emb
        if emb.kind == "qr":
            q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
            cache = params["q"][cache_rows.long()]
            out = ops.cached_qr_pooled(params["q"], cache, params["r"], q_idx, slot, r_idx,
                                       dim_block=self.plan.dim_block)
        elif emb.kind == "tt":
            spec = emb.tt_spec
            i1, i2, i3 = tt_embedding.tt_decompose(idx, spec)
            out = ops.tt_pooled_auto(params["g1"], params["g2"], params["g3"], i1, i2, i3,
                                     dims=spec.dims, exec_mode=emb.tt_exec)
        elif emb.kind == "hashed":
            return embedding_bag.bag_lookup(params, idx, bag)
        else:
            cache = params["table"][cache_rows.long()]
            out = ops.cached_pooled(params["table"], cache, idx, slot,
                                    dim_block=self.plan.dim_block)
        if bag.combiner == "mean":
            out = out / bag.pooling
        return out

    def _layout(self, what: str) -> packed_tables.PackedLayout:
        if not self.plan.packed:
            raise ValueError(f"plan is not packed; {what}")
        return self.plan.layout

    def pack(self, tables: Sequence[dict]) -> dict:
        """Concatenate per-table params into the packed kernel buffers."""
        layout = self._layout("no packed buffers to build")
        obs.inc("engine/dispatch/pack")
        return packed_tables.pack_params(tables, layout)

    def serve_gather(self, packed: dict, idx: torch.Tensor, slot: torch.Tensor,
                     cache_rows: torch.Tensor) -> torch.Tensor:
        """One kernel launch for a whole batch's embedding layer.

        ``packed`` from :meth:`pack`; ``idx`` (B, T, K) logical indices;
        ``slot`` (B, T, K) per-table scheduler slots (-1 = miss);
        ``cache_rows`` the packed cache block's global rows
        (:meth:`packed_cache_rows`).  Returns (B, T, dim).
        """
        layout = self._layout("serve_gather needs a layout")
        obs.inc("engine/dispatch/serve_gather")
        if not self._served:
            self._served = True
            if self.plan not in _SERVED_PLANS:
                _SERVED_PLANS.add(self.plan)
                obs.inc("engine/compile/serve_gather")
        streams = packed_tables.pack_indices(idx, layout)
        streams["slot"] = packed_tables.global_slots(slot, layout)
        # the cache-block gather is the staging copy of the prefetched rows
        cache = packed[packed_tables.big_key(layout.kind)][cache_rows.long()]
        pooled = ops.packed_multi_pooled(
            {**packed, "cache": cache}, streams,
            kind=layout.kind, dims=layout.tt_dims,
        )
        return pooled * self._combiner_scale(pooled.device)[None, :, None].to(pooled.dtype)

    def _combiner_scale(self, device: torch.device) -> torch.Tensor:
        """The (T,) combiner scale on ``device``, uploaded once.  Built anew
        each batch it is a blocking copy from a Python list, which waits for
        the kernel launched before it: the host would wait for the embedding
        layer inside every ``serve_gather``."""
        scale = self._scales.get(device)
        if scale is None:
            scale = self._scales[device] = packed_tables.combiner_scale(
                self.bags, torch.float32, device)
        return scale

    def packed_cache_rows(self, schedulers) -> np.ndarray:
        """Per-table scheduler state -> the packed cache block's global rows."""
        return packed_tables.packed_cache_rows(
            [s.cache_rows() for s in schedulers],
            self._layout("no packed cache block exists"),
        )

    def fresh_schedulers(self):
        return self.plan.fresh_schedulers()

    def summary(self) -> dict:
        return self.plan.summary()


def compile(plan: EmbeddingPlan) -> EmbeddingEngine:  # noqa: A001
    """EmbeddingPlan -> executable EmbeddingEngine."""
    return EmbeddingEngine(plan)


@functools.lru_cache(maxsize=64)
def _engine_for(spec: EngineSpec, num_shards: int) -> EmbeddingEngine:
    return compile(_plan(spec, num_shards=num_shards))


def engine_for(spec: EngineSpec, *, num_shards: int = 1) -> EmbeddingEngine:
    """Memoised no-trace plan + compile: specs are hashable, so a caller
    that resolves its engine per call pays one dict lookup after the
    first."""
    return _engine_for(spec, num_shards)
