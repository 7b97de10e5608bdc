"""compile() — turn an EmbeddingPlan into an executable EmbeddingEngine
(port of ``repro.engine.engine``).

* ``lookup`` — all-tables GnR: one packed launch (K1 / K3 / K2) on packable
  sets, the per-table loop of ``embedding_bag.bag_lookup`` otherwise;
* ``forward_partial`` — the sharded two-level GnR on one rank of a mesh:
  the rank's local partials (one packed launch on its routed streams, or
  the per-kind loop) plus the pooled psum over the row axis, with the
  duplication plan's comm-free tables skipping the combine; differentiable
  (the sharded training step);
* ``gnr`` — the global two-level GnR over a mesh (``repro``'s jitted
  ``shard_map`` wrapper), ``inline_gnr`` the mesh-aware dispatch of a model
  forward (single card without a mesh), ``baseline`` the no-technique
  comparison point (raw rows cross the wire), ``hot_tiers`` the
  duplication plan's replicated rows;
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
``forward_partial``, ``inline_gnr``, ``gnr`` and ``baseline`` bump
``engine/dispatch/{forward_partial,inline_gnr,gnr_build,baseline_build}``
as ``repro``'s do.  ``repro`` bumps ``engine/compile/serve_gather`` while jax traces its
plan-keyed jit, once per distinct plan in the process; the port, which
traces nothing, bumps it on the first ``serve_gather`` of each distinct
plan in the process, which is what that cache amounts to.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import embedding_bag, hashing, packed_tables, tt_embedding
from repro_torch.core import sharded_embedding as SE
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.engine.plan import EmbeddingPlan, plan as _plan
from repro_torch.engine.spec import EngineSpec
from repro_torch.kernels import ops

# plans whose serve_gather has run in this process (engine/compile/serve_gather)
_SERVED_PLANS: set = set()


@dataclasses.dataclass(eq=False)
class _HeldPack:
    """A rank's ``LocalPack`` with its key and weak references to the
    tensors it was packed from; ``finalizers`` drop it when one is freed."""

    key: tuple
    refs: list
    pack: SE.LocalPack
    finalizers: list = dataclasses.field(default_factory=list)


def _release_pack(engine_ref, held: _HeldPack) -> None:
    engine = engine_ref()
    if engine is not None and engine._local_pack is held:
        engine._drop_local_pack()


class EmbeddingEngine:
    """Executable embedding layer compiled from an ``EmbeddingPlan``."""

    def __init__(self, plan: EmbeddingPlan):
        self.plan = plan
        self.spec = plan.spec
        self.bags = list(plan.spec.bags)
        self._served = False
        self._scales: dict = {}           # device -> (T,) fp32 combiner scale
        self._local_pack: _HeldPack | None = None
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

    # -- sharded two-level GnR (one rank of a mesh) ----------------------------

    def local_pack(self, tables: Sequence[dict], mesh, *, hot_tiers=None) -> SE.LocalPack:
        """The rank's ``LocalPack`` (``SE.pack_local``) for these local tables
        and hot tiers on ``mesh``, for calls without grad: built on the
        first call with them and reused while the same tensors come back
        unmodified (identity and ``_version``, so an in-place update such
        as an optimizer step repacks).  One pack is kept at a time, and only
        while its tensors live: the engine holds them by weak reference and
        drops the pack as soon as one of them is freed, so a memoised engine
        (``engine_for``) keeps no rank's shard alive."""
        nsh = mesh.shape[self.spec.row_axis]
        tensors = [v for t in tables for v in t.values()]
        if hot_tiers is not None:
            tensors += [v for t in hot_tiers for v in t.values()]
        key = (nsh, hot_tiers is not None, tuple(t._version for t in tensors))
        held = self._local_pack
        if (held is not None and held.key == key and len(held.refs) == len(tensors)
                and all(r() is t for r, t in zip(held.refs, tensors))):
            return held.pack
        self._drop_local_pack()                 # free the old pack first
        cf = self.plan.comm_free
        pack = SE.pack_local(tables, self.bags, [SE.ShardPlan(b.emb, nsh) for b in self.bags],
                             hot_tiers=hot_tiers, comm_free=cf if any(cf) else None)
        held = self._local_pack = _HeldPack(key, [weakref.ref(t) for t in tensors], pack)
        me = weakref.ref(self)
        held.finalizers = [weakref.finalize(t, _release_pack, me, held) for t in tensors]
        return pack

    def _drop_local_pack(self) -> None:
        held, self._local_pack = self._local_pack, None
        if held is not None:
            for f in held.finalizers:
                f.detach()

    def forward_partial(self, tables: Sequence[dict], indices: torch.Tensor, *, mesh=None,
                        hot_tiers=None) -> torch.Tensor:
        """Two-level GnR body on one rank: local partials + the pooled psum
        over ``spec.row_axis``.

        ``tables`` are this rank's local params (``gnr``'s layout: the big
        subtable's row shard, or the whole table where the duplication plan
        made it comm-free), ``indices`` (B_local, T, K) its batch shard,
        ``mesh`` its ``launch.mesh.Mesh`` (default: the one ``use_rules`` set),
        whose row axis gives the shard count.  Packed plans compute every
        table's local partial in one launch (``SE.packed_local_partial`` over
        the rank's ``LocalPack``, built once per set of tables); per-table
        plans run the per-kind partials in a loop.  Comm-free tables are
        served entirely from local replicas and skip the psum; an
        all-comm-free plan calls no collective.  Returns (B_local, T, dim)
        in the compute dtype.

        Differentiable in ``tables`` (``repro``'s ``shard_map`` under
        ``jax.grad``): the psum is ``collectives.combine`` (identity
        backward), the replicated params enter through
        ``collectives.enter`` (their gradients summed over the row axis),
        and the packed buffers are built in the call, inside autograd.
        Under grad it refuses hot tiers and comm-free tables, which
        ``repro``'s training path does not run either.
        """
        obs.inc("engine/dispatch/forward_partial")
        mesh = mesh if mesh is not None else SH.current_mesh()
        if mesh is None:
            raise ValueError("forward_partial runs on a mesh rank: pass mesh= or use_rules")
        axis = self.spec.row_axis
        nsh = mesh.shape[axis]
        bags = self.bags
        plans = [SE.ShardPlan(b.emb, nsh) for b in bags]
        cf = list(self.plan.comm_free)
        psum_cols = [t for t, c in enumerate(cf) if not c]
        grad = torch.is_grad_enabled() and any(v.requires_grad for t in tables
                                               for v in t.values())
        if grad:
            if hot_tiers is not None or any(cf):
                # repro's training path (inline_gnr) runs neither
                raise NotImplementedError(
                    "forward_partial under grad takes no hot tiers or comm-free tables: "
                    "a hot tier is a copy of table rows made outside the graph "
                    "(make_dup_hot_tiers), so a row served from it would never pass its "
                    "gradient to the table, and a comm-free table skips the combine, so "
                    "its replicas' gradients would need a sum over the row axis that "
                    "this path does not make")
            tables = SE.enter_replicated(tables, bags, mesh, axis)

        if self.plan.packed:
            # under grad the rank's tables are packed in this call, inside
            # autograd: a cached pack would only repack the fresh leaves of
            # every step, and would keep the previous step's graph alive
            pack = None if grad else self.local_pack(tables, mesh, hot_tiers=hot_tiers)
            parts = SE.packed_local_partial(tables, indices, bags, plans, mesh=mesh,
                                            axis=axis, pack=pack)
            if len(psum_cols) == len(bags):
                return collectives.combine(parts, mesh, axis)
            if psum_cols:
                cols = torch.tensor(psum_cols, device=parts.device)
                parts[:, cols] = collectives.combine(parts[:, cols], mesh, axis)
            return parts

        outs, needs_psum = [], []
        for t, (bag, tplan) in enumerate(zip(bags, plans)):
            idx = indices[:, t]
            params = tables[t]
            if cf[t]:
                # replicated everywhere -> full local lookup, no combine
                outs.append(embedding_bag.bag_lookup(params, idx, bag))
                needs_psum.append(False)
                continue
            hot = {} if hot_tiers is None else hot_tiers[t]   # hot_table, hot_slot
            if bag.emb.kind == "qr":
                part = SE.qr_bag_partial(params["q"], params["r"], idx, tplan, mesh=mesh,
                                         axis=axis, **hot)
            elif bag.emb.kind == "tt":
                part = SE.tt_bag_partial(params["g1"], params["g2"], params["g3"], idx, tplan,
                                         mesh=mesh, axis=axis, **hot)
            else:
                part = SE.dense_bag_partial(params["table"], idx, tplan, mesh=mesh, axis=axis)
            if bag.combiner == "mean":
                part = part / bag.pooling
            outs.append(part)
            needs_psum.append(True)
        if all(needs_psum):
            return collectives.combine(torch.stack(outs, dim=1), mesh, axis)
        if any(needs_psum):
            combined = collectives.combine(
                torch.stack([o for o, n in zip(outs, needs_psum) if n], dim=1), mesh, axis)
        res, si = [], 0
        for o, n in zip(outs, needs_psum):
            if n:
                res.append(combined[:, si])
                si += 1
            else:
                res.append(o)
        return torch.stack(res, dim=1)

    def _table_specs(self, bag, comm_free: bool, row_axis: str) -> dict:
        if comm_free:
            keys = {"qr": ("q", "r"), "tt": ("g1", "g2", "g3")}.get(bag.emb.kind, ("table",))
            return {k: P() for k in keys}
        if bag.emb.kind == "qr":
            return {"q": P(row_axis, None), "r": P()}
        if bag.emb.kind == "tt":
            return {"g1": P(), "g2": P(row_axis, None), "g3": P()}
        return {"table": P(row_axis, None)}

    def shard_tables(self, tables: Sequence[dict], mesh) -> list[dict]:
        """This rank's local tables in ``gnr``'s layout, from the global ones:
        each param's block under ``_table_specs`` (``repro``'s ``shard_map``
        in_specs), the row-sharded big subtables padded first
        (``SE.pad_q_table``); comm-free tables whole."""
        out = []
        for params, bag, cf in zip(tables, self.bags, self.plan.comm_free):
            specs = self._table_specs(bag, cf, self.spec.row_axis)
            out.append({k: SH.local_shard(SE.pad_q_table(v, bag.emb) if any(specs[k]) else v,
                                          mesh, specs[k]) for k, v in params.items()})
        return out

    def _check_local(self, tables: Sequence[dict], nsh: int) -> None:
        for t, (params, bag, cf) in enumerate(zip(tables, self.bags, self.plan.comm_free)):
            key = packed_tables.big_key(bag.emb.kind)
            want = SE.padded_q_rows(bag.emb) // (1 if cf else nsh)
            if params[key].shape[0] != want:
                raise ValueError(
                    f"table {t}: {key} has {params[key].shape[0]} rows, the rank's "
                    f"{'replica' if cf else 'row shard'} has {want} "
                    f"(engine.shard_tables gives the local layout)")

    def gnr(self, mesh, *, hot: bool = False):
        """The global two-level GnR over all tables on ``mesh``, run by every
        rank: ``fn(tables, indices, hot_tiers=None)`` -> (B_local, T, dim).

        ``repro`` returns a jitted ``shard_map`` over global arrays; here each
        rank passes its own pieces, as that ``shard_map`` hands them out:
        ``tables`` in the local layout of :meth:`shard_tables` (comm-free
        tables of a duplication plan whole, the others row-sharded over
        ``spec.row_axis``), ``indices`` its block of the batch along
        ``spec.batch_axis`` (``sharding.local_shard(idx, mesh,
        P(batch_axis))``), ``hot_tiers`` whole (:meth:`hot_tiers`); it gets
        back its block of the output.  Plans carrying a duplication plan,
        and ``hot=True``, take the hot tiers.
        """
        obs.inc("engine/dispatch/gnr_build")
        nsh = mesh.shape[self.spec.row_axis]
        with_tiers = hot or self.plan.dup is not None

        def fn(tables, indices, hot_tiers=None):
            if with_tiers and hot_tiers is None:
                raise ValueError("this gnr takes hot tiers (engine.hot_tiers)")
            self._check_local(tables, nsh)
            return self.forward_partial(tables, indices, mesh=mesh,
                                        hot_tiers=hot_tiers if with_tiers else None)

        return fn

    def inline_gnr(self, tables: Sequence[dict], indices: torch.Tensor) -> torch.Tensor:
        """GnR of a model forward (the DLRM forward): no mesh set by
        ``sharding.use_rules``, or no row axis in it -> the single-card
        ``lookup``; otherwise the two-level ``forward_partial`` on this
        rank's row-sharded tables and batch shard.  Differentiable on both
        paths (the sharded DLRM training step runs through it)."""
        obs.inc("engine/dispatch/inline_gnr")
        mesh = SH.current_mesh()
        if mesh is None or self.spec.row_axis not in mesh.shape:
            return self.lookup(tables, indices)
        return self.forward_partial(tables, indices, mesh=mesh)

    def hot_tiers(self, tables: Sequence[dict]) -> list[dict]:
        """Duplication-plan hot-tier tensors (one dict per table) from the
        global tables."""
        if self.plan.dup is None:
            raise ValueError("plan has no duplication plan")
        return SE.make_dup_hot_tiers(tables, self.bags, self.plan.dup)

    def baseline(self, mesh):
        """The no-technique comparison point: plain gathers with every table
        row-sharded, raw rows on the wire.

        ``repro`` jits ``multi_bag_lookup`` with every param constrained to
        ``P(row_axis, None)`` and lets XLA insert the communication.  Lowered
        on a 4-device CPU mesh (dlrm-qr- and dense-like bags), XLA emits ONE
        all-reduce over the row axis of the gathered rows, f32[B, K, dim] per
        table and subtable (each device gathers the rows it owns, zeros
        elsewhere), then pools.  This mirrors it: ``fn(tables, indices)``
        takes :meth:`shard_tables`' layout of a plan without duplication and
        the rank's batch shard; each rank gathers the rows of its block of
        every subtable (a replicated R LUT or TT outer core is split into
        ``ceil(rows / shards)`` blocks here, as XLA splits it), one psum
        combines every subtable's rows, and the bags are pooled from them as
        ``bag_lookup`` pools (each subtable's sum in the compute dtype).
        """
        obs.inc("engine/dispatch/baseline_build")
        row_axis = self.spec.row_axis
        nsh = mesh.shape[row_axis]
        shard = mesh.axis_index(row_axis)
        bags = self.bags

        def owned(buf, ids, lo, compute):
            rows = buf.shape[0]
            if rows == 0:                        # a block past the end of a small table
                return torch.zeros((*ids.shape, buf.shape[1]), dtype=compute, device=ids.device)
            local = ids - lo
            mine = (local >= 0) & (local < rows)
            got = buf[torch.clamp(local, 0, rows - 1)].to(compute)
            return got * mine[..., None].to(compute)

        def fn(tables, indices):
            gathered = []                            # (table, key, rows)
            for t, (params, bag) in enumerate(zip(tables, bags)):
                emb = bag.emb
                idx = indices[:, t]
                if emb.kind == "qr":
                    ids = dict(zip(("q", "r"), hashing.qr_decompose(idx, emb.collision)))
                elif emb.kind == "tt":
                    ids = dict(zip(("g1", "g2", "g3"), tt_embedding.tt_decompose(idx,
                                                                                 emb.tt_spec)))
                else:
                    ids = {"table": idx}
                big = packed_tables.big_key(emb.kind)
                for key, buf in params.items():
                    if key == big:               # already this rank's row shard
                        lo = shard * buf.shape[0]
                    else:                        # replicated: take this rank's block
                        block = -(-buf.shape[0] // nsh)
                        lo = min(shard * block, buf.shape[0])
                        buf = buf[lo:lo + block]
                    gathered.append((t, key, owned(buf, ids[key], lo, emb.compute_dtype)))
            flat = torch.cat([g.reshape(-1) for _t, _k, g in gathered])
            flat = collectives.psum(flat, mesh, row_axis)
            rows, at = {}, 0
            for t, key, g in gathered:
                rows[t, key] = flat[at:at + g.numel()].view_as(g)
                at += g.numel()
            outs = []
            for t, bag in enumerate(bags):
                emb = bag.emb
                if emb.kind == "qr":
                    pooled = rows[t, "q"].sum(dim=-2) + rows[t, "r"].sum(dim=-2)
                elif emb.kind == "tt":
                    pooled = tt_embedding.contract_rows(rows[t, "g1"], rows[t, "g2"],
                                                        rows[t, "g3"], emb.tt_spec).sum(dim=-2)
                else:
                    pooled = rows[t, "table"].sum(dim=-2)
                if bag.combiner == "mean":
                    pooled = pooled / bag.pooling
                outs.append(pooled)
            return torch.stack(outs, dim=1)

        return fn

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
