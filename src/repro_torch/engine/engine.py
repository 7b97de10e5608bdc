"""compile() — turn an EmbeddingPlan into an executable EmbeddingEngine
(port of ``repro.engine.engine``, the serving subset).

``serve_gather`` is the batched serving path: the prefetch scheduler's slot
maps route each access into the packed cache block, and the whole batch's
embedding layer is ONE kernel launch (``ops.packed_multi_pooled``).  PyTorch
runs eagerly, so the port has no counterpart of ``repro``'s plan-keyed jit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import packed_tables
from repro_torch.engine.plan import EmbeddingPlan
from repro_torch.kernels import ops


class EmbeddingEngine:
    """Executable embedding layer compiled from an ``EmbeddingPlan``."""

    def __init__(self, plan: EmbeddingPlan):
        self.plan = plan
        self.spec = plan.spec
        self.bags = list(plan.spec.bags)

    def _layout(self, what: str) -> packed_tables.PackedLayout:
        if not self.plan.packed:
            raise ValueError(f"plan is not packed; {what}")
        return self.plan.layout

    def pack(self, tables: Sequence[dict]) -> dict:
        """Concatenate per-table params into the packed kernel buffers."""
        return packed_tables.pack_params(tables, self._layout("no packed buffers to build"))

    def serve_gather(self, packed: dict, idx: torch.Tensor, slot: torch.Tensor,
                     cache_rows: torch.Tensor) -> torch.Tensor:
        """One kernel launch for a whole batch's embedding layer.

        ``packed`` from :meth:`pack`; ``idx`` (B, T, K) logical indices;
        ``slot`` (B, T, K) per-table scheduler slots (-1 = miss);
        ``cache_rows`` the packed cache block's global rows
        (:meth:`packed_cache_rows`).  Returns (B, T, dim).
        """
        layout = self._layout("serve_gather needs a layout")
        streams = packed_tables.pack_indices(idx, layout)
        streams["slot"] = packed_tables.global_slots(slot, layout)
        # the cache-block gather is the staging copy of the prefetched rows
        cache = packed[packed_tables.big_key(layout.kind)][cache_rows.long()]
        pooled = ops.packed_multi_pooled(
            {**packed, "cache": cache}, streams,
            kind=layout.kind, dims=layout.tt_dims,
        )
        scale = packed_tables.combiner_scale(self.bags, torch.float32, pooled.device)
        return pooled * scale[None, :, None].to(pooled.dtype)

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
