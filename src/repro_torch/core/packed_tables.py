"""Packed-table layout: one buffer, one index stream, one kernel launch
(port of ``repro.core.packed_tables``, dense, QR and TT kinds).

* ``PackedLayout`` — static description of all same-width subtables
  concatenated row-major: per-table row offsets of the big subtables (dense
  table / QR Q / TT middle core G2), of the QR R LUTs, and of the per-table
  cache-slot ranges; TT outer cores are packed at ``t * v1`` / ``t * v3``;
* ``pack_params`` — the device-side concatenation, plus one trailing all-zero
  row per streamed buffer: accesses that must contribute nothing (ragged bag
  tails) are routed to the zero row instead of masked (a zero G2 row nulls a
  TT product, so the outer cores get no zero row);
* ``pack_indices`` — logical (B, T, K) bag indices -> globally offset int32
  streams, vectorized over all tables;
* slot-map helpers translating each table's scheduler state into the packed
  cache block's coordinates;
* ``packed_multi_bag_lookup`` — every table's pooled bag in one launch,
  differentiable in the tables (the kernels' chunked plain-version
  recompute, ``kernels/ops.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import hashing, qr_embedding, tt_embedding
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.kernels import ops


def _cumsum(sizes: Sequence[int]) -> tuple[int, ...]:
    off, acc = [], 0
    for s in sizes:
        off.append(acc)
        acc += int(s)
    return tuple(off)


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """Static shape/offset description of one packed multi-table family."""

    kind: str                                   # dense | qr | tt
    num_tables: int
    dim: int                                    # pooled output width
    rows_per_table: tuple[int, ...]             # big-subtable physical rows
    small_rows_per_table: tuple[int, ...] = ()  # QR R rows (empty otherwise)
    slot_budgets: tuple[int, ...] = ()          # cache slots per table
    collision: int = 0                          # QR hash collision value
    tt_dims: tuple[int, int, int, int] | None = None    # (d1, d2, d3, rank)
    tt_vocab: tuple[int, int, int] | None = None        # (v1, v2, v3)

    # -- big (streamed) buffer ------------------------------------------------
    @property
    def row_offsets(self) -> tuple[int, ...]:
        return _cumsum(self.rows_per_table)

    @property
    def total_rows(self) -> int:
        return sum(self.rows_per_table)

    @property
    def zero_row(self) -> int:
        """Index of the appended all-zero row (ragged/masked accesses)."""
        return self.total_rows

    @property
    def big_width(self) -> int:
        """Row width of the streamed buffer (G2 is wider than dim for TT)."""
        if self.kind == "tt":
            d1, d2, d3, rank = self.tt_dims
            return rank * d2 * rank
        return self.dim

    # -- small shared buffer (QR R LUTs) -------------------------------------
    @property
    def small_offsets(self) -> tuple[int, ...]:
        return _cumsum(self.small_rows_per_table)

    @property
    def total_small(self) -> int:
        return sum(self.small_rows_per_table)

    @property
    def small_zero_row(self) -> int:
        return self.total_small

    # -- packed cache block ---------------------------------------------------
    @property
    def slot_offsets(self) -> tuple[int, ...]:
        return _cumsum(self.slot_budgets)

    @property
    def total_slots(self) -> int:
        return sum(self.slot_budgets)


# ---------------------------------------------------------------------------
# layout construction
# ---------------------------------------------------------------------------

def packable(bags: Sequence[BagConfig]) -> bool:
    """True when every bag can ride one packed launch: uniform kind (dense /
    additive QR / TT), row width, vocab and decomposition constants across
    tables."""
    if not bags:
        return False
    e0 = bags[0].emb
    if e0.kind not in ("dense", "qr", "tt"):
        return False
    if e0.kind == "qr" and e0.reconstruction != "add":
        return False
    for b in bags:
        e = b.emb
        if e.kind != e0.kind or e.dim != e0.dim or e.vocab != e0.vocab:
            return False
        if e.kind == "qr" and e.collision != e0.collision:
            return False
        if e.kind == "tt" and (
            e.tt_spec.vocab_factors != e0.tt_spec.vocab_factors
            or e.tt_spec.dim_factors != e0.tt_spec.dim_factors
            or e.tt_spec.rank != e0.tt_spec.rank
        ):
            return False
    return True


def build_layout(
    bags: Sequence[BagConfig], slot_budgets: Sequence[int] | None = None
) -> PackedLayout:
    if not packable(bags):
        raise ValueError("bags are not uniform enough to pack")
    e0 = bags[0].emb
    budgets = tuple(int(s) for s in (slot_budgets or [0] * len(bags)))
    if len(budgets) != len(bags):
        raise ValueError(f"{len(budgets)} slot budgets for {len(bags)} bags")
    if e0.kind == "qr":
        return PackedLayout(
            kind="qr",
            num_tables=len(bags),
            dim=e0.dim,
            rows_per_table=tuple(
                qr_embedding._pad_rows(b.emb.qr_spec.q_rows) for b in bags
            ),
            small_rows_per_table=tuple(b.emb.qr_spec.r_rows for b in bags),
            slot_budgets=budgets,
            collision=e0.collision,
        )
    if e0.kind == "tt":
        spec = e0.tt_spec
        return PackedLayout(
            kind="tt",
            num_tables=len(bags),
            dim=e0.dim,
            rows_per_table=tuple(b.emb.tt_spec.g2_rows_padded for b in bags),
            slot_budgets=budgets,
            tt_dims=spec.dims,
            tt_vocab=spec.vocab_factors,
        )
    return PackedLayout(
        kind="dense",
        num_tables=len(bags),
        dim=e0.dim,
        rows_per_table=tuple(qr_embedding._pad_rows(b.emb.vocab) for b in bags),
        slot_budgets=budgets,
    )


@functools.lru_cache(maxsize=64)
def _layout_for(bags: tuple) -> PackedLayout:
    return build_layout(list(bags))


def layout_for(bags: Sequence[BagConfig]) -> PackedLayout:
    """Cached layout lookup (BagConfig is frozen and hashable)."""
    return _layout_for(tuple(bags))


# ---------------------------------------------------------------------------
# device-side packing
# ---------------------------------------------------------------------------

def big_key(kind: str) -> str:
    """Param-dict key of the streamed big subtable for an embedding kind."""
    return {"qr": "q", "tt": "g2"}.get(kind, "table")


def combiner_scale(bags: Sequence[BagConfig], dtype, device) -> torch.Tensor:
    """(T,) per-table post-pool scale implementing the bag combiners."""
    return torch.tensor(
        [1.0 / b.pooling if b.combiner == "mean" else 1.0 for b in bags],
        dtype=dtype, device=device,
    )


def concat_with_zero(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-concatenate buffers and append one all-zero row (the routing sink
    for accesses that must contribute nothing)."""
    p0 = parts[0]
    zero = torch.zeros((1, p0.shape[1]), dtype=p0.dtype, device=p0.device)
    return torch.cat([*parts, zero], dim=0)


def pack_params(tables: Sequence[dict], layout: PackedLayout, *, dtype=None) -> dict:
    """Concatenate per-table params into the packed buffers, in ``dtype``
    (default: the param dtype; serving packs fp32, ``lookup`` the compute
    dtype).  Streamed buffers (big table, QR R, TT G2) get a trailing zero
    row; the TT outer cores are packed without one."""
    cast = lambda key: [t[key] if dtype is None else t[key].to(dtype) for t in tables]
    if layout.kind == "qr":
        q = concat_with_zero(cast("q"))
        r = concat_with_zero(cast("r"))
        if q.shape[0] != layout.total_rows + 1 or r.shape[0] != layout.total_small + 1:
            raise ValueError(f"packed shapes {tuple(q.shape)}, {tuple(r.shape)} "
                             f"do not match the layout {layout}")
        return {"q": q, "r": r}
    if layout.kind == "tt":
        g2 = concat_with_zero(cast("g2"))
        g1 = torch.cat(cast("g1"), dim=0)
        g3 = torch.cat(cast("g3"), dim=0)
        if g2.shape[0] != layout.total_rows + 1:
            raise ValueError(f"packed G2 shape {tuple(g2.shape)} does not match "
                             f"the layout {layout}")
        return {"g1": g1, "g2": g2, "g3": g3}
    table = concat_with_zero(cast("table"))
    if table.shape[0] != layout.total_rows + 1:
        raise ValueError(f"packed shape {tuple(table.shape)} does not match "
                         f"the layout {layout}")
    return {"table": table}


# ---------------------------------------------------------------------------
# index-stream packing (vectorized over all tables)
# ---------------------------------------------------------------------------

def _offsets(values: Sequence[int], like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=like.device)[None, :, None]


def _valid_mask(idx: torch.Tensor, lengths: torch.Tensor | None):
    if lengths is None:
        return None
    k = idx.shape[-1]
    pos = torch.arange(k, dtype=torch.int32, device=idx.device)[None, None, :]
    return pos < lengths.to(device=idx.device)[..., None]


def pack_indices(
    idx: torch.Tensor, layout: PackedLayout, *, lengths: torch.Tensor | None = None
) -> dict:
    """Logical (B, T, K) bag indices -> globally offset packed streams.

    ``lengths`` (B, T) optionally marks ragged bags: positions ``k >=
    lengths[b, t]`` are routed to the zero rows and contribute nothing —
    empty bags (length 0) pool to exactly zero.
    """
    idx = idx.to(torch.int32)
    if idx.shape[-2] != layout.num_tables:
        raise ValueError(f"indices {tuple(idx.shape)} vs {layout.num_tables} tables")
    off = _offsets(layout.row_offsets, idx)
    mask = _valid_mask(idx, lengths)

    if layout.kind == "qr":
        q_idx, r_idx = hashing.qr_decompose(idx, layout.collision)
        q_g = q_idx + off
        r_g = r_idx + _offsets(layout.small_offsets, idx)
        if mask is not None:
            q_g = torch.where(mask, q_g, layout.zero_row)
            r_g = torch.where(mask, r_g, layout.small_zero_row)
        return {"q_idx": q_g.to(torch.int32), "r_idx": r_g.to(torch.int32)}
    if layout.kind == "tt":
        v1, v2, v3 = layout.tt_vocab
        i1, i2, i3 = tt_embedding.tt_decompose_factors(idx, v2, v3)
        t_ids = torch.arange(layout.num_tables, dtype=torch.int32,
                             device=idx.device)[None, :, None]
        i1_g = i1 + t_ids * v1
        i3_g = i3 + t_ids * v3
        i2_g = i2 + off
        if mask is not None:
            # the zero G2 row nulls the product; i1/i3 stay valid rows
            i2_g = torch.where(mask, i2_g, layout.zero_row)
        return {"i1": i1_g.to(torch.int32), "i2": i2_g.to(torch.int32),
                "i3": i3_g.to(torch.int32)}
    g = idx + off
    if mask is not None:
        g = torch.where(mask, g, layout.zero_row)
    return {"idx": g.to(torch.int32)}


def global_slots(slot: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """Per-table local cache slots (B, T, K), -1 = miss -> packed-block slots."""
    slot = slot.to(torch.int32)
    off = _offsets(layout.slot_offsets, slot)
    return torch.where(slot >= 0, slot + off, -1).to(torch.int32)


def miss_slots(idx: torch.Tensor) -> torch.Tensor:
    """All-miss slot map (the no-cache configuration)."""
    return torch.full(idx.shape, -1, dtype=torch.int32, device=idx.device)


def packed_cache_rows(
    cache_rows: Sequence[np.ndarray], layout: PackedLayout
) -> np.ndarray:
    """Per-table scheduler ``cache_rows()`` -> global packed-buffer rows.

    The packed cache block is ``big[packed_cache_rows(...)]`` — one gather is
    the whole staging copy for every table's slots.
    """
    parts = []
    for t, rows in enumerate(cache_rows):
        if rows.shape != (layout.slot_budgets[t],):
            raise ValueError(f"table {t}: cache rows {rows.shape} vs "
                             f"{layout.slot_budgets[t]} slots")
        parts.append(np.asarray(rows, np.int64) + layout.row_offsets[t])
    total = np.concatenate(parts) if parts else np.empty((0,), np.int64)
    return total.astype(np.int32)


def dummy_cache(layout: PackedLayout, dtype, device) -> torch.Tensor:
    """1-row zero cache block for cache-less calls (slot map all -1)."""
    return torch.zeros((1, layout.big_width), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# single-card multi-table GnR (the model-forward entry point)
# ---------------------------------------------------------------------------

def packed_multi_bag_lookup(tables: Sequence[dict], indices: torch.Tensor,
                            bags: Sequence[BagConfig], *,
                            lengths: torch.Tensor | None = None) -> torch.Tensor:
    """All-tables GnR in one packed launch: ``indices`` (B, T, K) -> (B, T,
    dim) in the compute dtype.

    Drop-in for ``embedding_bag.multi_bag_lookup`` on packable bag sets:
    the tables are packed in the compute dtype (bf16: the bf16 entry points
    of K1 / K3 / K2), with a 1-row zero cache and all-miss slots.
    ``lengths`` (B, T) marks ragged bags: positions past a bag's length
    contribute nothing, and a mean combiner divides by the valid length.
    Gradients reach the per-table params through the packing (the training
    entry, as in ``repro``).
    """
    layout = layout_for(bags)
    emb = bags[0].emb
    packed = pack_params(tables, layout, dtype=emb.compute_dtype)
    streams = pack_indices(indices, layout, lengths=lengths)
    streams["slot"] = miss_slots(indices)
    device = indices.device
    packed["cache"] = dummy_cache(layout, emb.compute_dtype, device)
    pooled = ops.packed_multi_pooled(packed, streams, kind=layout.kind, dims=layout.tt_dims)
    if lengths is None:
        pooled = pooled * combiner_scale(bags, pooled.dtype, device)[None, :, None]
    else:
        # mean combiners divide by the valid bag length, not the padded K
        mean_t = torch.tensor([b.combiner == "mean" for b in bags], device=device)
        valid = lengths.to(device).clamp(min=1).to(pooled.dtype)
        denom = torch.where(mean_t[None, :], valid, torch.ones_like(valid))
        pooled = pooled / denom[..., None]
    return pooled.to(emb.compute_dtype)
