"""Intra-GnR locality analysis (port of ``repro.cache.intra_gnr``).

One gather-and-reduce pools ``pooling`` rows per bag, and weight-sharing makes
several of them land in small shared subtables (every QR lookup touches the
R table), so one bag reuses rows heavily.  This module measures that reuse
from a trace, per subtable row:

* ``touches[row]`` — total accesses to the row;
* ``bags[row]``    — number of distinct bags that touch it.

Rows are ranked for prefetch by the accesses a single staging copy saves.
All host-side numpy, as the paper profiles traces offline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import hashing, tt_embedding


@dataclasses.dataclass(frozen=True)
class GnRLocality:
    """Per-row intra-GnR reuse statistics for one subtable."""

    rows: int                   # subtable row count
    touches: np.ndarray         # (rows,) int64: total accesses
    bags: np.ndarray            # (rows,) int64: distinct bags touching the row
    num_bags: int               # bags in the analyzed trace
    row_bytes: int = 0          # bytes per row (0 = unknown)

    @property
    def intra_reuse(self) -> np.ndarray:
        """Mean touches per touching bag, per row (1.0 = no intra-GnR reuse)."""
        return self.touches / np.maximum(self.bags, 1)

    @property
    def mean_intra_reuse(self) -> float:
        """Access-weighted intra-GnR reuse of the whole subtable."""
        total_bags = max(1, int(self.bags.sum()))
        return float(self.touches.sum() / total_bags)

    @property
    def touched_rows(self) -> int:
        return int(np.count_nonzero(self.touches))

    def prefetch_value(self) -> np.ndarray:
        """(rows,) accesses saved if the row is staged once per batch
        (``touches - 1`` for touched rows, 0 for untouched ones)."""
        return np.maximum(self.touches - 1, 0) * (self.touches > 0)


def analyze_bags(trace: np.ndarray, rows: int, *, row_bytes: int = 0) -> GnRLocality:
    """Measure per-row intra-GnR reuse from a (num_bags, pooling) trace."""
    trace = np.asarray(trace)
    if trace.ndim != 2:
        raise ValueError(f"trace must be (num_bags, pooling), got {trace.shape}")
    num_bags = trace.shape[0]
    touches = np.bincount(trace.reshape(-1), minlength=rows)
    # distinct (bag, row) pairs -> per-row bag counts
    if trace.size:
        bag_ids = np.repeat(np.arange(num_bags, dtype=np.int64), trace.shape[1])
        key = bag_ids * rows + trace.reshape(-1).astype(np.int64)
        uniq_rows = (np.unique(key) % rows).astype(np.int64)
        bags = np.bincount(uniq_rows, minlength=rows)
    else:
        bags = np.zeros(rows, dtype=np.int64)
    return GnRLocality(
        rows=rows,
        touches=touches.astype(np.int64),
        bags=bags.astype(np.int64),
        num_bags=num_bags,
        row_bytes=row_bytes,
    )


def subtable_traces(idx: np.ndarray, cfg, *, bytes_per_elem: int = 4) -> dict:
    """Decompose a logical (num_bags, pooling) trace into per-subtable traces:
    ``{name: (trace, rows, row_bytes)}``."""
    idx = np.asarray(idx)
    if cfg.kind == "qr":
        q, r = hashing.qr_decompose(idx, cfg.collision)
        spec = cfg.qr_spec
        rb = cfg.dim * bytes_per_elem
        return {"q": (q, spec.q_rows, rb), "r": (r, spec.r_rows, rb)}
    if cfg.kind == "tt":
        spec = cfg.tt_spec
        i1, i2, i3 = tt_embedding.tt_decompose(idx, spec)
        return {
            "g1": (i1, spec.v1, spec.g1_width * bytes_per_elem),
            "g2": (i2, spec.v2, spec.g2_width * bytes_per_elem),
            "g3": (i3, spec.v3, spec.g3_width * bytes_per_elem),
        }
    if cfg.kind == "hashed":
        rows = cfg.physical_hashed_rows
        hs = hashing.k_ary_hash(idx, rows, cfg.hashed_k)
        return {"table": (hs.reshape(idx.shape[0], -1), rows, cfg.dim * bytes_per_elem)}
    return {"table": (idx, cfg.vocab, cfg.dim * bytes_per_elem)}


def analyze_table(idx: np.ndarray, cfg, *, bytes_per_elem: int = 4) -> dict:
    """Full per-subtable intra-GnR analysis of one table's bag trace."""
    out = {}
    for name, (trace, rows, rb) in subtable_traces(
        idx, cfg, bytes_per_elem=bytes_per_elem
    ).items():
        out[name] = analyze_bags(trace, rows, row_bytes=rb)
    return out


def split_slot_budget(
    values: "list[np.ndarray]", total_slots: int, *, min_slots: int = 1
) -> list[int]:
    """Waterfill a global cache-slot budget across tables by prefetch value.

    Pours slots into whichever table's next marginal row is most valuable
    until the budget is spent.  Every table gets ``min_slots`` (this floor
    takes precedence over the total); no table gets more slots than it has
    rows.  An empty table list, a non-positive ``total_slots`` or a
    non-positive ``min_slots`` raise ``ValueError``.
    """
    num_t = len(values)
    if num_t == 0:
        raise ValueError(
            "split_slot_budget needs at least one table's prefetch values; "
            "an empty table list cannot be budgeted (disable the cache "
            "instead of waterfilling nothing)"
        )
    if total_slots <= 0:
        raise ValueError(
            f"split_slot_budget needs a positive slot budget, got "
            f"total_slots={total_slots}; 0-slot configurations must skip the "
            f"waterfill (spec.cache_slots=0 disables the cache)"
        )
    if min_slots <= 0:
        raise ValueError(f"min_slots must be positive, got {min_slots}")
    caps = [int(v.size) for v in values]
    alloc = [min(min_slots, cap) for cap in caps]
    remaining = total_slots - sum(alloc)
    if remaining <= 0:
        return alloc
    # marginal values beyond the guaranteed base, highest first across tables
    cand_v, cand_t = [], []
    for t, v in enumerate(values):
        sv = np.sort(np.asarray(v, dtype=np.float64))[::-1][alloc[t]: caps[t]]
        cand_v.append(sv)
        cand_t.append(np.full(sv.size, t, dtype=np.int64))
    all_v = np.concatenate(cand_v)
    all_t = np.concatenate(cand_t)
    order = np.argsort(-all_v, kind="stable")[:remaining]
    extra = np.bincount(all_t[order], minlength=num_t)
    return [int(a + e) for a, e in zip(alloc, extra)]


def rank_prefetch(loc: GnRLocality, *, top: int | None = None) -> np.ndarray:
    """Row ids ordered by prefetch value (descending), ties broken stably."""
    value = loc.prefetch_value()
    order = np.argsort(-value, kind="stable")
    n = int(np.count_nonzero(value)) if top is None else top
    return order[:n]
