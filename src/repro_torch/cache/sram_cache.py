"""Software-managed SRAM cache model with next-batch prefetch scheduling.

The paper's bg-PIM SRAM cache is *proactively* filled: the host knows batch
``t+1``'s embedding indices while batch ``t`` executes (inference requests are
queued), so the cache controller stages exactly the rows the next GnR will
touch — no reactive misses, no tag checks on the critical path.  Double
buffering hides the staging DMA behind the executing batch.

Device realization: the "SRAM" is a cache block (a ``(slots, width)``
array) plus a host-side slot map.  Per batch:

1. ``prefetch(next_idx)`` (called while batch ``t`` runs) ranks the next
   batch's rows by in-batch access count × analyzer prefetch value, keeps
   already-resident winners (their staging cost is zero — the paper's
   inter-batch locality), and stages the rest into evicted slots;
2. ``slots_for(idx)`` translates batch ``t``'s accesses through the slot map
   — hits route to the cache block, misses stream from HBM — and records
   hit-rate / staged-row statistics (the modeled traffic).

The model is exact (slot map is ground truth, no approximation), host-side
numpy, and deliberately simple: one slot per row, full associativity,
value-ranked eviction.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CacheStats:
    """Running counters over a serving session."""

    accesses: int = 0
    hits: int = 0
    staged_rows: int = 0        # rows DMA'd into the cache (prefetch traffic)
    kept_rows: int = 0          # next-batch rows already resident (free)
    batches: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)

    @property
    def staged_per_batch(self) -> float:
        return self.staged_rows / max(1, self.batches)

    def traffic_bytes(self, row_bytes: int) -> dict:
        """Modeled DRAM bytes: uncached baseline vs cached (misses + staging)."""
        baseline = self.accesses * row_bytes
        cached = (self.accesses - self.hits + self.staged_rows) * row_bytes
        return {"baseline": baseline, "cached": cached}


class PrefetchScheduler:
    """Double-buffered next-batch prefetcher over one subtable.

    ``num_rows`` — subtable rows; ``num_slots`` — cache capacity in rows;
    ``value`` — optional (num_rows,) static prefetch value from the intra-GnR
    analyzer, used to break ties between rows with equal in-batch counts
    (rows that historically show more intra-GnR reuse win a slot).
    """

    def __init__(self, num_rows: int, num_slots: int, value: np.ndarray | None = None):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.num_rows = num_rows
        self.num_slots = min(num_slots, num_rows)
        self.slot_rows = np.full(self.num_slots, -1, dtype=np.int32)
        self.slot_map = np.full(num_rows, -1, dtype=np.int32)
        if value is not None and value.shape != (num_rows,):
            raise ValueError(f"value must be ({num_rows},), got {value.shape}")
        # normalized to [0, 1): strictly a tiebreak under integer counts
        if value is None:
            self.value = np.zeros(num_rows)
        else:
            v = np.asarray(value, dtype=np.float64)
            self.value = v / (v.max() + 1.0) if v.size else v
        self.stats = CacheStats()

    def prefetch(self, next_idx: np.ndarray) -> int:
        """Stage batch ``t+1``'s most valuable rows; returns rows DMA'd.

        Runs (in hardware: overlapped) during batch ``t``.  Rows are ranked
        by in-batch access count + analyzer tiebreak; the top ``num_slots``
        win residency.  Winners already resident keep their slot — only the
        difference is staged, which is what makes steady-state Zipf traffic
        small (the hot head barely changes between batches).
        """
        flat = np.asarray(next_idx).reshape(-1)
        counts = np.bincount(flat, minlength=self.num_rows)
        want = np.argsort(-(counts + self.value), kind="stable")[: self.num_slots]
        want = want[counts[want] > 0]                  # never stage untouched rows

        resident = set(int(r) for r in self.slot_rows if r >= 0)
        keep = np.array([r for r in want if int(r) in resident], dtype=np.int32)
        stage = np.array([r for r in want if int(r) not in resident], dtype=np.int32)

        # evict non-winners, then fill free slots with the staged rows
        keep_set = set(int(r) for r in keep)
        for s, r in enumerate(self.slot_rows):
            if r >= 0 and int(r) not in keep_set:
                self.slot_map[r] = -1
                self.slot_rows[s] = -1
        free = np.flatnonzero(self.slot_rows < 0)
        for s, r in zip(free, stage):
            self.slot_rows[s] = r
            self.slot_map[r] = s

        self.stats.staged_rows += int(stage.size)
        self.stats.kept_rows += int(keep.size)
        return int(stage.size)

    def slots_for(self, idx: np.ndarray, *, record: bool = True) -> np.ndarray:
        """Slot per access (-1 = miss) for the executing batch; records stats."""
        idx = np.asarray(idx)
        slots = self.slot_map[idx]
        if record:
            self.stats.accesses += int(idx.size)
            self.stats.hits += int((slots >= 0).sum())
            self.stats.batches += 1
        return slots

    def cache_rows(self) -> np.ndarray:
        """(num_slots,) row id per slot, clamped so empty slots gather row 0.

        Feeds the device-side cache-block gather ``table[cache_rows()]`` (the
        staging copy); the slot map never routes an access to an empty slot,
        so the clamp is unobservable.
        """
        return np.maximum(self.slot_rows, 0).astype(np.int32)

