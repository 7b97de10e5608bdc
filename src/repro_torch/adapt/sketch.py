"""Sliding-window frequency sketches for the online re-planner (port of
``repro.adapt.sketch``, numpy, copied verbatim).

The serving loop cannot afford exact per-row counts over a 10^5..10^6-row
vocab, but the re-planner only needs two things: a *ranking* good enough to
re-pin cache slots, and a rough probability vector good enough to re-run the
offline analyzer.  Both tolerate the classic sketch trade-off — bounded
overestimation, never underestimation:

* :class:`CountMinSketch` — count-min with **conservative update** (only the
  minimum-valued counters are raised, batched via ``np.maximum.at``), which
  keeps the one-sided error guarantee while shrinking it substantially on
  skewed (Zipf) streams.  Hashing is multiply-shift over a power-of-two
  width: ``(a * x) >> (64 - log2(w))`` with seeded random odd ``a`` — two
  u64 ops per (row, depth), no Python hashing in the hot path.
* :class:`SpaceSaving` — the top-k heavy-hitter list (Metwally et al.):
  at most ``k`` tracked rows, evict-min on overflow, per-key error bound
  recorded at insertion.  Gives exact membership candidates for pinning
  without scanning the sketch.
* :class:`FrequencySketch` — the per-table facade the serving loop feeds:
  a decaying ring of window sketches (rotate every ``window_batches``
  batches, estimate = decay-weighted sum over live windows) so an expired
  hot set actually *leaves* the estimate instead of haunting it forever,
  plus one decayed heavy-hitter list across windows.

Update cost is O(uniques-in-batch x depth) — O(bag) in the serving loop's
terms — and everything is plain NumPy: sketches live host-side next to the
admission queue, never on the device.
"""

from __future__ import annotations

import numpy as np


def _round_pow2(n: int) -> int:
    return 1 << max(1, int(np.ceil(np.log2(max(2, n)))))


class CountMinSketch:
    """Count-min with conservative update; estimates never undercount."""

    def __init__(self, width: int = 2048, depth: int = 4, seed: int = 0):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.width = _round_pow2(width)
        self.depth = int(depth)
        self._shift = np.uint64(64 - int(np.log2(self.width)))
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC317]))
        # Random odd multipliers: multiply-shift is 2-universal enough for
        # the one-sided CM bound, and stays pure uint64 arithmetic.
        self._mul = (
            rng.integers(1, 2**62, size=self.depth, dtype=np.uint64) << np.uint64(1)
        ) | np.uint64(1)
        self.table = np.zeros((self.depth, self.width), dtype=np.int64)
        self.total = 0

    def _buckets(self, keys: np.ndarray) -> np.ndarray:
        x = np.asarray(keys).astype(np.uint64, copy=False).reshape(-1)
        return ((x[None, :] * self._mul[:, None]) >> self._shift).astype(np.int64)

    def update(self, keys: np.ndarray, counts: np.ndarray | None = None) -> None:
        """Add ``counts`` (default: multiplicity of ``keys``) conservatively.

        Conservative update raises each key's counters only up to
        ``estimate + count``; with duplicate keys folded into per-unique
        counts first, ``np.maximum.at`` applies the whole batch in one shot
        per depth.  Collisions between distinct keys in the same batch can
        only push counters *higher* than the sequential schedule would, so
        the never-underestimate invariant survives batching.
        """
        keys = np.asarray(keys).reshape(-1)
        if counts is None:
            keys, counts = np.unique(keys, return_counts=True)
        else:
            counts = np.asarray(counts).reshape(-1)
        if keys.size == 0:
            return
        idx = self._buckets(keys)
        est = self.table[np.arange(self.depth)[:, None], idx].min(axis=0)
        target = est + counts
        for d in range(self.depth):
            np.maximum.at(self.table[d], idx[d], target)
        self.total += int(counts.sum())

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Point estimates; >= true count, <= true + eps*total w.h.p."""
        keys = np.asarray(keys)
        idx = self._buckets(keys)
        est = self.table[np.arange(self.depth)[:, None], idx].min(axis=0)
        return est.reshape(keys.shape)


class SpaceSaving:
    """Top-k heavy hitters with per-key overestimation bound."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.counts: dict[int, int] = {}
        self.errors: dict[int, int] = {}

    def update(self, keys: np.ndarray, counts: np.ndarray | None = None) -> None:
        keys = np.asarray(keys).reshape(-1)
        if counts is None:
            keys, counts = np.unique(keys, return_counts=True)
        for k, c in zip(keys.tolist(), np.asarray(counts).tolist()):
            if k in self.counts:
                self.counts[k] += c
            elif len(self.counts) < self.capacity:
                self.counts[k] = c
                self.errors[k] = 0
            else:
                victim = min(self.counts, key=self.counts.__getitem__)
                floor = self.counts.pop(victim)
                self.errors.pop(victim)
                self.counts[k] = floor + c
                self.errors[k] = floor

    def scale(self, factor: float) -> None:
        """Decay all counters (window rotation); drops keys that hit zero."""
        for k in list(self.counts):
            self.counts[k] = int(self.counts[k] * factor)
            self.errors[k] = int(self.errors[k] * factor)
            if self.counts[k] <= 0:
                del self.counts[k]
                del self.errors[k]

    def top(self, n: int | None = None) -> list[tuple[int, int]]:
        """[(key, count)] sorted by count desc, key asc for determinism."""
        items = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return items if n is None else items[:n]


class FrequencySketch:
    """Per-table sliding-window sketch: ring of count-min windows + decayed
    heavy hitters.  This is the object the serving loop feeds each batch.

    ``windows`` live windows of ``window_batches`` batches each; when the
    active window fills, the ring rotates and the oldest window is zeroed.
    Estimates are ``sum_i decay**age_i * window_i`` — recent traffic
    dominates, and a hot set older than ``windows * window_batches`` batches
    contributes nothing at all.
    """

    def __init__(
        self,
        num_rows: int,
        *,
        width: int | None = None,
        depth: int = 4,
        windows: int = 4,
        window_batches: int = 16,
        decay: float = 0.5,
        topk: int = 256,
        seed: int = 0,
    ):
        if windows < 1:
            raise ValueError(f"windows must be >= 1, got {windows}")
        self.num_rows = int(num_rows)
        self.windows = int(windows)
        self.window_batches = int(window_batches)
        self.decay = float(decay)
        # Default width tracks the key space (collision inflation corrupts
        # mid-rank ordering once keys outnumber cells severalfold), capped
        # at 64Ki cells / window; always capped at the next pow2 >= num_rows
        # — a sketch wider than the key space is pure waste.
        if width is None:
            width = min(_round_pow2(num_rows), 65_536)
        width = min(_round_pow2(width), _round_pow2(num_rows))
        self._ring = [
            CountMinSketch(width, depth, seed=seed * 1000 + i)
            for i in range(self.windows)
        ]
        self._active = 0
        self.heavy = SpaceSaving(topk)
        self.batches = 0
        self._batches_in_window = 0

    def update(self, keys: np.ndarray) -> None:
        """Fold one batch of row ids in; O(uniques x depth)."""
        uniq, counts = np.unique(np.asarray(keys).reshape(-1), return_counts=True)
        self._ring[self._active].update(uniq, counts)
        self.heavy.update(uniq, counts)
        self.batches += 1
        self._batches_in_window += 1
        if self._batches_in_window >= self.window_batches:
            self.advance()

    def advance(self) -> None:
        """Rotate the window ring: oldest window forgotten, heavy decayed."""
        self._active = (self._active + 1) % self.windows
        sk = self._ring[self._active]
        sk.table[:] = 0
        sk.total = 0
        self.heavy.scale(self.decay)
        self._batches_in_window = 0

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        """Decay-weighted estimate across live windows (float64)."""
        keys = np.asarray(keys)
        out = np.zeros(keys.shape, dtype=np.float64)
        for age in range(self.windows):
            sk = self._ring[(self._active - age) % self.windows]
            if sk.total == 0:
                continue
            out += (self.decay**age) * sk.estimate(keys)
        return out

    def estimate_all(self) -> np.ndarray:
        """Estimates for every row id in ``[0, num_rows)``."""
        return self.estimate(np.arange(self.num_rows))

    @property
    def total(self) -> float:
        """Decay-weighted stream mass (same weighting as ``estimate``)."""
        return sum(
            (self.decay**age) * self._ring[(self._active - age) % self.windows].total
            for age in range(self.windows)
        )

    def top_rows(self, n: int) -> np.ndarray:
        """Heavy-hitter candidates, best-first; may return fewer than n."""
        keys = [k for k, _ in self.heavy.top(n)]
        return np.asarray(keys, dtype=np.int64)
