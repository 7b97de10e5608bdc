"""Incremental re-planning: new cache residency, same engine and kernels
(port of ``repro.adapt.replan``).

The static half of the serving dispatch is the ``EmbeddingPlan`` — ``spec``,
``backend``, ``layout``, ``slot_budgets``, ``knobs`` (``repro`` keys its jit
on it; the port builds its engine and packed buffers from it).  Everything
else the cache machinery feeds the kernel is a *runtime argument*: the
per-table slot maps and the ``cache_rows`` gather indices.  This module
recomputes exactly that runtime half from a live frequency sketch:

* :class:`PinnedCache` — static-residency counterpart of
  :class:`repro_torch.cache.sram_cache.PrefetchScheduler` (same duck type:
  ``prefetch`` / ``slots_for`` / ``cache_rows`` / ``.stats``), holding the
  *planner-predicted* hot rows resident with **no per-batch staging copy**.
  The oracle prefetcher re-ranks from the next batch's actual indices and
  so self-heals under drift; the pinned mode is the steady-state serving
  configuration whose hit rate genuinely decays when traffic moves — the
  thing online adaptation exists to fix.  ``pin()`` swaps the resident set
  in place; the arrays keep their shapes (``(slot_budgets[t],)`` per table),
  so ``packed_cache_rows`` and the packed launch see only new *contents*.
* :func:`incremental_update` — sketch estimates -> new pinned row set +
  refreshed scheduler tiebreak values per table, applied via
  :meth:`IncrementalUpdate.apply` to either cache flavor.
* :func:`sampled_traces` / :func:`replan_full` — the expensive path: turn
  the sketch into a synthetic logical-index trace and re-run the whole
  offline ``plan()`` (analyzer, waterfill, duplication, packing).  The
  result is a *new* plan — a new engine and packed buffers — reserved for
  when the policy decides the distribution moved enough to re-derive
  structure, not just residency.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cache.sram_cache import CacheStats
from repro_torch.engine.plan import big_rows as _big_rows
from repro_torch.engine.plan import big_subtable as _big_subtable
from repro_torch.engine.plan import plan as _offline_plan


def top_rows(est: np.ndarray, n: int) -> np.ndarray:
    """The ``n`` highest-estimate rows, deterministically (stable, id-asc ties)."""
    est = np.asarray(est)
    n = min(int(n), est.size)
    return np.argsort(-est, kind="stable")[:n].astype(np.int64)


class PinnedCache:
    """Statically pinned cache residency over one subtable.

    Drop-in for ``PrefetchScheduler`` in the serving loop: ``prefetch`` is a
    no-op (nothing staged per batch — residency only changes when ``pin``
    swaps it), ``slots_for`` routes through the same slot-map representation,
    and ``cache_rows`` keeps shape ``(num_slots,)`` forever so swapped
    contents reuse the same engine and packed buffers.
    """

    def __init__(
        self, num_rows: int, num_slots: int, rows: np.ndarray | None = None
    ):
        if num_slots <= 0:
            raise ValueError("num_slots must be positive")
        self.num_rows = int(num_rows)
        self.num_slots = min(int(num_slots), self.num_rows)
        self.slot_rows = np.full(self.num_slots, -1, dtype=np.int32)
        self.slot_map = np.full(self.num_rows, -1, dtype=np.int32)
        self.stats = CacheStats()
        self.swaps = 0
        if rows is not None:
            self.pin(rows)

    def pin(self, rows: np.ndarray) -> int:
        """Swap the resident row set; returns rows newly staged.

        Rows already resident keep their slot (their re-pin is free, exactly
        the prefetcher's inter-batch keep rule); only the difference is
        staged.  Duplicates are dropped, overflow beyond ``num_slots`` is
        truncated best-first.
        """
        rows = np.asarray(rows).reshape(-1)
        _, first = np.unique(rows, return_index=True)
        rows = rows[np.sort(first)][: self.num_slots]

        keep_set = set(int(r) for r in rows) & set(
            int(r) for r in self.slot_rows if r >= 0
        )
        for s, r in enumerate(self.slot_rows):
            if r >= 0 and int(r) not in keep_set:
                self.slot_map[r] = -1
                self.slot_rows[s] = -1
        stage = np.array([r for r in rows if int(r) not in keep_set], dtype=np.int32)
        free = np.flatnonzero(self.slot_rows < 0)
        for s, r in zip(free, stage):
            self.slot_rows[s] = r
            self.slot_map[r] = s

        self.stats.staged_rows += int(stage.size)
        self.stats.kept_rows += len(keep_set)
        self.swaps += 1
        return int(stage.size)

    def pinned_rows(self) -> np.ndarray:
        """Currently resident row ids (unordered, no sentinel)."""
        return self.slot_rows[self.slot_rows >= 0].astype(np.int64)

    def prefetch(self, next_idx: np.ndarray) -> int:
        """Static residency: per-batch prefetch stages nothing."""
        return 0

    def slots_for(self, idx: np.ndarray, *, record: bool = True) -> np.ndarray:
        idx = np.asarray(idx)
        slots = self.slot_map[idx]
        if record:
            self.stats.accesses += int(idx.size)
            self.stats.hits += int((slots >= 0).sum())
            self.stats.batches += 1
        return slots

    def cache_rows(self) -> np.ndarray:
        return np.maximum(self.slot_rows, 0).astype(np.int32)


def pinned_from_plan(eplan) -> list[PinnedCache]:
    """One :class:`PinnedCache` per table, pinned to the offline plan's bet.

    The initial resident set is the plan's profiled popularity (logical-id
    trace counts folded onto big-subtable rows) — what ``plan()`` itself
    predicts is hot — falling back to the analyzer's prefetch values for
    trace-less plans.  A frozen pinned engine is exactly what the offline
    pass would deploy with no online information.
    """
    if not eplan.has_cache:
        raise ValueError("plan has no cache slots; set spec.cache_slots")
    caches = []
    for t, bag in enumerate(eplan.bags):
        _name, rows = _big_subtable(bag.emb)
        if getattr(eplan, "counts", ()):
            hot = fold_to_big(
                np.asarray(eplan.counts[t], dtype=np.float64),
                big_id_map(bag.emb), rows,
            )
        elif eplan.values:
            hot = np.asarray(eplan.values[t], dtype=np.float64)
        else:
            hot = np.arange(rows, 0, -1, dtype=np.float64)
        caches.append(
            PinnedCache(rows, eplan.slot_budgets[t], top_rows(hot, eplan.slot_budgets[t]))
        )
    return caches


def big_id_map(emb) -> np.ndarray:
    """(vocab, m) big-subtable row(s) touched by each logical id.

    ``m`` is 1 for dense/qr/tt and ``hashed_k`` for hashed tables; the map is
    how sketches over *logical* ids (what the serving loop sees) fold onto
    *big-subtable* rows (what the cache pins).
    """
    ids = np.arange(emb.vocab, dtype=np.int64)[:, None]
    big = np.asarray(_big_rows(ids, emb))
    return big.reshape(emb.vocab, -1)


def fold_to_big(est: np.ndarray, big_ids: np.ndarray, num_rows: int) -> np.ndarray:
    """Fold per-logical-id estimates onto big-subtable rows (sums mass)."""
    est = np.asarray(est, dtype=np.float64).reshape(-1)
    m = big_ids.shape[1]
    return np.bincount(
        big_ids.reshape(-1), weights=np.repeat(est, m), minlength=num_rows
    )[:num_rows]


def coverage(est: np.ndarray, rows: np.ndarray) -> float:
    """Predicted hit rate of pinning ``rows`` under the estimate vector."""
    est = np.asarray(est, dtype=np.float64)
    total = est.sum()
    if total <= 0:
        return 0.0
    return float(est[np.asarray(rows, dtype=np.int64)].sum() / total)


@dataclasses.dataclass
class IncrementalUpdate:
    """New runtime-arg state for every table: pinned rows + tiebreak values."""

    rows: list[np.ndarray]
    values: list[np.ndarray]
    predicted_hit: float = 0.0

    def apply(self, caches) -> int:
        """Swap into live caches; returns total rows staged.

        ``PinnedCache`` gets the new resident set; a ``PrefetchScheduler``
        (oracle arm) gets its analyzer tiebreak refreshed in place — both are
        pure runtime-arg mutations, shapes untouched.
        """
        staged = 0
        for cache, rows, value in zip(caches, self.rows, self.values):
            if hasattr(cache, "pin"):
                staged += cache.pin(rows)
            else:
                v = np.asarray(value, dtype=np.float64)
                cache.value = v / (v.max() + 1.0) if v.size else v
        return staged


def incremental_update(
    estimates: list[np.ndarray], slot_budgets: tuple[int, ...]
) -> IncrementalUpdate:
    """Sketch estimates (per big-subtable row) -> the cheap re-plan.

    Pure ranking: top ``slot_budgets[t]`` rows per table win residency, the
    raw estimates become the schedulers' tiebreak values.  ``predicted_hit``
    is the access-weighted coverage of the new pin across tables — the
    policy's gain numerator.
    """
    rows, values, hit_mass, mass = [], [], 0.0, 0.0
    for est, budget in zip(estimates, slot_budgets):
        est = np.asarray(est, dtype=np.float64)
        r = top_rows(est, budget)
        rows.append(r)
        values.append(est)
        hit_mass += float(est[r].sum())
        mass += float(est.sum())
    return IncrementalUpdate(
        rows=rows, values=values,
        predicted_hit=hit_mass / mass if mass > 0 else 0.0,
    )


def sampled_traces(
    sketches, *, n: int = 20_000, seed: int = 0
) -> list[np.ndarray]:
    """Synthesize one logical-index trace per table from the sketches.

    The sketch's full estimate vector, normalized, is a probability model of
    live traffic; sampling it gives ``plan()`` the same shaped input the
    offline Zipf profiler provides — the bridge from online observation back
    to the full analyzer/waterfill/duplication pass.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xF0117]))
    traces = []
    for sk in sketches:
        est = sk.estimate_all()
        total = est.sum()
        if total <= 0:
            traces.append(rng.integers(0, sk.num_rows, size=n, dtype=np.int64))
            continue
        traces.append(rng.choice(sk.num_rows, size=n, p=est / total))
    return traces


def replan_full(
    spec, sketches, *, num_shards: int = 1, knobs=None, tuner=None,
    n: int = 20_000, seed: int = 0
):
    """The expensive path: full offline ``plan()`` on sketch-sampled traffic.

    Returns a fresh ``EmbeddingPlan``; the caller owns compiling and
    swapping the engine.  Reserved for
    policy-approved structural re-plans (duplication/packing/budgets), not
    the per-rotation residency swap.
    """
    traces = sampled_traces(sketches, n=n, seed=seed)
    return _offline_plan(
        spec, trace=traces, num_shards=num_shards, knobs=knobs, tuner=tuner
    )
