"""Per-batch traffic accounting: the paper's Fig-style "memory access
reduction" as a first-class reported metric (port of ``repro.obs.traffic``).

ProactivePIM's wins are traffic claims — fewer HBM row fetches (the proactive
SRAM cache), zero CPU<->PIM transfer for comm-free duplicated tables — so the
serving loop should report *bytes*, not just a scalar hit rate.  This module
turns the execution state the pipeline already carries into one JSON-ready
report:

* cache hits / misses / staged rows come from each ``PrefetchScheduler``'s
  exact :class:`~repro_torch.cache.sram_cache.CacheStats` (the slot map is ground
  truth, so these are counts, not estimates);
* modeled HBM bytes price those counts at the big-subtable row width — the
  uncached baseline streams every access, the cached path streams misses plus
  the staging DMA;
* comm bytes come from the duplication plan's cross-shard combine model
  (``DuplicationPlan.ici_bytes_per_batch``): comm-free tables skip the
  cross-shard psum entirely.

Consistency is tested, not assumed: the totals here must equal the
schedulers' ``CacheStats``, and the serving run's report must equal
``repro``'s on the same batches (``tests/test_torch_obs*.py``).
"""

from __future__ import annotations

import dataclasses

from repro_torch.cache.sram_cache import CacheStats


def big_row_bytes(emb, *, bytes_per_elem: int = 4) -> int:
    """Bytes per row of the streamed/cached big subtable (matches
    ``intra_gnr.subtable_traces``: G2 width for TT, dim otherwise)."""
    if emb.kind == "tt":
        return emb.tt_spec.g2_width * bytes_per_elem
    return emb.dim * bytes_per_elem


def cache_traffic(stats: CacheStats, row_bytes: int) -> dict:
    """One subtable's cache counters priced in modeled DRAM bytes."""
    tb = stats.traffic_bytes(row_bytes)
    baseline, cached = tb["baseline"], tb["cached"]
    return {
        "accesses": int(stats.accesses),
        "hits": int(stats.hits),
        "misses": int(stats.accesses - stats.hits),
        "hit_rate": stats.hit_rate,
        "staged_rows": int(stats.staged_rows),
        "kept_rows": int(stats.kept_rows),
        "row_bytes": int(row_bytes),
        "hbm_baseline_bytes": int(baseline),
        "hbm_cached_bytes": int(cached),
        "hbm_reduction": cached / baseline if baseline else 1.0,
    }


def format_cache_traffic(t: dict) -> str:
    """The benchmark-row column form shared by cache_sim and serve_qps."""
    return (
        f"hit={t['hit_rate']:.3f} staged={t['staged_rows']} "
        f"dram={t['hbm_cached_bytes']}B vs baseline={t['hbm_baseline_bytes']}B "
        f"({t['hbm_reduction']:.2f}x)"
    )


@dataclasses.dataclass
class TrafficReport:
    """Aggregated per-session traffic accounting across all tables."""

    tables: list                        # per-table cache_traffic dicts
    batches: int                        # scheduler-observed batches (max)
    comm: dict | None = None            # per-batch combine bytes (dup plan model)

    @property
    def accesses(self) -> int:
        return sum(t["accesses"] for t in self.tables)

    @property
    def hits(self) -> int:
        return sum(t["hits"] for t in self.tables)

    @property
    def staged_rows(self) -> int:
        return sum(t["staged_rows"] for t in self.tables)

    @property
    def hit_rate(self) -> float:
        return self.hits / max(1, self.accesses)

    @property
    def hbm_baseline_bytes(self) -> int:
        return sum(t["hbm_baseline_bytes"] for t in self.tables)

    @property
    def hbm_cached_bytes(self) -> int:
        return sum(t["hbm_cached_bytes"] for t in self.tables)

    @property
    def hbm_reduction(self) -> float:
        base = self.hbm_baseline_bytes
        return self.hbm_cached_bytes / base if base else 1.0

    def describe(self) -> dict:
        out = {
            "accesses": self.accesses,
            "hits": self.hits,
            "hit_rate": self.hit_rate,
            "staged_rows": self.staged_rows,
            "batches": self.batches,
            "hbm_baseline_bytes": self.hbm_baseline_bytes,
            "hbm_cached_bytes": self.hbm_cached_bytes,
            "hbm_reduction": self.hbm_reduction,
            "per_table": list(self.tables),
        }
        if self.comm is not None:
            out["comm_baseline_bytes_per_batch"] = float(self.comm["baseline"])
            out["comm_bytes_per_batch"] = float(self.comm["duplicated"])
            out["comm_saved_bytes_per_batch"] = float(self.comm["saved"])
        return out


def collect(plan, schedulers, *, batch: int) -> TrafficReport:
    """Build the report from an ``EmbeddingPlan`` + its live schedulers.

    ``plan`` is ``repro_torch.engine.EmbeddingPlan``; ``schedulers`` the per-table
    ``PrefetchScheduler`` list a serving session ran (their ``CacheStats``
    are the exact hit/miss/staging counts); ``batch`` sizes the modeled
    per-batch comm bytes.
    """
    tables = [
        cache_traffic(s.stats, big_row_bytes(bag.emb))
        for s, bag in zip(schedulers, plan.bags)
    ]
    comm = None
    if plan.dup is not None:
        comm = plan.dup.ici_bytes_per_batch(batch, plan.bags[0].emb.dim)
    batches = max((s.stats.batches for s in schedulers), default=0)
    return TrafficReport(tables=tables, batches=batches, comm=comm)
