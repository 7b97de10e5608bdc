"""ProactivePIM cache subsystem of the port: the intra-GnR locality analyzer,
the next-batch prefetch scheduler and the duplication planner (host numpy,
copied from ``repro.cache``)."""

from repro_torch.cache.duplication import (             # noqa: F401
    DuplicationPlan, SubtableDecision, TableDupPlan, plan_duplication,
)
from repro_torch.cache.intra_gnr import (               # noqa: F401
    GnRLocality, analyze_bags, analyze_table, rank_prefetch, subtable_traces,
)
from repro_torch.cache.sram_cache import (              # noqa: F401
    CacheStats, PrefetchScheduler,
)
