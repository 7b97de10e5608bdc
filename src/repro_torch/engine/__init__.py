"""repro_torch.engine — declare (``EngineSpec``), plan (``plan``), execute
(``compile`` -> ``EmbeddingEngine.lookup`` / ``cached_lookup`` /
``serve_gather``, and on a mesh ``gnr`` / ``forward_partial`` /
``inline_gnr`` / ``baseline``; ``engine_for`` memoises the no-trace plan and
compile), as in ``repro.engine``.  Every tunable decision of the plan is a
``tune.Knobs``: the heuristic defaults, an explicit ``knobs=``, or a fitted
tuner's argmin (``plan(spec, traces, tuner=tune.fit(spec, traces))``)."""

from repro_torch.engine.engine import EmbeddingEngine, compile, engine_for  # noqa: F401
from repro_torch.engine.plan import (  # noqa: F401
    EmbeddingPlan, big_rows, big_subtable, plan,
)
from repro_torch.engine.spec import EngineSpec  # noqa: F401
