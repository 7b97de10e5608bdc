"""repro_torch.engine — declare (``EngineSpec``), plan (``plan``), execute
(``compile`` -> ``EmbeddingEngine.serve_gather``), as in ``repro.engine``."""

from repro_torch.engine.engine import EmbeddingEngine, compile  # noqa: F401
from repro_torch.engine.plan import (  # noqa: F401
    EmbeddingPlan, big_rows, big_subtable, plan,
)
from repro_torch.engine.spec import EngineSpec  # noqa: F401
