"""Trace-driven autotuner: knob space, fitted cost model, tuner (port of
``repro.tune``).

:mod:`~repro_torch.tune.knobs` and :mod:`~repro_torch.tune.cost_model` are
numpy-only and imported eagerly — ``engine/plan.py`` depends on them, so
they must not pull in the engine.  The :class:`Tuner` / :func:`fit` half
(timed runs, analytic pricing) needs the engine, so it loads lazily on
first attribute access.
"""

from repro_torch.tune.cost_model import (     # noqa: F401
    FEATURES, CostSample, KernelCostModel, fit_cost_model, plan_features,
)
from repro_torch.tune.knobs import (          # noqa: F401
    Knobs, default_dim_block, default_knobs, knob_space, slot_budgets,
    spec_dup_budget_bytes, valid_dim_blocks,
)

_LAZY = ("Tuner", "TraceProfile", "TableProfile", "fit", "spec_digest",
         "device_kind", "run_metadata")


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.tune import tuner as _tuner

        return getattr(_tuner, name)
    raise AttributeError(f"module 'repro_torch.tune' has no attribute {name!r}")


__all__ = [
    "FEATURES", "CostSample", "KernelCostModel", "Knobs", "TableProfile",
    "TraceProfile", "Tuner", "default_dim_block", "default_knobs",
    "device_kind", "fit", "fit_cost_model", "knob_space", "plan_features",
    "run_metadata", "slot_budgets", "spec_dup_budget_bytes",
    "valid_dim_blocks",
]
