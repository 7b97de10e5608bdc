"""Online adaptation: sketches -> incremental re-planning -> drift refit
(port of ``repro.adapt``).

The offline ``plan()`` pass bets on a static trace; this package keeps the
bet current while serving.  ``sketch`` watches live traffic (count-min +
space-saving over a decaying window ring), ``replan`` turns estimates into
new cache residency as pure runtime args against the same engine and
kernels (plus the expensive full ``plan()`` path), ``policy`` decides when either is
worth it (hysteresis + cooldown + the ``DriftMonitor`` refit hook), and
``loop`` is the ``serve_rec --adapt`` serving session.  ``schedule`` is the
shared seeded drift-schedule helper the arrival generator and the drift
benchmarks both use.
"""

from repro_torch.adapt.policy import AdaptController, AdaptPolicy   # noqa: F401
from repro_torch.adapt.replan import (                          # noqa: F401
    IncrementalUpdate,
    PinnedCache,
    incremental_update,
    pinned_from_plan,
    replan_full,
    sampled_traces,
)
from repro_torch.adapt.schedule import (                        # noqa: F401
    DriftSchedule,
    drifting_zipf_batches,
    rotation_offset,
)
from repro_torch.adapt.sketch import (                          # noqa: F401
    CountMinSketch,
    FrequencySketch,
    SpaceSaving,
)

# The serving session (``loop``) pulls in the full launch/engine stack; load
# it lazily so light consumers (the arrival generator importing ``schedule``,
# sketch-only benchmarks) stay cheap.
_LOOP_EXPORTS = ("serve_adaptive", "make_refit_hook", "make_full_hook")


def __getattr__(name: str):
    if name in _LOOP_EXPORTS:
        from repro_torch.adapt import loop

        return getattr(loop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
