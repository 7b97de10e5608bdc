"""repro_torch.serve — the resilient serving front end (port of
``repro.serve``).

The engine's ``pack`` + ``serve_gather`` seam executes one batch; this
package wraps it with everything a production front end needs between the
wire and the kernel:

* ``arrival``  — seeded open-loop traffic (Poisson base rate, flash-crowd
  episodes, Zipf key drift) producing timestamped requests;
* ``frontend`` — bounded admission queue with load shedding, deadline-aware
  batch assembly, and per-request accounting (admitted = served + shed +
  deadline-missed, always);
* ``faults``   — a deterministic fault-injection harness (dispatch stalls,
  prefetch drops, replica loss via the elastic heartbeats, transient gather
  errors) with bounded retry + exponential backoff;
* ``degrade``  — the graceful-degradation ladder (full packed+cached →
  prefetch off → per-table launches → the per-table semantic loop → shed) driven by SLO
  burn-rate signals and fault events, with hysteresis and recovery probes.

All timing is on a **virtual clock**: a batch's measured wall time is
normalized by a calibrated warm-up median and scaled to a nominal service
unit, so arrival pressure, deadlines, SLO burns, and backoff are
host-speed-independent — the chaos CI gate asserts exact behavior, not
timing luck.
"""

from repro_torch.serve.arrival import ArrivalSpec, FlashEpisode, Request, generate  # noqa: F401
from repro_torch.serve.degrade import RUNGS, DegradationLadder, DegradePolicy  # noqa: F401
from repro_torch.serve.faults import (  # noqa: F401
    FaultEvent, FaultInjector, FaultSpec, TransientGatherError,
)
from repro_torch.serve.frontend import (  # noqa: F401
    Frontend, FrontendConfig, FrontendStats,
)
