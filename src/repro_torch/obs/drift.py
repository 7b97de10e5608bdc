"""Cost-model drift monitoring: predicted-vs-measured residuals over a
sliding window, with a "re-fit recommended" trigger (port of
``repro.obs.drift``).

An autotuner freezes a fitted linear cost model into the plan at ``plan()``
time; traffic drifts, hosts change, and the memoized model quietly goes
stale.  This detector keeps observing (predicted, measured) latency pairs
while serving, and flags when the *relationship* between them moves.
``serve_rec.run_pipeline`` feeds it whenever its ``ServeState`` carries a
prediction and a monitor; only a tuner arms them.

Two complementary signals:

* **residual drift** — the model's relative residual ``(measured -
  predicted) / predicted`` is allowed a constant bias (an analytic model
  can be uniformly 2x off and still rank knob settings perfectly); what
  matters is the *recent window's* median residual moving away from the
  *calibration* median (the first window observed, i.e. the regime the fit
  was trusted in);
* **rank-agreement decay** — the tuner only needs ordering, so the monitor
  also estimates Kendall-style pairwise agreement between predictions and
  measurements inside the recent window, ignoring pairs whose measured gap
  is under the host-noise floor.

``refit_recommended`` is the OR of the two triggers once ``min_points``
observations exist.  Purely host-side numpy; a monitor costs one append per
batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# measured differences below this relative gap are host noise — pairs inside
# it are unrankable and excluded from agreement (same floor benchmarks use)
DEFAULT_NOISE_REL = 0.10


def rank_agreement(pairs, *, noise_rel: float = DEFAULT_NOISE_REL
                   ) -> tuple[float, int]:
    """Pairwise order agreement of [(predicted, measured), ...].

    Returns ``(agreement, rankable_pairs)``; pairs whose measured values sit
    within ``noise_rel`` of each other are skipped (unrankable), and an
    all-tied set reports perfect agreement over zero pairs.
    """
    agree = counted = 0
    pairs = list(pairs)
    for i in range(len(pairs)):
        for j in range(i + 1, len(pairs)):
            pi, mi = pairs[i]
            pj, mj = pairs[j]
            if abs(mi - mj) <= noise_rel * max(abs(mi), abs(mj)):
                continue
            counted += 1
            if (pi - pj) * (mi - mj) > 0:
                agree += 1
    return (agree / counted if counted else 1.0), counted


@dataclasses.dataclass
class DriftMonitor:
    """Sliding-window predicted-vs-measured residual monitor.

    ``window`` — observations per window (calibration = the first window,
    recent = the last); ``rel_tol`` — residual-median shift that triggers;
    ``rank_floor`` — recent rank agreement below this triggers;
    ``min_points`` — no verdict before this many observations.
    """

    window: int = 32
    rel_tol: float = 0.25
    rank_floor: float = 0.7
    min_points: int = 8
    noise_rel: float = DEFAULT_NOISE_REL

    def __post_init__(self):
        self._pred: list[float] = []
        self._meas: list[float] = []

    # -- observation ---------------------------------------------------------

    def observe(self, predicted_s: float, measured_s: float) -> None:
        self._pred.append(float(predicted_s))
        self._meas.append(float(measured_s))

    @property
    def n(self) -> int:
        return len(self._meas)

    def residuals(self) -> np.ndarray:
        """(n,) relative residuals (measured - predicted) / predicted."""
        p = np.asarray(self._pred)
        m = np.asarray(self._meas)
        return (m - p) / np.maximum(np.abs(p), 1e-30)

    # -- verdict -------------------------------------------------------------

    def _median(self, arr: np.ndarray) -> float:
        return float(np.median(arr)) if arr.size else 0.0

    @property
    def calibration_residual(self) -> float:
        return self._median(self.residuals()[: self.window])

    @property
    def recent_residual(self) -> float:
        return self._median(self.residuals()[-self.window:])

    @property
    def drift(self) -> float:
        """Shift of the recent residual median away from calibration."""
        if self.n == 0:
            return 0.0
        return abs(self.recent_residual - self.calibration_residual)

    def recent_rank_agreement(self) -> tuple[float, int]:
        pairs = list(zip(self._pred[-self.window:], self._meas[-self.window:]))
        return rank_agreement(pairs, noise_rel=self.noise_rel)

    @property
    def refit_recommended(self) -> bool:
        """True once the model has visibly drifted: residual-median shift
        beyond ``rel_tol`` or recent rank agreement under ``rank_floor``."""
        if self.n < self.min_points:
            return False
        if self.drift > self.rel_tol:
            return True
        agreement, counted = self.recent_rank_agreement()
        return counted > 0 and agreement < self.rank_floor

    def summary(self) -> dict:
        agreement, counted = self.recent_rank_agreement()
        return {
            "observations": self.n,
            "window": self.window,
            "calibration_residual": self.calibration_residual,
            "recent_residual": self.recent_residual,
            "drift": self.drift,
            "rel_tol": self.rel_tol,
            "rank_agreement": agreement,
            "rankable_pairs": counted,
            "rank_floor": self.rank_floor,
            "refit_recommended": self.refit_recommended,
        }
