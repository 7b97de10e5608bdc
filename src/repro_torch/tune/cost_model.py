"""Fitted per-kernel linear cost model: latency from bytes, rows, dispatches
(port of ``repro.tune.cost_model``: the model and its fit).

The tuner's predictor is deliberately simple — per execution backend (the
packed kernel vs the per-table kernel loop), one nonnegative linear model

    latency_s  =  c_dispatch * dispatches
                + c_bytes    * hbm_bytes
                + c_tiles    * row_tiles
                + c_comm     * comm_bytes

whose coefficients are fitted from observed samples (timed runs of the real
kernels on the card), or priced from the card's constants when no fit
exists (``obs.attribution.analytic_cost_model``).  The serving attribution
splits a batch's time along these terms.

``repro``'s ``plan_features`` (the features of a knob setting against a
trace profile) belongs to the tuner and comes with it.

The model only has to *rank* candidate knob settings correctly; absolute
accuracy is a bonus.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tune.knobs import Knobs

FEATURES = ("dispatches", "hbm_bytes", "row_tiles", "comm_bytes")


@dataclasses.dataclass(frozen=True)
class CostSample:
    """One (knob setting, features, observed latency) observation."""

    knobs: Knobs
    features: tuple[float, ...]
    measured_s: float
    source: str = "measure"           # where measured_s came from

    def describe(self) -> dict:
        return {
            "knobs": self.knobs.describe(),
            "features": dict(zip(FEATURES, self.features)),
            "measured_s": self.measured_s,
            "source": self.source,
        }


@dataclasses.dataclass(frozen=True)
class KernelCostModel:
    """Nonnegative linear model over :data:`FEATURES` for one backend."""

    coef: tuple[float, ...]
    backend: str = "packed"
    source: str = "measure"
    num_samples: int = 0

    def predict(self, features: tuple[float, ...]) -> float:
        return float(sum(c * f for c, f in zip(self.coef, features)))

    def describe(self) -> dict:
        return {
            "backend": self.backend,
            "source": self.source,
            "num_samples": self.num_samples,
            "coef": dict(zip(FEATURES, self.coef)),
        }

    @classmethod
    def from_json(cls, d: dict) -> "KernelCostModel":
        return cls(
            coef=tuple(float(d["coef"][f]) for f in FEATURES),
            backend=d.get("backend", "packed"),
            source=d.get("source", "measure"),
            num_samples=int(d.get("num_samples", 0)),
        )


def fit_cost_model(
    samples: "list[CostSample]", *, backend: str, source: str = "measure"
) -> KernelCostModel:
    """Nonnegative least squares over the samples (clip-and-refit).

    A plain ``lstsq`` can go negative on collinear features (e.g. bytes and
    tiles move together when only the slot budget varies); negative
    coefficients would let the tuner "pay" for more traffic, so they are
    clipped to zero and the surviving columns refitted once.
    """
    if not samples:
        raise ValueError("need at least one sample to fit a cost model")
    x = np.asarray([s.features for s in samples], dtype=np.float64)
    y = np.asarray([s.measured_s for s in samples], dtype=np.float64)
    # column scaling keeps lstsq well-conditioned across ~12 orders of magnitude
    scale = np.maximum(np.abs(x).max(axis=0), 1e-30)
    coef, *_ = np.linalg.lstsq(x / scale, y, rcond=None)
    if (coef < 0).any():
        pos = coef > 0
        coef = np.zeros_like(coef)
        if pos.any():
            sub, *_ = np.linalg.lstsq((x / scale)[:, pos], y, rcond=None)
            coef[pos] = np.maximum(sub, 0.0)
    coef = coef / scale
    return KernelCostModel(
        coef=tuple(float(c) for c in coef), backend=backend, source=source,
        num_samples=len(samples),
    )
