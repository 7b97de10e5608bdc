"""Fitted per-kernel linear cost model: latency from bytes, rows, dispatches
(port of ``repro.tune.cost_model``: the model and its fit).

The tuner's predictor is deliberately simple — per execution backend (the
packed kernel vs the per-table kernel loop), one nonnegative linear model

    latency_s  =  c_dispatch * dispatches
                + c_bytes    * hbm_bytes
                + c_tiles    * row_tiles
                + c_comm     * comm_bytes

whose features are computed analytically from the trace profile and a knob
setting (:func:`plan_features`, equal to ``repro``'s), and whose
coefficients are fitted from observed samples: timed runs of the real
kernels on the card, or the bytes and flops the packed kernel needs for a
sampled batch priced at the card's constants (``tune.tuner``'s
``analytic`` mode), or priced from the constants alone when no fit exists
(``obs.attribution.analytic_cost_model``).  The serving attribution splits a
batch's time along these terms.

The model only has to *rank* candidate knob settings correctly; absolute
accuracy is a bonus.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tune.knobs import Knobs

# repro's 128-lane vector width of its dim-tiled TPU kernels: the padding
# ``_padded_row_bytes`` prices, kept so the features equal repro's
_LANES = 128

FEATURES = ("dispatches", "hbm_bytes", "row_tiles", "comm_bytes")


@dataclasses.dataclass(frozen=True)
class CostSample:
    """One (knob setting, features, observed latency) observation."""

    knobs: Knobs
    features: tuple[float, ...]
    measured_s: float
    source: str = "measure"           # measure | analytic

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


# ---------------------------------------------------------------------------
# analytic features of (spec, knobs) against a trace profile
# ---------------------------------------------------------------------------

def _padded_row_bytes(row_bytes: int, width_elems: int, dim_block: int | None
                      ) -> float:
    """Bytes one streamed row costs under a lane tile choice.

    Full-lane tiles stream exactly the row; a partial trailing tile is padded
    to the 128-lane width (the single-wide-tile fallback for dims like 96),
    so its traffic is inflated by ``ceil(bd/128)*128 / bd``.
    """
    if dim_block is None or width_elems <= 0:
        return float(row_bytes)
    bd = min(dim_block, width_elems)
    padded = -(-bd // _LANES) * _LANES
    return row_bytes * (padded / bd)


def plan_features(spec, knobs: Knobs, profile) -> tuple[float, ...]:
    """Per-batch feature vector of one knob setting.

    ``profile`` is a :class:`repro_torch.tune.tuner.TraceProfile`; features
    are the cost model's regressors:

    * ``dispatches`` — kernel launches per batch (1 packed, T per-table);
    * ``hbm_bytes`` — streamed big-subtable bytes after the prefetch cache:
      misses + staging copies, padded by the lane-tile choice;
    * ``row_tiles`` — gathered rows x dim tiles (per-tile issue overhead:
      a smaller ``dim_block`` means more grid steps per row);
    * ``comm_bytes`` — modeled cross-shard combine bytes left after the
      duplication budget kills comm-free tables.
    """
    from repro_torch.tune import knobs as knobs_mod

    num_t = spec.num_tables
    dispatches = 1.0 if knobs.backend == "packed" else float(num_t)

    values = [t.values for t in profile.tables]
    budgets = knobs_mod.slot_budgets(spec, knobs, values)

    hbm = 0.0
    tiles = 0.0
    for t, (tp, slots) in enumerate(zip(profile.tables, budgets)):
        hit_rate, staged = profile.hit_stats(t, slots)
        acc = tp.accesses_per_batch
        streamed_rows = acc * (1.0 - hit_rate) + staged
        hbm += streamed_rows * _padded_row_bytes(
            tp.row_bytes, tp.width_elems, knobs.dim_block
        )
        width = max(1, tp.width_elems)
        bd = knobs.dim_block or width
        tiles += acc * max(1.0, width / min(bd, width))
    comm = profile.comm_bytes(spec, knobs.dup_budget_bytes)
    return (dispatches, hbm, tiles, comm)
