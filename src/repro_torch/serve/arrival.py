"""Seeded open-loop traffic: Poisson arrivals, flash crowds, Zipf key drift
(port of ``repro.serve.arrival``, numpy: the same request stream, element
for element).

The serving benchmarks so far pulled batches from an infinitely patient
queue; real recommendation traffic is *open-loop* — requests arrive on their
own clock whether or not the server keeps up, and the interesting regimes
are exactly the ones where it doesn't.  This module generates that traffic
deterministically:

* **Poisson base load** — exponential inter-arrival gaps at ``rate_rps``;
* **flash crowds** — :class:`FlashEpisode` windows multiply the instantaneous
  rate (the thinning construction keeps the process exact: draw at the peak
  rate, keep each arrival with probability ``rate(t)/peak``);
* **Zipf key drift** — each request's per-table multi-hot indices are drawn
  from the same permuted-Zipf law the profiler models
  (:func:`repro_torch.data.synthetic.zipf_probs`), with the hot set rotated by a
  vocab offset every ``drift_period_s`` — the prefetch cache's working set
  moves under it mid-run, exactly the non-stationarity the paper's offline
  profiling cannot see.

Everything is a pure function of the spec (seed included): two calls to
:func:`generate` with equal specs return byte-identical request streams, so
benchmark rows stamped with the spec reproduce exactly.

All times are **virtual seconds** (the front end's simulated clock), not
wall time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.adapt import schedule as schedule_mod
from repro_torch.data import synthetic


@dataclasses.dataclass(frozen=True)
class FlashEpisode:
    """One flash-crowd window: rate × ``multiplier`` in [start, start+duration)."""

    start_s: float
    duration_s: float
    multiplier: float

    def active(self, t_s: float) -> bool:
        return self.start_s <= t_s < self.start_s + self.duration_s

    def describe(self) -> dict:
        return {
            "start_s": self.start_s,
            "duration_s": self.duration_s,
            "multiplier": self.multiplier,
        }


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """The full traffic model — hashable, JSON-able, parseable from the CLI."""

    rate_rps: float = 400.0          # base Poisson rate, virtual requests/s
    horizon_s: float = 4.0           # generate arrivals in [0, horizon)
    deadline_s: float = 0.25         # per-request latency budget
    alpha: float = 1.05              # Zipf skew of the key distribution
    drift_period_s: float = 0.0      # hot-set rotation period (0 = stationary)
    drift_fraction: float = 0.25     # vocab fraction the hot set moves per period
    flash: tuple[FlashEpisode, ...] = ()
    seed: int = 0

    def __post_init__(self):
        if self.rate_rps <= 0 or self.horizon_s <= 0:
            raise ValueError("rate_rps and horizon_s must be positive")
        if self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive")

    def rate_at(self, t_s: float) -> float:
        """Instantaneous arrival rate (flash multipliers stack)."""
        r = self.rate_rps
        for ep in self.flash:
            if ep.active(t_s):
                r *= ep.multiplier
        return r

    @property
    def peak_rate(self) -> float:
        """Upper bound on ``rate_at`` — the thinning envelope."""
        r = self.rate_rps
        for ep in self.flash:
            if ep.multiplier > 1.0:
                # overlapping episodes stack, so the envelope is the product
                r *= ep.multiplier
        return r

    def describe(self) -> dict:
        """JSON form — stamped into benchmark rows for reproducibility."""
        return {
            "rate_rps": self.rate_rps,
            "horizon_s": self.horizon_s,
            "deadline_s": self.deadline_s,
            "alpha": self.alpha,
            "drift_period_s": self.drift_period_s,
            "drift_fraction": self.drift_fraction,
            "flash": [ep.describe() for ep in self.flash],
            "seed": self.seed,
        }

    # -- CLI form -------------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "ArrivalSpec":
        """Parse the ``--arrival`` form, e.g.
        ``"rate=400,horizon=4,deadline_ms=250,flash=1.0+0.5x8,drift_s=2"``.

        ``flash=START+DURxMULT`` may repeat; times are virtual seconds.
        """
        kw: dict = {}
        flash: list[FlashEpisode] = []
        for tok in filter(None, (t.strip() for t in text.split(","))):
            if "=" not in tok:
                raise ValueError(f"bad --arrival token {tok!r} (want key=value)")
            k, v = (s.strip() for s in tok.split("=", 1))
            if k == "rate":
                kw["rate_rps"] = float(v)
            elif k == "horizon":
                kw["horizon_s"] = float(v)
            elif k == "deadline_ms":
                kw["deadline_s"] = float(v) * 1e-3
            elif k == "deadline_s":
                kw["deadline_s"] = float(v)
            elif k == "alpha":
                kw["alpha"] = float(v)
            elif k == "drift_s":
                kw["drift_period_s"] = float(v)
            elif k == "drift_frac":
                kw["drift_fraction"] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            elif k == "flash":
                try:
                    start, rest = v.split("+", 1)
                    dur, mult = rest.split("x", 1)
                except ValueError:
                    raise ValueError(
                        f"bad flash episode {v!r} (want START+DURxMULT)"
                    ) from None
                flash.append(FlashEpisode(float(start), float(dur), float(mult)))
            else:
                raise ValueError(f"unknown --arrival key {k!r}")
        return cls(flash=tuple(flash), **kw)


@dataclasses.dataclass
class Request:
    """One timestamped recommendation request (a single batch row)."""

    rid: int
    t_arrive_s: float
    deadline_s: float               # absolute virtual deadline
    idx: np.ndarray                 # (num_tables, pooling) sparse indices
    dense: np.ndarray               # (num_dense,) dense features

    def slack_at(self, now_s: float) -> float:
        """Remaining budget at virtual time ``now_s`` (negative = late)."""
        return self.deadline_s - now_s


def _arrival_times(spec: ArrivalSpec, rng: np.random.Generator) -> np.ndarray:
    """Exact inhomogeneous-Poisson arrival times on [0, horizon) by thinning."""
    peak = spec.peak_rate
    times: list[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= spec.horizon_s:
            break
        if rng.random() <= spec.rate_at(t) / peak:
            times.append(t)
    return np.asarray(times, dtype=np.float64)


def drift_offset(spec: ArrivalSpec, t_s: float, vocab: int) -> int:
    """Vocab rotation of the Zipf hot set at virtual time ``t_s``.

    Delegates to the shared drift-schedule law (`repro_torch.adapt.schedule`) —
    the arrival generator and the drift benchmarks rotate identically.
    """
    return schedule_mod.rotation_offset(
        t_s, spec.drift_period_s, spec.drift_fraction, vocab
    )


def generate(spec: ArrivalSpec, cfg) -> list[Request]:
    """The full request stream for a ``DLRMConfig`` — sorted by arrival time.

    Keys come from the permuted-Zipf law (inverse-CDF sampled, so the
    distribution matches what ``build_serve_state`` profiled), rotated by the
    drift offset of each request's arrival time.
    """
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed, 0xA221]))
    times = _arrival_times(spec, rng)
    n = times.size
    vocab = cfg.vocab_per_table
    cdf = np.cumsum(synthetic.zipf_probs(vocab, spec.alpha))
    cdf[-1] = 1.0                        # guard float round-off at the tail

    shape = (n, cfg.num_tables, cfg.pooling)
    base_idx = np.searchsorted(cdf, rng.random(shape)).astype(np.int32)
    dense = rng.standard_normal((n, cfg.num_dense)).astype(np.float32)

    out: list[Request] = []
    for i in range(n):
        t = float(times[i])
        off = drift_offset(spec, t, vocab)
        idx = (base_idx[i] + off) % vocab if off else base_idx[i]
        out.append(Request(
            rid=i,
            t_arrive_s=t,
            deadline_s=t + spec.deadline_s,
            idx=idx.astype(np.int32),
            dense=dense[i],
        ))
    return out
