"""Seeded hot-set-drift schedules — ONE definition of "the traffic moved"
(port of ``repro.adapt.schedule``, numpy, copied verbatim).

Two places used to roll their own Zipf hot-set rotation: the open-loop
arrival generator (``repro_torch.serve.arrival`` rotates each request's keys by a
vocab offset every ``drift_period_s``) and the cache benchmarks (per-batch
rotation of a profiled trace).  Both now route through
:class:`DriftSchedule`, so "rotate the hot set by ``fraction`` of the vocab
every ``period``" means exactly the same permutation everywhere — a
benchmark row stamped with a schedule reproduces the serving traffic that
produced it.

``period`` is unit-agnostic: the arrival generator passes virtual seconds,
the batch-stream helpers pass batch indices.  Rotation is a pure function of
``(t, period, fraction, vocab)``; the ``seed`` seeds the *trace sampling*
(:func:`drifting_zipf_batches`), not the rotation itself, so two equal
schedules always drift identically.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import synthetic


def rotation_offset(t: float, period: float, fraction: float, vocab: int) -> int:
    """Vocab offset of the Zipf hot set at time (or batch index) ``t``.

    Every ``period`` units the hot set moves by ``int(fraction * vocab)``
    ids (mod vocab) — the permuted-Zipf head lands on a disjoint-ish row set
    while the marginal skew is unchanged, which is exactly the drift an
    offline ``plan()`` cannot see.
    """
    if period <= 0:
        return 0
    k = int(t / period)
    return (k * int(fraction * vocab)) % max(1, vocab)


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """One hot-set-rotation law — hashable, JSON-able, shared by the arrival
    generator, the drift benchmarks, and the adaptive serving loop.

    ``period`` — units between rotations (virtual seconds for open-loop
    traffic, batch indices for batch streams; 0 = stationary);
    ``fraction`` — vocab fraction the hot set moves per rotation;
    ``seed`` — seeds trace *sampling* helpers (rotation is deterministic).
    """

    period: float = 0.0
    fraction: float = 0.25
    seed: int = 0

    @property
    def stationary(self) -> bool:
        return self.period <= 0

    def offset_at(self, t: float, vocab: int) -> int:
        return rotation_offset(t, self.period, self.fraction, vocab)

    def rotate(self, idx: np.ndarray, t: float, vocab: int) -> np.ndarray:
        """Apply the rotation active at ``t`` to a batch of logical indices."""
        off = self.offset_at(t, vocab)
        if off == 0:
            return idx
        return ((np.asarray(idx).astype(np.int64) + off) % vocab).astype(
            np.asarray(idx).dtype
        )

    def rotations_before(self, t: float) -> int:
        """How many distinct rotations happened strictly before ``t``."""
        if self.stationary:
            return 0
        return int(t / self.period)

    def describe(self) -> dict:
        return {
            "period": self.period,
            "fraction": self.fraction,
            "seed": self.seed,
        }

    @classmethod
    def parse(cls, text: str) -> "DriftSchedule":
        """Parse the CLI form, e.g. ``"period=8,frac=0.25,seed=3"``."""
        kw: dict = {}
        for tok in filter(None, (t.strip() for t in text.split(","))):
            if "=" not in tok:
                raise ValueError(f"bad --drift token {tok!r} (want key=value)")
            k, v = (s.strip() for s in tok.split("=", 1))
            if k == "period":
                kw["period"] = float(v)
            elif k in ("frac", "fraction"):
                kw["fraction"] = float(v)
            elif k == "seed":
                kw["seed"] = int(v)
            else:
                raise ValueError(f"unknown --drift key {k!r}")
        return cls(**kw)


def drifting_zipf_batches(
    vocab: int, n_batches: int, batch_elems: int, *,
    schedule: DriftSchedule, alpha: float = 1.05, seed: int | None = None,
) -> np.ndarray:
    """(n_batches, batch_elems) Zipf indices whose hot set follows the
    schedule — batch index is the schedule's time axis.

    Deterministic in ``(vocab, shape, schedule, alpha, seed)``: the base
    trace is one :func:`repro_torch.data.synthetic.zipf_trace` draw, rotated per
    batch, so the un-drifted marginal distribution matches what the offline
    profiler models.  ``seed=None`` takes the schedule's seed.
    """
    seed = schedule.seed if seed is None else seed
    base = synthetic.zipf_trace(
        vocab, n_batches * batch_elems, alpha=alpha, seed=seed
    ).reshape(n_batches, batch_elems)
    return np.stack(
        [schedule.rotate(base[t], t, vocab) for t in range(n_batches)]
    )
