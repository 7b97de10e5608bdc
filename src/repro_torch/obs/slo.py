"""Declarative serving SLOs with error-budget accounting and Google-SRE-style
multi-window burn-rate alerts.

The repo's serving claims are distribution claims, so the SLO layer is built
on *events*, not averages: each steady-state batch is one event, and the
event is **bad** when its latency exceeds the :class:`SLOSpec` target.  With
an objective of, say, 0.99, the error budget allows 1% of batches to be bad;
the **burn rate** of a window is

    burn = (bad events in window / window size) / (1 - objective)

so burn 1.0 spends the budget exactly on schedule, burn 10 spends it 10x too
fast.  Alerting follows the SRE workbook's multi-window pattern, translated
from wall-clock windows to batch-count windows (the serving loop is the
clock):

* **page**  — both the slow and the fast window burn at >= ``page_burn``
  (the slow window proves the burn is sustained; the fast window proves it
  is still happening *now*);
* **ticket** — the slow window alone burns at >= ``ticket_burn`` (slow leak).

Hit-rate and QPS floors are session-level objectives (the prefetch cache and
throughput are cumulative quantities), checked by :meth:`SLOEngine.finalize`
rather than per batch.

Evaluation is streaming: feed :meth:`SLOEngine.observe` per batch, or point
:meth:`SLOEngine.evaluate_snapshot` at successive ``RegistrySnapshot``s — the
engine keeps a cursor into the latency histogram's retained samples and only
consumes what it has not seen, so repeated snapshots never double-count.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One serving SLO: a latency target plus optional session floors.

    ``p99_latency_s`` — per-batch latency target (the "good event" bound);
    ``objective`` — fraction of batches that must meet it (0.99 = 1% budget);
    ``hit_rate_floor`` / ``qps_floor`` — session-level floors checked at
    finalize; windows/burns parameterize the multi-window alert policy.
    """

    name: str = "serving"
    p99_latency_s: float | None = None
    hit_rate_floor: float | None = None
    qps_floor: float | None = None
    objective: float = 0.99
    fast_window: int = 8                 # batches ("is it happening now?")
    slow_window: int = 32                # batches ("is it sustained?")
    page_burn: float = 10.0
    ticket_burn: float = 2.0

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0,1), got {self.objective}")
        if self.fast_window <= 0 or self.slow_window < self.fast_window:
            raise ValueError(
                f"need 0 < fast_window <= slow_window, got "
                f"{self.fast_window}/{self.slow_window}"
            )

    @property
    def budget_fraction(self) -> float:
        return 1.0 - self.objective

    def describe(self) -> dict:
        return {
            "name": self.name,
            "p99_latency_s": self.p99_latency_s,
            "hit_rate_floor": self.hit_rate_floor,
            "qps_floor": self.qps_floor,
            "objective": self.objective,
            "fast_window": self.fast_window,
            "slow_window": self.slow_window,
            "page_burn": self.page_burn,
            "ticket_burn": self.ticket_burn,
        }

    # -- CLI form ------------------------------------------------------------

    _KEYS = ("p99_ms", "p99_s", "hit", "qps", "objective", "fast_window",
             "slow_window", "page_burn", "ticket_burn", "name")

    @classmethod
    def parse(cls, text: str) -> "SLOSpec":
        """Parse the ``serve_rec --slo`` form, e.g.
        ``"p99_ms=50,hit=0.5,qps=100,objective=0.99"``."""
        kw: dict = {}
        for tok in filter(None, (t.strip() for t in text.split(","))):
            if "=" not in tok:
                raise ValueError(f"bad --slo token {tok!r} (want key=value)")
            k, v = (s.strip() for s in tok.split("=", 1))
            if k not in cls._KEYS:
                raise ValueError(f"unknown --slo key {k!r} (known: {cls._KEYS})")
            if k == "name":
                kw["name"] = v
            elif k == "p99_ms":
                kw["p99_latency_s"] = float(v) * 1e-3
            elif k == "p99_s":
                kw["p99_latency_s"] = float(v)
            elif k == "hit":
                kw["hit_rate_floor"] = float(v)
            elif k == "qps":
                kw["qps_floor"] = float(v)
            elif k in ("fast_window", "slow_window"):
                kw[k] = int(v)
            else:
                kw[k] = float(v)
        return cls(**kw)


class SLOEngine:
    """Streaming burn-rate evaluation of one :class:`SLOSpec`.

    Feed :meth:`observe` one latency per steady-state batch; it returns the
    alerts (possibly empty) that fired on that observation.  Window math is
    over the most recent N *observations* — the serving loop is the clock.
    """

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self._bad: list[bool] = []          # per-observation verdicts, in order
        self._latencies: list[float] = []
        self._alerts: list[dict] = []       # every alert ever fired
        self._active: set[str] = set()      # severities currently firing
        self._hist_cursor: dict[str, int] = {}   # snapshot streaming state
        self._floors: dict = {}             # finalize() results

    # -- observation ---------------------------------------------------------

    @property
    def n(self) -> int:
        return len(self._bad)

    @property
    def bad_total(self) -> int:
        return sum(self._bad)

    def observe(self, latency_s: float) -> list[dict]:
        """Record one batch latency; return alerts fired by this observation."""
        target = self.spec.p99_latency_s
        bad = target is not None and float(latency_s) > target
        self._bad.append(bool(bad))
        self._latencies.append(float(latency_s))
        fired = self._evaluate_windows()
        self._alerts.extend(fired)
        return fired

    def evaluate_snapshot(self, snapshot, *,
                          histogram: str = "serve/overlap/batch_latency_s"
                          ) -> list[dict]:
        """Consume latency samples a ``RegistrySnapshot`` holds beyond this
        engine's cursor (streaming: repeated snapshots never double-count)."""
        h = snapshot.histograms.get(histogram)
        if h is None:
            return []
        samples = h.samples
        start = self._hist_cursor.get(histogram, 0)
        fired: list[dict] = []
        for v in samples[start:]:
            fired.extend(self.observe(float(v)))
        self._hist_cursor[histogram] = int(samples.size)
        return fired

    # -- window math ---------------------------------------------------------

    def burn_rate(self, window: int) -> float:
        """Burn rate of the most recent ``window`` observations (0 before the
        first observation; windows shorter than ``window`` use what exists)."""
        if not self._bad:
            return 0.0
        recent = self._bad[-window:]
        error_rate = sum(recent) / len(recent)
        return error_rate / self.spec.budget_fraction

    def _evaluate_windows(self) -> list[dict]:
        """Edge-triggered: an alert fires on the observation that *enters* the
        burning condition, not on every batch the condition persists."""
        spec = self.spec
        if spec.p99_latency_s is None or self.n < spec.fast_window:
            return []
        fast = self.burn_rate(spec.fast_window)
        slow = self.burn_rate(spec.slow_window)
        now: set[str] = set()
        if fast >= spec.page_burn and slow >= spec.page_burn:
            now.add("page")
        elif self.n >= spec.slow_window and slow >= spec.ticket_burn:
            now.add("ticket")
        fired = [
            {
                "severity": sev, "slo": spec.name, "at_batch": self.n - 1,
                "fast_burn": fast, "slow_burn": slow,
                "threshold": spec.page_burn if sev == "page"
                else spec.ticket_burn,
            }
            for sev in sorted(now - self._active)
        ]
        self._active = now
        return fired

    # -- error budget --------------------------------------------------------

    @property
    def budget_allowed(self) -> float:
        """Bad events the budget allows over everything observed so far."""
        return self.spec.budget_fraction * self.n

    @property
    def budget_spent(self) -> int:
        return self.bad_total

    @property
    def budget_remaining_frac(self) -> float:
        """1.0 = untouched budget, 0.0 = exactly exhausted, negative = blown."""
        if self.n == 0:
            return 1.0
        allowed = self.budget_allowed
        return 1.0 - self.budget_spent / allowed if allowed > 0 else 1.0

    # -- session floors + verdict --------------------------------------------

    def finalize(self, *, hit_rate: float | None = None,
                 qps: float | None = None) -> dict:
        """Check the session-level floors against measured totals."""
        spec = self.spec
        floors = {}
        if spec.hit_rate_floor is not None and hit_rate is not None:
            floors["hit_rate"] = {
                "floor": spec.hit_rate_floor, "measured": float(hit_rate),
                "breached": hit_rate < spec.hit_rate_floor,
            }
        if spec.qps_floor is not None and qps is not None:
            floors["qps"] = {
                "floor": spec.qps_floor, "measured": float(qps),
                "breached": qps < spec.qps_floor,
            }
        self._floors = floors
        return floors

    @property
    def breached(self) -> bool:
        """True once any alert fired, the budget blew, or a floor failed."""
        return (
            bool(self._alerts)
            or self.budget_remaining_frac < 0.0
            or any(f["breached"] for f in self._floors.values())
        )

    @property
    def alerts(self) -> list[dict]:
        return list(self._alerts)

    def state(self) -> dict:
        """JSON-ready engine state — the report's SLO section."""
        spec = self.spec
        return {
            "spec": spec.describe(),
            "observations": self.n,
            "bad_events": self.bad_total,
            "budget_allowed": self.budget_allowed,
            "budget_spent": self.budget_spent,
            "budget_remaining_frac": self.budget_remaining_frac,
            "fast_burn": self.burn_rate(spec.fast_window),
            "slow_burn": self.burn_rate(spec.slow_window),
            "alerts": list(self._alerts),
            "floors": dict(self._floors),
            "breached": self.breached,
        }
