"""Deterministic fault injection for the serving front end (port of
``repro.serve.faults``).

Chaos testing only pays off when a failure reproduces: every fault here is a
:class:`FaultEvent` pinned to a **virtual** timestamp, so the same spec +
seed produces the same outage at the same batch on any host.  Four fault
kinds cover the pipeline's distinct failure surfaces:

* ``stall``    — the dispatch path freezes for ``duration_s`` virtual
  seconds (a straggling device, a preempted host thread).  Consumed by the
  front end as extra service time on the next dispatched batch.
* ``drop``     — the prefetch staging for the next batch is lost (a missed
  staging window); the cache serves stale residency, so hit rate degrades but
  nothing crashes.
* ``replica``  — a model-parallel replica goes silent for ``duration_s``:
  its heartbeat (:class:`repro_torch.distributed.elastic.Heartbeat`, driven on
  this injector's virtual clock) stops, the front end sees
  ``replica_lost()`` once the watermark stalls past the detection deadline,
  and the degradation ladder is forced off the sharded path until the
  replica beats again.
* ``gather``   — the next ``count`` gather dispatches raise
  :class:`TransientGatherError` (a flaky interconnect read); the front end
  retries with exponential backoff and abandons the batch when retries
  exhaust.

The injector is advanced by the front end (``advance(now)``) before every
dispatch; faults whose time has come latch into pending state and are
consumed exactly once.
"""

from __future__ import annotations

import dataclasses

from repro_torch.distributed.elastic import Heartbeat

KINDS = ("stall", "drop", "replica", "gather")


class TransientGatherError(RuntimeError):
    """A retryable failure of one packed-gather dispatch."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault at a virtual timestamp."""

    t_s: float
    kind: str                       # stall | drop | replica | gather
    duration_s: float = 0.0         # stall length / replica outage
    count: int = 1                  # gather: consecutive failing dispatches
    host: int = 1                   # replica: which host goes silent

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (known: {KINDS})")

    def describe(self) -> dict:
        return {
            "t_s": self.t_s, "kind": self.kind,
            "duration_s": self.duration_s, "count": self.count,
            "host": self.host,
        }


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic fault schedule plus the retry policy."""

    events: tuple[FaultEvent, ...] = ()
    max_retries: int = 3
    backoff_base_s: float = 0.005    # virtual seconds before retry 1
    backoff_factor: float = 2.0
    hosts: int = 4                   # replica fleet size the heartbeat tracks
    hb_deadline_s: float = 0.05      # heartbeat stall -> failure detection

    def backoff_s(self, attempt: int) -> float:
        """Virtual backoff before retry ``attempt`` (0-based)."""
        return self.backoff_base_s * self.backoff_factor ** attempt

    def describe(self) -> dict:
        return {
            "events": [e.describe() for e in self.events],
            "max_retries": self.max_retries,
            "backoff_base_s": self.backoff_base_s,
            "backoff_factor": self.backoff_factor,
            "hosts": self.hosts,
            "hb_deadline_s": self.hb_deadline_s,
        }

    # -- CLI form -------------------------------------------------------------

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        """Parse the ``--faults`` form:
        ``"stall@1.0:0.5,drop@1.5,replica@2.0:1.0,gather@3.0:2,retries=3"``.

        ``KIND@T[:X]`` — X is seconds for stall/replica, a dispatch count
        for gather, ignored for drop.  ``retries=N`` / ``backoff_ms=M`` /
        ``hosts=H`` set the policy fields.
        """
        events: list[FaultEvent] = []
        kw: dict = {}
        for tok in filter(None, (t.strip() for t in text.split(","))):
            if "=" in tok and "@" not in tok:
                k, v = (s.strip() for s in tok.split("=", 1))
                if k == "retries":
                    kw["max_retries"] = int(v)
                elif k == "backoff_ms":
                    kw["backoff_base_s"] = float(v) * 1e-3
                elif k == "hosts":
                    kw["hosts"] = int(v)
                elif k == "hb_deadline_ms":
                    kw["hb_deadline_s"] = float(v) * 1e-3
                else:
                    raise ValueError(f"unknown --faults key {k!r}")
                continue
            if "@" not in tok:
                raise ValueError(f"bad --faults token {tok!r} (want KIND@T[:X])")
            kind, rest = tok.split("@", 1)
            t_s, _, x = rest.partition(":")
            ev = {"t_s": float(t_s), "kind": kind.strip()}
            if x:
                if kind.strip() == "gather":
                    ev["count"] = int(x)
                else:
                    ev["duration_s"] = float(x)
            events.append(FaultEvent(**ev))
        events.sort(key=lambda e: e.t_s)
        return cls(events=tuple(events), **kw)


class FaultInjector:
    """Replays a :class:`FaultSpec` on the front end's virtual clock.

    ``advance(now)`` latches every event whose time has come; the front end
    then consumes pending faults exactly once per dispatch.  Replica loss is
    realized through a real :class:`Heartbeat` (injected virtual clock): the
    lost host simply stops beating, and detection falls out of the same
    watermark logic production uses — nothing here fakes the failure signal.
    """

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._events = sorted(spec.events, key=lambda e: e.t_s)
        self._cursor = 0
        self.now_s = 0.0
        self._pending_stall_s = 0.0
        self._pending_drops = 0
        self._pending_gather_errors = 0
        # outages: host -> virtual end time; the host beats again after it
        self._outages: dict[int, float] = {}
        self.heartbeat = Heartbeat(
            deadline_s=spec.hb_deadline_s, clock=lambda: self.now_s
        )
        for h in range(spec.hosts):
            self.heartbeat.beat(h, step=0, now=0.0)
        self._step = 0
        self.injected: list[dict] = []   # every latched event, with latch time

    # -- clock ----------------------------------------------------------------

    def advance(self, now_s: float) -> list[FaultEvent]:
        """Move the virtual clock forward; latch and return due events."""
        self.now_s = max(self.now_s, float(now_s))
        due: list[FaultEvent] = []
        while (self._cursor < len(self._events)
               and self._events[self._cursor].t_s <= self.now_s):
            ev = self._events[self._cursor]
            self._cursor += 1
            due.append(ev)
            self.injected.append({**ev.describe(), "latched_at_s": self.now_s})
            if ev.kind == "stall":
                self._pending_stall_s += ev.duration_s
            elif ev.kind == "drop":
                self._pending_drops += 1
            elif ev.kind == "gather":
                self._pending_gather_errors += ev.count
            elif ev.kind == "replica":
                self._outages[ev.host] = max(
                    self._outages.get(ev.host, 0.0), ev.t_s + ev.duration_s
                )
        # every host outside an outage window beats; outage hosts go silent
        self._step += 1
        for h in range(self.spec.hosts):
            end = self._outages.get(h)
            if end is not None and self.now_s < end:
                continue
            if end is not None:
                del self._outages[h]     # outage over: the host beats again
            self.heartbeat.beat(h, step=self._step)
        return due

    # -- consumption (each exactly once) ---------------------------------------

    def consume_stall_s(self) -> float:
        """Pending dispatch-stall seconds; zero after consumption."""
        s, self._pending_stall_s = self._pending_stall_s, 0.0
        return s

    def consume_prefetch_drop(self) -> bool:
        """True when the next prefetch should be dropped (consumes one)."""
        if self._pending_drops > 0:
            self._pending_drops -= 1
            return True
        return False

    def check_gather(self) -> None:
        """Raise :class:`TransientGatherError` while armed errors remain."""
        if self._pending_gather_errors > 0:
            self._pending_gather_errors -= 1
            raise TransientGatherError(
                f"injected transient gather failure at t={self.now_s:.3f}s "
                f"({self._pending_gather_errors} more armed)"
            )

    def replica_lost(self) -> bool:
        """True while any replica's heartbeat watermark is stalled."""
        return bool(self.heartbeat.failed_hosts())

    def lost_hosts(self) -> list[int]:
        return self.heartbeat.failed_hosts()

    def exhausted(self) -> bool:
        """True once every scheduled event has latched."""
        return self._cursor >= len(self._events)
