"""Fault-tolerance runtime policies (port of ``repro.distributed.elastic``,
so far only its :class:`Heartbeat`).

* **Failure detection** — `Heartbeat` tracks per-host progress watermarks; a
  watermark that stalls past the deadline marks the host failed.  The
  serving fault harness (``repro_torch.serve.faults``) drives it on its
  virtual clock.

The re-mesh and cross-pod policies come with the sharded slice.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Heartbeat:
    """Progress watermarks per host; a stalled watermark marks a failure.

    In a real deployment the watermark store is etcd/GCS; here it is an
    in-process dict with the same semantics, exercised by tests and the
    serving fault harness (``repro_torch.serve.faults``).

    ``clock`` is injectable (defaults to ``time.monotonic``) so tests and the
    fault harness can drive the watermarks on a virtual clock; per-call
    ``now=`` overrides still win.  A host may be :meth:`register`-ed before
    its first beat — such an *empty-beat* host counts as stalled once the
    deadline passes its registration time, and holds :meth:`min_step` at 0
    (it has proven no progress), instead of being invisible.
    """

    deadline_s: float = 300.0
    marks: dict = dataclasses.field(default_factory=dict)
    clock: "object" = time.monotonic          # () -> float, injectable

    def _now(self, now: float | None) -> float:
        return self.clock() if now is None else now

    def register(self, host: int, now: float | None = None) -> None:
        """Declare a host expected to beat (step ``None`` until it does).

        Without registration a host that dies before its first beat is
        invisible to :meth:`failed_hosts`; registering starts its deadline
        clock immediately.  Re-registering a beating host is a no-op.
        """
        if host not in self.marks:
            self.marks[host] = (None, self._now(now))

    def beat(self, host: int, step: int, now: float | None = None) -> None:
        self.marks[host] = (int(step), self._now(now))

    def failed_hosts(self, now: float | None = None) -> list[int]:
        """Hosts whose last beat (or registration) stalled past the deadline."""
        now = self._now(now)
        return [h for h, (_, t) in self.marks.items() if now - t > self.deadline_s]

    def min_step(self) -> int:
        """The fleet's progress watermark: the smallest step any known host
        has proven.  Empty-beat (registered, never beat) hosts pin it at 0;
        no hosts at all is also 0."""
        steps = [s for s, _ in self.marks.values()]
        if any(s is None for s in steps):
            return 0
        return min(steps, default=0)

    def alive_hosts(self, now: float | None = None) -> list[int]:
        """Complement of :meth:`failed_hosts` over the known hosts."""
        failed = set(self.failed_hosts(now))
        return [h for h in self.marks if h not in failed]
