"""Nestable span recorder emitting Chrome-trace / Perfetto JSON (port of
``repro.obs.tracer``).

Records the serving pipeline's stage structure — pack -> host-to-device ->
megakernel dispatch -> device compute -> interaction head — as *complete*
("ph": "X") events that ``chrome://tracing`` and https://ui.perfetto.dev load
directly.  Nesting needs no explicit parent links: the Trace Event Format
reconstructs the flame from [ts, ts+dur) containment per (pid, tid), and the
recorder keeps a thread-local stack only so each event can also carry its
depth in ``args`` (handy for tests and offline tools).

CUDA launches are asynchronous, so a span around a launch measures
*enqueue* cost unless the caller fences; the serving loop fences each
device stage with ``torch.cuda.synchronize`` when tracing is requested
(``serve_rec --trace-out``), trading pipeline overlap for honest per-stage
durations — the Chrome trace documents a *fenced* run.

Timestamps are microseconds from the tracer's construction (``perf_counter``
based), matching the format's expectation of monotonic us.
"""

from __future__ import annotations

import json
import os
import threading
import time


class _Span:
    """Context manager for one complete event (allocated only when enabled)."""

    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter()
        self.tracer._stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        stack = self.tracer._stack()
        depth = len(stack) - 1
        if stack and stack[-1] is self:
            stack.pop()
        tr = self.tracer
        args = {"depth": depth}
        if self.args:
            args.update(self.args)
        tr.events.append({
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self.t0 - tr.origin) * 1e6,
            "dur": (t1 - self.t0) * 1e6,
            "pid": tr.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args,
        })
        return False


class Tracer:
    """Append-only event buffer + span factory for one process."""

    def __init__(self):
        self.pid = os.getpid()
        self.origin = time.perf_counter()
        self.events: list[dict] = []
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def reset(self) -> None:
        self.origin = time.perf_counter()
        self.events.clear()

    def span(self, name: str, cat: str = "serve", args: dict | None = None
             ) -> _Span:
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve",
                args: dict | None = None) -> None:
        self.events.append({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (time.perf_counter() - self.origin) * 1e6,
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": args or {},
        })

    def counter(self, name: str, values: dict) -> None:
        """Chrome counter-track sample ("ph": "C") — e.g. cache hit rate."""
        self.events.append({
            "name": name, "cat": "metrics", "ph": "C",
            "ts": (time.perf_counter() - self.origin) * 1e6,
            "pid": self.pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": {k: float(v) for k, v in values.items()},
        })

    def to_chrome(self, *, metadata: dict | None = None) -> dict:
        """The JSON object ``chrome://tracing`` / Perfetto load."""
        events = [
            {
                "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
                "args": {"name": "repro_torch.serve"},
            },
        ] + self.events
        out = {"traceEvents": events, "displayTimeUnit": "ms"}
        if metadata:
            out["otherData"] = metadata
        return out

    def write(self, path: str, *, metadata: dict | None = None) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(metadata=metadata), f, indent=1)
