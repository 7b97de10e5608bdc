"""Anomaly flight recorder: a bounded ring buffer of per-batch serving
records, frozen to disk when something goes wrong (port of
``repro.obs.recorder``).

The latency histograms tell you *that* p99 moved; the flight
recorder tells you *what the pipeline was doing* around the batches that
moved it.  Per steady-state batch, a :class:`BatchRecord` captures the stage
span durations (joined from the tracer's events), the engine's dispatch
counter deltas, the latency sample, and optionally the live traffic state.
Records land in a fixed-capacity ring (old batches fall off), and the ring
is **dumped as one JSON context window** when:

* an SLO burn-rate alert fires (``repro_torch.obs.slo``), or
* a latency sample exceeds a robust MAD-based anomaly threshold:
  ``|x - median| > mad_k * 1.4826 * MAD`` over the history seen so far
  (median/MAD, not mean/stddev, so the threshold itself is not dragged by
  the outliers it is meant to catch).

Dumps are capped (``max_dumps``) so a persistently-burning session produces
a handful of windows, not thousands of files.  Everything here is host-side
and allocation-cheap; the recorder is only constructed when ``serve_rec``
runs with ``--flight-dir``/``--slo``/``--report``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os

import numpy as np

# scale factor making MAD a consistent sigma estimator for normal data
MAD_SIGMA = 1.4826


@dataclasses.dataclass
class BatchRecord:
    """One steady-state batch, as the flight recorder remembers it."""

    batch: int
    mode: str
    latency_s: float
    stages: dict                      # span name -> duration seconds
    counters: dict                    # counter name -> delta since last record
    traffic: dict | None = None      # optional live traffic state
    anomaly: bool = False            # set by the recorder on MAD breach

    def describe(self) -> dict:
        return {
            "batch": self.batch,
            "mode": self.mode,
            "latency_s": self.latency_s,
            "stages": {k: float(v) for k, v in self.stages.items()},
            "counters": {k: int(v) for k, v in self.counters.items()},
            "traffic": self.traffic,
            "anomaly": self.anomaly,
        }


class TelemetryJoin:
    """Incremental join of the tracer's span stream + the counter registry
    into per-batch records.

    Keeps a cursor into ``tracer.events`` (each event is consumed once, so a
    long session never rescans) and the last counter snapshot (so records
    carry *deltas* — e.g. ``engine/dispatch/serve_gather: 1`` per batch).
    Span durations are keyed by the ``batch=`` arg the serving loop already
    attaches; spans without one (offline/pack-tables) are ignored.
    """

    def __init__(self, tracer, registry):
        self._tracer = tracer
        self._registry = registry
        self._cursor = 0
        self._last_counters: dict[str, int] = {
            k: c.value for k, c in registry.counters.items()
        }
        self._pending: dict[int, dict] = {}    # batch id -> {stage: seconds}

    def _drain_events(self) -> None:
        events = self._tracer.events
        for ev in events[self._cursor:]:
            if ev.get("ph") != "X":
                continue
            batch = ev.get("args", {}).get("batch")
            if batch is None:
                continue
            stages = self._pending.setdefault(int(batch), {})
            # accumulate: a re-dispatched stage (retries) sums its spans
            stages[ev["name"]] = (
                stages.get(ev["name"], 0.0) + ev["dur"] * 1e-6
            )
        self._cursor = len(events)

    def counter_deltas(self) -> dict:
        now = {k: c.value for k, c in self._registry.counters.items()}
        delta = {
            k: v - self._last_counters.get(k, 0)
            for k, v in now.items()
            if v - self._last_counters.get(k, 0)
        }
        self._last_counters = now
        return delta

    def next_record(self, *, batch: int, mode: str, latency_s: float,
                    traffic: dict | None = None) -> BatchRecord:
        self._drain_events()
        stages = self._pending.pop(int(batch), {})
        # drop the wrapping "batch" span — its children are the breakdown
        stages.pop("batch", None)
        return BatchRecord(
            batch=int(batch), mode=mode, latency_s=float(latency_s),
            stages=stages, counters=self.counter_deltas(), traffic=traffic,
        )


class Observatory:
    """The per-session decision bundle: SLO engine + flight recorder + the
    telemetry join, driven once per steady-state batch.

    ``serve_rec`` installs one via ``obs.install_observatory`` when ``--slo``
    / ``--flight-dir`` / ``--report`` is passed; the serving loop then calls
    the ``obs.observe_batch`` facade (a bool check when telemetry is off).
    """

    def __init__(self, *, slo=None, recorder=None, join=None):
        self.slo = slo                    # repro_torch.obs.slo.SLOEngine | None
        self.recorder = recorder          # FlightRecorder | None
        self.join = join                  # TelemetryJoin | None

    def observe_batch(self, *, batch: int, mode: str, latency_s: float,
                      traffic: dict | None = None) -> dict:
        alerts = self.slo.observe(latency_s) if self.slo is not None else []
        record = dump = None
        if self.recorder is not None:
            if self.join is not None:
                record = self.join.next_record(
                    batch=batch, mode=mode, latency_s=latency_s,
                    traffic=traffic,
                )
            else:
                record = BatchRecord(batch=int(batch), mode=mode,
                                     latency_s=float(latency_s),
                                     stages={}, counters={}, traffic=traffic)
            dump = self.recorder.observe(record, alerts=alerts)
        return {"record": record, "alerts": alerts, "dump": dump}

    def state(self) -> dict:
        return {
            "slo": self.slo.state() if self.slo is not None else None,
            "flight_dumps": (self.recorder.dumps
                             if self.recorder is not None else []),
        }


class FlightRecorder:
    """Bounded ring of :class:`BatchRecord`s + dump-on-trigger logic.

    ``capacity`` bounds the ring (old records fall off); ``out_dir`` is where
    JSON context windows land; ``mad_k`` scales the robust anomaly threshold;
    ``min_history`` suppresses anomaly verdicts until enough latencies exist
    for the median/MAD to mean something; ``max_dumps`` caps files per
    session.
    """

    def __init__(self, capacity: int = 64, *, out_dir: str | None = None,
                 mad_k: float = 6.0, min_history: int = 8,
                 max_dumps: int = 4):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self.out_dir = out_dir
        self.mad_k = mad_k
        self.min_history = min_history
        self.max_dumps = max_dumps
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._latencies: list[float] = []
        self._dumps: list[dict] = []        # {"path", "reason", "at_batch"}

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def records(self) -> list[BatchRecord]:
        return list(self._ring)

    @property
    def dumps(self) -> list[dict]:
        return list(self._dumps)

    # -- anomaly threshold ---------------------------------------------------

    def anomaly_threshold(self) -> float | None:
        """Current MAD-based latency cutoff (None before ``min_history``)."""
        if len(self._latencies) < self.min_history:
            return None
        arr = np.asarray(self._latencies)
        med = float(np.median(arr))
        mad = float(np.median(np.abs(arr - med)))
        # MAD collapses to 0 on near-constant histories; fall back to a
        # relative band so a 2x step on a flat baseline still triggers.
        spread = max(MAD_SIGMA * mad, 0.05 * med, 1e-9)
        return med + self.mad_k * spread

    def _is_anomaly(self, latency_s: float) -> bool:
        cut = self.anomaly_threshold()
        return cut is not None and latency_s > cut

    # -- the per-batch entry ---------------------------------------------------

    def observe(self, record: BatchRecord, *, alerts: list | tuple = ()
                ) -> dict | None:
        """Append one record; dump the ring when an SLO alert accompanied it
        or its latency breached the MAD threshold.  Returns the dump info
        dict (``{"path", "reason", ...}``) when a dump was written.

        The anomaly verdict uses the history *before* this record, so the
        triggering batch is judged against its past, then appended.
        """
        record.anomaly = self._is_anomaly(record.latency_s)
        self._ring.append(record)
        self._latencies.append(record.latency_s)
        reason = None
        if alerts:
            sev = sorted({a.get("severity", "alert") for a in alerts})
            reason = "slo_burn:" + "+".join(sev)
        elif record.anomaly:
            reason = "latency_anomaly"
        if reason is None:
            return None
        return self.dump(reason, context={
            "trigger_batch": record.batch,
            "trigger_latency_s": record.latency_s,
            "anomaly_threshold_s": self.anomaly_threshold(),
            "alerts": list(alerts),
        })

    # -- freezing ------------------------------------------------------------

    def to_json(self, reason: str, context: dict | None = None) -> dict:
        return {
            "reason": reason,
            "capacity": self.capacity,
            "mad_k": self.mad_k,
            "context": context or {},
            "records": [r.describe() for r in self._ring],
        }

    def dump(self, reason: str, context: dict | None = None) -> dict | None:
        """Freeze the ring to ``out_dir`` (None = record the dump in memory
        only).  Returns dump info, or None once ``max_dumps`` is exhausted."""
        if len(self._dumps) >= self.max_dumps:
            return None
        seq = len(self._dumps)
        info = {"reason": reason, "records": len(self._ring),
                "trigger_batch": (context or {}).get("trigger_batch")}
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, f"flight_{seq:03d}.json")
            with open(path, "w") as f:
                json.dump(self.to_json(reason, context), f, indent=1)
            info["path"] = path
        self._dumps.append(info)
        return info
