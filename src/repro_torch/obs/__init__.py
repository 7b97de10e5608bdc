"""repro_torch.obs — low-overhead metrics + tracing for the serving pipeline
(port of ``repro.obs``; numpy and the standard library only).

One module-level switch gates everything:

* ``obs.enable()`` / ``obs.disable()`` — flip telemetry for the process;
  ``serve_rec`` enables it when ``--metrics-json`` / ``--trace-out`` /
  ``--slo`` / ``--report`` / ``--flight-dir`` is passed, benchmarks and
  ``chip_smoke.py``'s QPS runs leave it off.
* When **disabled** (the default), every facade call is a branch on a module
  bool and an immediate return — no counters, histograms, spans, or dicts
  are allocated, so instrumented hot paths cost nothing measurable
  (``tests/test_torch_obs.py`` asserts the disabled path records nothing and
  ``span`` returns a shared singleton).
* When **enabled**, calls route to one process-global
  :class:`~repro_torch.obs.metrics.MetricRegistry` and
  :class:`~repro_torch.obs.tracer.Tracer`.

Instrumentation points call the facade (``obs.inc``, ``obs.observe``,
``obs.span``, ``obs.attach``) rather than holding metric objects, so the
engine/serving code carries no telemetry state of its own.  Counters are
host-side: the engine bumps them at its dispatch sites, one per call.

Submodules: ``metrics`` (counters/gauges/log-bucket histograms + mergeable
snapshots), ``tracer`` (Chrome-trace spans), ``traffic`` (per-batch HBM/comm
byte accounting), ``drift`` (cost-model residual monitoring), plus the
observatory decision layer: ``slo`` (error budgets + multi-window burn-rate
alerts), ``recorder`` (anomaly flight recorder), ``attribution`` (per-stage
roofline attribution), ``report`` (the serving-report artifact).
"""

from __future__ import annotations

from repro_torch.obs.metrics import (  # noqa: F401 (re-exports)
    Counter, Gauge, Histogram, HistogramSnapshot, MetricRegistry,
    RegistrySnapshot, latency_percentiles,
)
from repro_torch.obs.tracer import Tracer
from repro_torch.obs.drift import DriftMonitor, rank_agreement  # noqa: F401
from repro_torch.obs.slo import SLOEngine, SLOSpec  # noqa: F401
from repro_torch.obs.recorder import (  # noqa: F401
    BatchRecord, FlightRecorder, Observatory, TelemetryJoin,
)

_enabled = False
_registry = MetricRegistry()
_tracer = Tracer()
_observatory: Observatory | None = None


class _NullSpan:
    """Reentrant no-op context manager — the disabled path's shared span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


def enable(*, reset: bool = True) -> None:
    """Turn telemetry on (optionally wiping previously recorded state)."""
    global _enabled
    if reset:
        _registry.reset()
        _tracer.reset()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def registry() -> MetricRegistry:
    return _registry


def tracer() -> Tracer:
    return _tracer


# -- facade: each call is one bool check when disabled -----------------------

def inc(name: str, n: int = 1) -> None:
    if _enabled:
        _registry.counter(name).inc(n)


def observe(name: str, value: float, unit: str = "s") -> None:
    if _enabled:
        _registry.histogram(name, unit).record(value)


def set_gauge(name: str, value: float) -> None:
    if _enabled:
        _registry.gauge(name).set(value)


def attach(key: str, value) -> None:
    if _enabled:
        _registry.attach(key, value)


def span(name: str, cat: str = "serve", **args):
    if _enabled:
        return _tracer.span(name, cat, args or None)
    return NULL_SPAN


def instant(name: str, cat: str = "serve", **args) -> None:
    if _enabled:
        _tracer.instant(name, cat, args or None)


def trace_counter(name: str, **values) -> None:
    if _enabled:
        _tracer.counter(name, values)


def snapshot() -> RegistrySnapshot:
    return _registry.snapshot()


# -- observatory: SLO + flight recorder, driven per steady-state batch --------

def install_observatory(*, slo: SLOEngine | None = None,
                        recorder: FlightRecorder | None = None
                        ) -> Observatory | None:
    """Install (or clear, with no arguments) the process observatory.

    Call AFTER :func:`enable` — the telemetry join keeps cursors into the
    live tracer/registry, so a later ``enable(reset=True)`` invalidates it.
    """
    global _observatory
    if slo is None and recorder is None:
        _observatory = None
        return None
    _observatory = Observatory(
        slo=slo, recorder=recorder,
        join=TelemetryJoin(_tracer, _registry),
    )
    return _observatory


def observatory() -> Observatory | None:
    return _observatory


def observe_batch(*, batch: int, mode: str, latency_s: float,
                  traffic: dict | None = None) -> dict | None:
    """Facade for the serving loop: one bool check when telemetry is off (or
    no observatory is installed); otherwise feeds the SLO engine + flight
    recorder and returns ``{"record", "alerts", "dump"}``."""
    if _enabled and _observatory is not None:
        return _observatory.observe_batch(
            batch=batch, mode=mode, latency_s=latency_s, traffic=traffic,
        )
    return None
