"""Counters, gauges, and log-bucketed latency histograms — numpy only (port
of ``repro.obs.metrics``, unchanged).

The serving claims this repo makes are *distribution* claims (p99 latency
under Zipf traffic, traffic reduction per batch), so the primitive here is a
histogram, not a scalar.  Design points:

* **log-bucketed**: latency spans ~6 decades (us kernel dispatch to seconds
  of compile); bucket bounds are geometric (``buckets_per_decade`` per x10)
  so relative resolution is constant across the range;
* **exact quantiles**: every recorded value is also retained verbatim (a
  serving session records one value per batch — thousands, not billions), so
  ``percentile(q)`` is ``numpy.percentile`` over the raw samples, and the
  bucket counts are a lossy *view* for dashboards/merging, never the source
  of truth.  ``bucket_percentile`` is the interpolated fallback used after a
  merge discards samples (``drop_samples=True``);
* **mergeable snapshots**: per-shard / per-process registries snapshot into
  plain dataclasses that merge associatively (counters add, histograms
  concatenate), so a fleet's metrics reduce like the psum tree they measure.

Everything is host-side and dependency-free (numpy only); the module-level
enable/disable switch lives in ``repro_torch.obs`` — when disabled, the facade
never touches these classes at all.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# default bucket range: 1us .. 1000s, 5 buckets per decade (~58% ratio steps)
DEFAULT_LO = 1e-6
DEFAULT_HI = 1e3
DEFAULT_PER_DECADE = 5


def log_bounds(
    lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
    per_decade: int = DEFAULT_PER_DECADE,
) -> np.ndarray:
    """Geometric bucket bounds covering [lo, hi] (len = buckets + 1)."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi}/{per_decade}")
    decades = np.log10(hi / lo)
    n = int(np.ceil(decades * per_decade))
    return lo * 10.0 ** (np.arange(n + 1) / per_decade)


def exact_percentile(samples, q: float) -> float:
    """THE exact-quantile definition every serving number in this repo uses:
    ``numpy.percentile`` over raw samples, 0.0 when empty.  ``Histogram``,
    ``HistogramSnapshot``, and ``serve_rec``'s result records all route
    through here, so a histogram snapshot and a serving record computed from
    the same samples can never disagree."""
    samples = np.asarray(samples, dtype=np.float64)
    if samples.size == 0:
        return 0.0
    return float(np.percentile(samples, q))


def latency_percentiles(samples, qs=(50, 95, 99)) -> dict:
    """The serving-record percentile keys (``lat_p50_s``...) from raw
    per-batch latency samples — the shared form of ``serve_rec`` results and
    benchmark rows."""
    return {f"lat_p{q:g}_s": exact_percentile(samples, q) for q in qs}


def bucketize(samples: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Per-bucket counts; under/overflowing samples clip to the edge buckets."""
    samples = np.asarray(samples, dtype=np.float64)
    idx = np.searchsorted(bounds, samples, side="right") - 1
    idx = np.clip(idx, 0, len(bounds) - 2)
    return np.bincount(idx, minlength=len(bounds) - 1).astype(np.int64)


@dataclasses.dataclass
class CounterSnapshot:
    name: str
    value: int

    def merge(self, other: "CounterSnapshot") -> "CounterSnapshot":
        if other.name != self.name:
            raise ValueError(f"merging {other.name} into {self.name}")
        return CounterSnapshot(self.name, self.value + other.value)


@dataclasses.dataclass
class HistogramSnapshot:
    """Frozen view of a histogram: bucket counts + (optionally) raw samples."""

    name: str
    unit: str
    bounds: np.ndarray                  # (buckets + 1,) bucket edges
    counts: np.ndarray                  # (buckets,) int64
    samples: np.ndarray                 # raw values; empty after a lossy merge

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def percentile(self, q: float) -> float:
        """Exact when samples are retained; bucket-interpolated otherwise."""
        if self.samples.size:
            return exact_percentile(self.samples, q)
        return self.bucket_percentile(q)

    def bucket_percentile(self, q: float) -> float:
        """Quantile from bucket counts alone (log-linear within the bucket)."""
        total = self.count
        if total == 0:
            return 0.0
        target = q / 100.0 * total
        cum = np.cumsum(self.counts)
        b = int(np.searchsorted(cum, max(target, 1e-12)))
        b = min(b, len(self.counts) - 1)
        prev = cum[b - 1] if b > 0 else 0
        frac = (target - prev) / max(1, self.counts[b])
        lo, hi = self.bounds[b], self.bounds[b + 1]
        return float(lo * (hi / lo) ** min(max(frac, 0.0), 1.0))

    def merge(self, other: "HistogramSnapshot", *, drop_samples: bool = False
              ) -> "HistogramSnapshot":
        if other.bounds.shape != self.bounds.shape or not np.allclose(
            other.bounds, self.bounds
        ):
            raise ValueError("cannot merge histograms with different buckets")
        both = (self.samples.size or not self.counts.sum()) and (
            other.samples.size or not other.counts.sum()
        )
        samples = (
            np.concatenate([self.samples, other.samples])
            if both and not drop_samples else np.empty(0)
        )
        return HistogramSnapshot(
            name=self.name, unit=self.unit, bounds=self.bounds,
            counts=self.counts + other.counts, samples=samples,
        )

    def describe(self) -> dict:
        """JSON-ready summary (the metrics-artifact form)."""
        out = {
            "unit": self.unit,
            "count": self.count,
            "sum": float(self.samples.sum()) if self.samples.size else None,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "min": float(self.samples.min()) if self.samples.size else None,
            "max": float(self.samples.max()) if self.samples.size else None,
            "mean": float(self.samples.mean()) if self.samples.size else None,
            # sparse bucket view: [bucket_low_bound, count], nonzero only
            "buckets": [
                [float(self.bounds[i]), int(c)]
                for i, c in enumerate(self.counts) if c
            ],
        }
        return out


class Counter:
    """Monotonic event counter (dispatches, batches, cache misses...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def snapshot(self) -> CounterSnapshot:
        return CounterSnapshot(self.name, self.value)


class Gauge:
    """Last-write-wins instantaneous value (queue depth, resident rows...)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Recording half of :class:`HistogramSnapshot` — append-only, O(1)."""

    __slots__ = ("name", "unit", "bounds", "_samples")

    def __init__(self, name: str, unit: str = "s",
                 bounds: np.ndarray | None = None):
        self.name = name
        self.unit = unit
        self.bounds = log_bounds() if bounds is None else np.asarray(bounds)
        self._samples: list[float] = []

    def record(self, value: float) -> None:
        self._samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self._samples)

    def percentile(self, q: float) -> float:
        return exact_percentile(self._samples, q)

    def snapshot(self) -> HistogramSnapshot:
        samples = np.asarray(self._samples, dtype=np.float64)
        return HistogramSnapshot(
            name=self.name, unit=self.unit, bounds=self.bounds,
            counts=bucketize(samples, self.bounds), samples=samples,
        )


@dataclasses.dataclass
class RegistrySnapshot:
    """Mergeable, JSON-serializable freeze of one registry."""

    counters: dict                      # name -> int
    gauges: dict                        # name -> float
    histograms: dict                    # name -> HistogramSnapshot
    info: dict                          # attached static payloads (plan summary)

    def merge(self, other: "RegistrySnapshot") -> "RegistrySnapshot":
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0) + v
        gauges = {**self.gauges, **other.gauges}
        hists = dict(self.histograms)
        for k, h in other.histograms.items():
            hists[k] = hists[k].merge(h) if k in hists else h
        return RegistrySnapshot(
            counters=counters, gauges=gauges, histograms=hists,
            info={**self.info, **other.info},
        )

    def to_json(self) -> dict:
        return {
            "counters": dict(sorted(self.counters.items())),
            "gauges": dict(sorted(self.gauges.items())),
            "histograms": {
                k: h.describe() for k, h in sorted(self.histograms.items())
            },
            "info": self.info,
        }


class MetricRegistry:
    """Named metric store: get-or-create accessors, one snapshot per freeze."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.info: dict = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, unit: str = "s",
                  bounds: np.ndarray | None = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, unit, bounds)
        return h

    def attach(self, key: str, value) -> None:
        """Attach a static JSON-able payload (e.g. the plan summary)."""
        self.info[key] = value

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self.info.clear()

    def snapshot(self) -> RegistrySnapshot:
        return RegistrySnapshot(
            counters={k: c.value for k, c in self.counters.items()},
            gauges={k: g.value for k, g in self.gauges.items()},
            histograms={k: h.snapshot() for k, h in self.histograms.items()},
            info=dict(self.info),
        )
