"""Trace-driven autotuner: profile -> fit cost model -> choose plan knobs
(port of ``repro.tune.tuner``).

A short profiled trace is distilled into a :class:`TraceProfile`; observed
latencies of candidate knob settings fit the per-backend linear
:class:`~repro_torch.tune.cost_model.KernelCostModel`; and
``plan(spec, trace, tuner=fit(...))`` ranks the whole knob space by
predicted latency and freezes the argmin into the ``EmbeddingPlan``.

Two observation sources:

* ``mode="measure"`` — timed runs of the real execution paths on the card
  (the packed ``serve_gather`` kernel under a live prefetch schedule, or the
  ``lookup`` entry), at two batch sizes so the per-byte and per-dispatch
  terms separate; CUDA events around each call, the median of ``repeats``;
* ``mode="analytic"`` — no card needed: the same plan and the same batch as
  a measured sample, its host side (prefetch, ``slots_for``) run on the
  CPU, and the unique bytes the packed kernel reads and writes for that
  batch (index and slot streams, cache block, missed big-subtable rows,
  small-subtable rows, output) and its flops priced at the card's
  constants (``launch/mesh.py``), plus a measured launch overhead per
  dispatch.  It stands where ``repro``'s ``hlo`` mode lowers the jnp
  oracle through XLA, which has no PyTorch counterpart.

``mode="auto"`` measures on the card and prices analytically on the CPU.
Fits are memoized to a JSON cache keyed by (spec digest, device kind,
source) with host metadata recorded per entry, so a fit from one device is
never served to another.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.cache import duplication, intra_gnr, sram_cache
from repro_torch.launch.mesh import DISPATCH_OVERHEAD_S
from repro_torch.tune.cost_model import (
    FEATURES, CostSample, KernelCostModel, fit_cost_model, plan_features,
)
from repro_torch.tune.knobs import Knobs, default_knobs, knob_space

MODES = ("auto", "measure", "analytic")


def spec_digest(spec) -> str:
    """Stable (cross-process) digest of a spec — the tuner-cache key half.

    ``hash(spec)`` is salted per interpreter, so the JSON cache keys on a
    sha1 of the spec's repr instead (frozen dataclasses repr
    deterministically)."""
    return hashlib.sha1(repr(spec).encode()).hexdigest()[:16]


def device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``"cpu"``.
    ``None`` names the card when one is present."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def run_metadata(device=None) -> dict:
    """Host/backend identity recorded on tuner-cache entries, so entries are
    comparable across machines."""
    kind = device_kind(device)
    return {
        "backend": "cpu" if kind == "cpu" else "cuda",
        "device_kind": kind,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }


def _bag_shaped(trace: np.ndarray, pooling: int) -> np.ndarray:
    trace = np.asarray(trace)
    if trace.ndim == 2:
        return trace
    n = trace.size - trace.size % pooling
    return trace[:n].reshape(-1, pooling)


_BIG_NAME = {"qr": "q", "tt": "g2"}


# ---------------------------------------------------------------------------
# trace profile: everything the cost model needs, distilled once per trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TableProfile:
    """Per-table distillation of the profiled trace."""

    rows: int                    # big-subtable row count
    row_bytes: int
    width_elems: int
    accesses_per_batch: float    # big-subtable fetches per serving batch
    counts: np.ndarray           # logical-row access profile (dup planning)
    values: np.ndarray           # analyzer prefetch values (slot waterfill)
    batches: list                # per-batch big-row streams (hit simulation)


class TraceProfile:
    """Workload statistics the feature computation reads.

    Hit-rate/staging curves are simulated lazily per (table, slot budget) on
    a bounded batch sample; duplication outcomes are re-planned lazily per
    candidate byte budget.  Both are memoized — the knob space revisits the
    same budgets many times.
    """

    def __init__(self, tables: list[TableProfile], *, batch: int,
                 num_shards: int, dim: int):
        self.tables = tables
        self.batch = batch
        self.num_shards = num_shards
        self.dim = dim
        self._hit_memo: dict = {}
        self._comm_memo: dict = {}
        self._bags = None

    @classmethod
    def from_trace(cls, spec, trace: Sequence[np.ndarray], *, batch: int = 32,
                   num_shards: int = 1, max_batches: int = 8) -> "TraceProfile":
        from repro_torch.core import placement

        if len(trace) != spec.num_tables:
            raise ValueError(
                f"need one trace per table: {len(trace)} vs {spec.num_tables}"
            )
        tables = []
        for bag, tr in zip(spec.bags, trace):
            emb = bag.emb
            shaped = _bag_shaped(tr, bag.pooling)
            big = _BIG_NAME.get(emb.kind, "table")
            big_trace, rows, row_bytes = intra_gnr.subtable_traces(
                shaped, emb
            )[big]
            loc = intra_gnr.analyze_bags(big_trace, rows, row_bytes=row_bytes)
            counts = placement.profile_counts(shaped.reshape(-1), emb.vocab)
            n_batches = min(max_batches, max(1, big_trace.shape[0] // batch))
            batches = [
                big_trace[i * batch: (i + 1) * batch] for i in range(n_batches)
            ]
            tables.append(TableProfile(
                rows=rows,
                row_bytes=row_bytes,
                width_elems=row_bytes // 4,
                accesses_per_batch=float(batch * shaped.shape[1]),
                counts=counts,
                values=loc.prefetch_value().astype(np.float64),
                batches=batches,
            ))
        prof = cls(tables, batch=batch, num_shards=num_shards,
                   dim=spec.bags[0].emb.dim)
        prof._bags = list(spec.bags)
        return prof

    def hit_stats(self, t: int, slots: int) -> tuple[float, float]:
        """(hit rate, staged rows/batch) of table ``t`` at a slot budget."""
        key = (t, int(slots))
        if key not in self._hit_memo:
            tp = self.tables[t]
            if slots <= 0 or not tp.batches:
                self._hit_memo[key] = (0.0, 0.0)
            else:
                stats = sram_cache.simulate(
                    tp.batches, tp.rows, int(slots), tp.values
                )
                self._hit_memo[key] = (stats.hit_rate, stats.staged_per_batch)
        return self._hit_memo[key]

    def comm_bytes(self, spec, dup_budget_bytes: int) -> float:
        """Modeled cross-shard combine bytes per batch under a dup budget."""
        n = self.num_shards
        if n <= 1:
            return 0.0
        key = int(dup_budget_bytes)
        if key not in self._comm_memo:
            num_t = len(self.tables)
            if key <= 0:
                not_free = num_t
            else:
                dplan = duplication.plan_duplication(
                    self._bags or list(spec.bags),
                    [tp.counts for tp in self.tables],
                    num_shards=n, budget_bytes=key,
                )
                not_free = sum(1 for t in dplan.tables if not t.comm_free)
            vec = self.dim * 4
            self._comm_memo[key] = (
                self.batch * not_free * vec * (n - 1) / max(1, n)
            )
        return self._comm_memo[key]


# ---------------------------------------------------------------------------
# the tuner object plan() consumes
# ---------------------------------------------------------------------------

def _packable(spec) -> bool:
    from repro_torch.core import packed_tables

    return packed_tables.packable(spec.bags)


@dataclasses.dataclass
class Tuner:
    """Fitted cost models + the profile they were fitted against."""

    models: dict                      # backend -> KernelCostModel
    profile: TraceProfile | None
    source: str                       # measure | analytic
    metadata: dict
    samples: list = dataclasses.field(default_factory=list)
    digest: str = ""
    from_cache: bool = False

    def predict(self, spec, knobs: Knobs, *, profile: TraceProfile | None = None
                ) -> float:
        profile = profile or self.profile
        if profile is None:
            raise ValueError("tuner has no trace profile; pass profile=")
        model = self.models.get(knobs.backend)
        if model is None:
            model = next(iter(self.models.values()))
        return model.predict(plan_features(spec, knobs, profile))

    def rank(self, spec, *, packable: bool | None = None,
             backend: str | None = None,
             profile: TraceProfile | None = None) -> list:
        """Knob space ordered by predicted latency: [(knobs, seconds), ...]."""
        if packable is None:
            packable = _packable(spec)
        space = knob_space(spec, packable=packable)
        if backend is not None:
            space = tuple(k for k in space if k.backend == backend) or space
        scored = [(k, self.predict(spec, k, profile=profile)) for k in space]
        scored.sort(key=lambda kp: kp[1])
        return scored

    def choose(self, spec, *, packable: bool | None = None,
               backend: str | None = None,
               profile: TraceProfile | None = None,
               tie_rel: float = 0.02) -> Knobs:
        """Argmin-predicted-latency knobs, with near-ties (within ``tie_rel``)
        resolved toward the heuristic default — the tuner only moves a knob
        when the model predicts a real win."""
        if packable is None:
            packable = _packable(spec)
        ranked = self.rank(spec, packable=packable, backend=backend,
                           profile=profile)
        best_k, best_p = ranked[0]
        default = default_knobs(spec, packable=packable)
        if backend is not None and default.backend != backend:
            return best_k
        d_pred = self.predict(spec, default, profile=profile)
        if d_pred <= best_p * (1.0 + tie_rel):
            return default
        return best_k

    def describe(self) -> dict:
        """JSON form — the memo-cache entry."""
        return {
            "metadata": self.metadata,
            "source": self.source,
            "spec_digest": self.digest,
            "models": {b: m.describe() for b, m in self.models.items()},
            "samples": [s.describe() for s in self.samples],
        }


# ---------------------------------------------------------------------------
# observation: timed runs on the card / analytic bytes of a sampled batch
# ---------------------------------------------------------------------------

def _time_call(fn, *args, device: torch.device, warmup: int = 1,
               iters: int = 3) -> float:
    """Median seconds of one call: CUDA events around each call on the card,
    the host clock around a call that returns its result on the CPU."""
    for _ in range(warmup):
        fn(*args)
    device_mod.synchronize(device)
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _batch_indices(spec, trace, batch: int) -> np.ndarray:
    """(B, T, K) int32 logical bag indices drawn from the profiled trace."""
    cols = []
    for bag, tr in zip(spec.bags, trace):
        shaped = _bag_shaped(tr, bag.pooling)
        if shaped.shape[0] < batch:          # tile short traces
            reps = -(-batch // shaped.shape[0])
            shaped = np.tile(shaped, (reps, 1))
        cols.append(shaped[:batch])
    return np.stack(cols, axis=1).astype(np.int32)


def _live_slots(eng, idx: np.ndarray):
    """The host side of a cached sample: fresh schedulers stage the batch's
    rows, then translate its accesses.  Returns (big rows (B, T, K), slots
    (B, T, K), packed cache rows)."""
    from repro_torch.engine import big_rows

    eplan = eng.plan
    emb = eplan.bags[0].emb
    scheds = eng.fresh_schedulers()
    num_t = len(eplan.bags)
    rows = np.stack([np.asarray(big_rows(idx[:, t], emb)) for t in range(num_t)],
                    axis=1)
    for t in range(num_t):
        scheds[t].prefetch(rows[:, t])
    slot = np.stack([scheds[t].slots_for(rows[:, t], record=False)
                     for t in range(num_t)], axis=1)
    return rows, slot, eng.packed_cache_rows(scheds)


def _serving_call(eng, tables, idx: np.ndarray, device: torch.device):
    """The call a sample times and its arguments: the packed ``serve_gather``
    (with a live prefetch schedule) when the plan carries a cache, the
    ``lookup`` entry otherwise (one packed launch, or for a per-table plan
    ``embedding_bag.multi_bag_lookup``'s loop)."""
    eplan = eng.plan
    idx_t = torch.from_numpy(idx).to(device)
    if eplan.packed and eplan.has_cache:
        packed = eng.pack(tables)
        _rows, slot, cache_rows = _live_slots(eng, idx)
        args = (packed, idx_t, torch.from_numpy(slot).to(device),
                torch.from_numpy(cache_rows).to(device))
        return eng.serve_gather, args
    return eng.lookup, (tables, idx_t)


def _sample_engine(spec, knobs: Knobs, trace):
    from repro_torch import engine as engine_mod

    return engine_mod.compile(
        engine_mod.plan(spec, trace=trace, knobs=knobs, num_shards=1))


def _measure_sample(spec, knobs: Knobs, trace, batch: int, *, repeats: int,
                    device: torch.device) -> float:
    """Per-batch seconds of one knob setting, timed on ``device``.  The
    sample's tables and packed copy are freed before the next sample."""
    from repro_torch.core import embedding_bag as EB

    eng = _sample_engine(spec, knobs, trace)
    g = torch.Generator(device=device)
    g.manual_seed(0)
    tables = EB.init_tables(list(spec.bags), generator=g, device=device)
    idx = _batch_indices(spec, trace, batch)
    fn, args = _serving_call(eng, tables, idx, device)
    with torch.no_grad():
        sec = _time_call(fn, *args, device=device, iters=repeats)
    del fn, args, tables
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return sec


def _unique_rows(rows: np.ndarray, mask: np.ndarray | None = None) -> int:
    rows = np.asarray(rows)
    if mask is not None:
        rows = rows[mask]
    return int(np.unique(rows).size)


def analytic_bytes_flops(eng, idx: np.ndarray) -> tuple[int, int]:
    """(bytes, flops) the packed kernel needs for batch ``idx`` (B, T, K)
    under ``eng``'s plan, each unique input row read once and the output
    written once (``chip_smoke.py``'s ``bound()`` count): the index streams
    (and the slot stream of a packed plan), the cache block's rows the batch
    hits, the missed big-subtable rows, the small-subtable rows and the
    (B, T, dim) fp32 output.  A per-table plan reads every big row from the
    table (no cache block).  Host numpy only."""
    eplan = eng.plan
    emb = eplan.bags[0].emb
    b, num_t, k = idx.shape
    lookups = b * num_t * k
    big = _BIG_NAME.get(emb.kind, "table")
    cached = eplan.packed and eplan.has_cache
    if cached:
        rows, slot, _cache_rows = _live_slots(eng, idx)
        hit = slot >= 0
    nbytes = 0
    for t in range(num_t):
        for name, (trace, _n, row_bytes) in intra_gnr.subtable_traces(
                idx[:, t], eplan.bags[t].emb).items():
            if name == big and cached:
                nbytes += _unique_rows(rows[:, t], ~hit[:, t]) * row_bytes
                nbytes += _unique_rows(slot[:, t], hit[:, t]) * row_bytes
            else:
                nbytes += _unique_rows(trace) * row_bytes
    streams = {"qr": 2, "tt": 3}.get(emb.kind, 1) + (1 if eplan.packed else 0)
    nbytes += streams * lookups * 4 + b * num_t * emb.dim * 4
    if emb.kind == "tt":
        d1, d2, d3, r = emb.tt_spec.dims
        flops = 2 * lookups * (d1 * r * d2 * r + d1 * d2 * r * d3)
    else:
        flops = (2 if emb.kind == "qr" else 1) * lookups * emb.dim
    return nbytes, flops


def _analytic_sample(spec, knobs: Knobs, trace, batch: int) -> float:
    """Per-batch seconds of one knob setting, priced from the bytes and
    flops of a sampled batch: max(flops over the fp32 peak, bytes over the
    memory rate) plus the launch overhead per dispatch."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_FP32

    eng = _sample_engine(spec, knobs, trace)
    nbytes, flops = analytic_bytes_flops(eng, _batch_indices(spec, trace, batch))
    dispatches = 1.0 if knobs.backend == "packed" else float(spec.num_tables)
    return (max(flops / PEAK_FLOPS_FP32, nbytes / HBM_BW)
            + DISPATCH_OVERHEAD_S * dispatches)


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

def _sample_keys(space) -> list:
    """Distinct measurement settings: duplication only changes the modeled
    comm term (never a single-card run), so candidates are deduped on the
    execution-affecting knobs."""
    seen, keys = set(), []
    for k in space:
        key = (k.backend, k.dim_block, k.cache_slots, k.cache_slot_policy)
        if key not in seen:
            seen.add(key)
            keys.append(key)
    return keys


def resolve_mode(mode: str, device: torch.device) -> str:
    """``auto`` -> ``measure`` on the card, ``analytic`` on the CPU."""
    if mode == "hlo":
        raise ValueError(
            "tuner mode 'hlo' lowers through XLA and has no PyTorch "
            "counterpart; use mode='analytic' (bytes and flops of a sampled "
            "batch priced at the card's constants) or 'measure'"
        )
    if mode not in MODES:
        raise ValueError(f"unknown tuner mode {mode!r} (known: {MODES})")
    if mode == "auto":
        return "measure" if device.type == "cuda" else "analytic"
    return mode


def fit(
    spec,
    trace: Sequence[np.ndarray],
    *,
    mode: str = "auto",
    batch: int = 32,
    num_shards: int = 1,
    max_samples: int = 12,
    repeats: int = 3,
    cache_path: str | None = None,
    device=None,
) -> Tuner:
    """Fit per-backend cost models for a spec from a profiled trace.

    ``mode="measure"`` times the real execution paths on the card;
    ``"analytic"`` prices the bytes and flops of each sampled batch (the
    no-card path); ``"auto"`` measures on the card, prices analytically on
    the CPU.  ``device`` is resolved by ``device.resolve`` (the card unless
    ``device="cpu"``).  When ``cache_path`` holds a previous fit for (spec
    digest, device kind, source), it is loaded instead of re-observing
    (``tuner.from_cache``).
    """
    dev = device_mod.resolve(device)
    source = resolve_mode(mode, dev)

    digest = spec_digest(spec)
    meta = run_metadata(dev)
    cache_key = f"{digest}:{meta['device_kind']}:{source}"
    profile = TraceProfile.from_trace(
        spec, trace, batch=batch, num_shards=num_shards
    )

    if cache_path and os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
        if cache_key in cache:
            entry = cache[cache_key]
            models = {
                b: KernelCostModel.from_json(m)
                for b, m in entry["models"].items()
            }
            return Tuner(models=models, profile=profile, source=source,
                         metadata=entry.get("metadata", meta),
                         digest=digest, from_cache=True)

    space = knob_space(spec, packable=_packable(spec))
    keys = _sample_keys(space)
    if len(keys) > max_samples:
        stride = len(keys) / max_samples
        keys = [keys[int(i * stride)] for i in range(max_samples)]

    # observation drops duplication (it only moves the modeled comm term) and
    # observes each setting at two batch sizes so per-byte and per-dispatch
    # costs separate in the fit.
    spec_m = spec.replace(duplication=False)
    small = max(4, batch // 2)
    profiles = {batch: TraceProfile.from_trace(spec_m, trace, batch=batch),
                small: TraceProfile.from_trace(spec_m, trace, batch=small)}

    samples: list[CostSample] = []
    for backend, bd, slots, policy in keys:
        k = Knobs(dim_block=bd, cache_slots=slots, cache_slot_policy=policy,
                  dup_budget_bytes=0, backend=backend)
        for b, prof in profiles.items():
            if source == "measure":
                sec = _measure_sample(spec_m, k, trace, b, repeats=repeats,
                                      device=dev)
            else:
                sec = _analytic_sample(spec_m, k, trace, b)
            samples.append(CostSample(
                knobs=k, features=plan_features(spec_m, k, prof),
                measured_s=sec, source=source,
            ))

    models = {}
    for backend in sorted({s.knobs.backend for s in samples}):
        sub = [s for s in samples if s.knobs.backend == backend]
        model = fit_cost_model(sub, backend=backend, source=source)
        models[backend] = _with_comm_floor(model)

    tuner = Tuner(models=models, profile=profile, source=source,
                  metadata=meta, samples=samples, digest=digest)
    if cache_path:
        cache = {}
        if os.path.exists(cache_path):
            with open(cache_path) as f:
                cache = json.load(f)
        cache[cache_key] = tuner.describe()
        with open(cache_path, "w") as f:
            json.dump(cache, f, indent=1)
    return tuner


def _with_comm_floor(model: KernelCostModel) -> KernelCostModel:
    """Single-card observations can never price the comm term (its feature
    column is zero there), so an unfitted comm coefficient falls back to the
    analytic wire rate of two NVLink links — ranking across duplication
    budgets stays meaningful."""
    from repro_torch.launch.mesh import ICI_BW_PER_LINK

    idx = FEATURES.index("comm_bytes")
    if model.coef[idx] > 0:
        return model
    coef = list(model.coef)
    coef[idx] = 1.0 / (2 * ICI_BW_PER_LINK)
    return dataclasses.replace(model, coef=tuple(coef))
