"""Batched DLRM recommendation serving, end to end on one card (port of
``repro.launch.serve_rec``: ``build_serve_state``, ``run_pipeline``, ``main``).

1. **offline** (once): per-table Zipf traces -> ``engine.plan``: the
   intra-GnR analyzer, the cache-slot waterfill, the duplication planner and
   the packed layout;
2. **per batch**: the prefetch schedulers stage the batch's most valuable
   big-table rows and translate its accesses into slots; the whole embedding
   layer is ONE launch of the packed-bag CUDA kernel (K1 for dlrm-qr, K3 for
   dlrm-dense, K2 for dlrm-tt; ``EmbeddingEngine.serve_gather``); the MLP
   head gives the CTR logits.

``mode="overlap"`` enqueues batch t's head, then stages and launches batch
t+1's gather while the card runs it: CUDA launches are asynchronous, so the
host waits only at the tail.  ``mode="sequential"`` waits for every batch.
Both modes give the same logits.

Host-to-device copies of the per-batch streams are ``non_blocking`` from
pageable numpy arrays that are fresh for every batch, so no buffer is
reused while a copy may still read it.

Telemetry (``repro_torch.obs``; off unless a telemetry flag is passed, and
then every call is one bool check): the warm-up batch is timed apart
(``compile_s``); every steady-state batch records a latency sample; the
record carries the traffic report (cache hits, modeled HBM bytes, combine
bytes removed by duplication).  The spans of one batch, as in ``repro``:

* ``prefetch`` — the 26 ``PrefetchScheduler.prefetch`` calls (host numpy);
* ``pack`` — slot translation (``slots_for``) and the packed cache rows;
* ``h2d`` — the three stream uploads.  The arrays are pageable numpy, so a
  ``non_blocking`` copy goes through a staging buffer and the host mostly
  waits for it: this span is close to the copy's own time even unfenced;
* ``dispatch`` — ``serve_gather``: index packing, slot offsets, the
  cache-block gather, the kernel launch.  CUDA launches are asynchronous,
  so unfenced this is the host's enqueue time only;
* ``interact`` — the MLP head, also an enqueue unless fenced;
* with ``fence=True`` also ``device_compute`` and ``device_head``, which
  wait (``torch.cuda.synchronize``) for the embedding layer and the head:
  the device's time the enqueue spans left out.  The fence serialises
  overlap mode, so a fenced run's QPS is not the pipeline's.

Around them: ``compile_warmup`` (batch 0), ``batch`` (each steady-state
batch), ``block`` (sequential mode's per-batch wait) and ``tail_sync``
(overlap mode's drain).  ``big_rows`` of every batch is computed before the
timed window, so it is no part of a batch's latency.

``build_serve_state(tuner=...)`` plans with a fitted tuner's choice and
arms the drift monitor with its prediction.  ``--frontend`` serves
open-loop traffic through the resilient front end (``repro_torch.serve``:
admission queue, deadline batching, fault injection, the degradation
ladder); ``--adapt`` serves the pinned adaptive session
(``repro_torch.adapt``), or with ``--frontend`` feeds the admission loop's
caches.

Usage (CPU rehearsal of the smoke config; the card is the default):
    PYTHONPATH=src python -m repro_torch.launch.serve_rec --arch dlrm-tt --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_rec --arch dlrm-qr --smoke --device cpu \
        --mode both --metrics-json m.json --trace-out t.json --slo p99_ms=50 \
        --report r.md --flight-dir flight
    PYTHONPATH=src python -m repro_torch.launch.serve_rec --arch dlrm-qr --smoke --device cpu \
        --frontend --arrival rate=400,horizon=2,flash=0.5+0.4x6 \
        --faults stall@0.6:0.5,gather@1.0:1 --service-mode fixed
    PYTHONPATH=src python -m repro_torch.launch.serve_rec --arch dlrm-qr --smoke --device cpu \
        --adapt --drift period=8,frac=0.25 --batches 24
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import engine as engine_mod
from repro_torch import obs
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.engine import EngineSpec, big_rows, big_subtable
from repro_torch.models import dlrm
from repro_torch.obs import attribution as obs_attribution
from repro_torch.obs import report as obs_report
from repro_torch.obs import traffic as obs_traffic


@dataclasses.dataclass
class ServeState:
    """The offline pass's output, reusable across pipeline runs (schedulers
    are stateful, so ``run_pipeline`` makes a fresh set per run).

    ``predicted_s`` (a cost model's per-batch latency prediction) and
    ``drift`` (the monitor of predicted against measured batches) stay
    ``None`` until a tuner plans the state; ``run_pipeline`` feeds the
    monitor whenever both are set."""

    engine: engine_mod.EmbeddingEngine
    device: torch.device
    predicted_s: float | None = None
    drift: obs.DriftMonitor | None = None

    @property
    def eplan(self) -> engine_mod.EmbeddingPlan:
        return self.engine.plan

    @property
    def bags(self) -> list:
        return self.engine.bags

    @property
    def plan(self):                          # the duplication plan
        return self.eplan.dup

    @property
    def locs(self) -> list[dict]:            # per-table intra-GnR analyses
        return list(self.eplan.locality)

    @property
    def layout(self):
        return self.eplan.layout

    @property
    def slot_budgets(self) -> list[int]:
        return list(self.eplan.slot_budgets)

    def fresh_schedulers(self):
        return self.engine.fresh_schedulers()


def build_serve_state(cfg, *, shards: int, alpha: float, seed: int,
                      profile_n: int = 50_000, device=None, tuner=None,
                      knobs=None) -> ServeState:
    """Offline pass, one ``engine.plan`` call: profile -> analyze -> slot
    waterfill -> dup plan -> packed layout, compiled into the serving engine
    for ``device`` (the card unless ``device="cpu"``).

    ``tuner`` (a fitted ``repro_torch.tune.Tuner``) or an explicit ``knobs``
    routes the plan through the cost-model argmin instead of the
    heuristics; the serving pipeline needs the packed backend, so tuner
    choices are constrained to it.  A tuner also arms the drift monitor: its
    per-batch latency prediction for the chosen knobs is compared against
    measured batches while serving.
    """
    dev = device_mod.resolve(device)
    # per-table request streams: each sparse feature sees its own skew
    traces = [
        synthetic.zipf_trace(
            cfg.vocab_per_table, profile_n, alpha=alpha, seed=seed + 7 + t
        )
        for t in range(cfg.num_tables)
    ]
    spec = EngineSpec.from_dlrm(cfg, serving=True)
    predicted_s = drift = None
    if knobs is None and tuner is not None:
        knobs = tuner.choose(spec, backend="packed")
        predicted_s = tuner.predict(spec, knobs)
        drift = obs.DriftMonitor()
    eplan = engine_mod.plan(spec, traces, num_shards=shards, knobs=knobs)
    return ServeState(engine=engine_mod.compile(eplan), device=dev,
                      predicted_s=predicted_s, drift=drift)


def make_packed_gather(params, state: ServeState, *, packed: dict | None = None):
    """The per-batch embedding dispatch: packs the tables once (unless the
    caller passes ``packed`` from ``state.engine.pack``), then each call is
    one ``serve_gather`` launch for the batch."""
    eng = state.engine
    if packed is None:
        with obs.span("pack_tables", cat="offline"):
            packed = eng.pack(params["tables"])

    def gather(idx, slot, cache_rows):
        return eng.serve_gather(packed, idx, slot, cache_rows)

    return gather


# serving-record percentiles come from the exact-quantile helper the obs
# histograms use (obs.metrics.exact_percentile): one definition, so a metrics
# snapshot and a result record can never disagree
_percentiles = obs.latency_percentiles


def _host_batch(b: dict, device: torch.device) -> dict:
    """A batch as the pipeline keeps it: dense on the device, indices on the
    host (the schedulers read them there)."""
    dense = b["dense"]
    if isinstance(dense, torch.Tensor):
        dense = dense.to(device=device, dtype=torch.float32)
    else:
        dense = torch.from_numpy(np.array(dense, dtype=np.float32)).to(device)
    idx = b["idx"]
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    return {"dense": dense, "idx": np.array(idx, dtype=np.int32)}


def run_pipeline(cfg, *, batch: int = 16, batches: int = 6, alpha: float = 1.05,
                 shards: int = 4, seed: int = 0, mode: str = "overlap",
                 state: ServeState | None = None, params=None,
                 packed: dict | None = None, data: list | None = None,
                 device=None, fence: bool = False) -> dict:
    """Serve ``batches`` queued request batches; returns logits, QPS, the
    per-batch latency distribution, the cache statistics and the traffic
    report.

    ``data`` injects the batches (dicts with ``dense`` (B, num_dense) and
    ``idx`` (B, T, K), numpy or tensors) instead of drawing them from
    ``synthetic.dlrm_batch``; ``batch`` and ``batches`` then follow it.
    ``packed`` passes buffers already packed by ``state.engine.pack``, so a
    caller can free the per-table params before serving.

    Batch 0 is the warm-up, timed as ``compile_s`` and excluded from the
    steady-state window.  Sequential latencies are request latencies
    (dispatch to logits on the host); overlap latencies are the pipeline's
    enqueue-to-enqueue cycle, the tail drain folded into the last one.
    ``fence=True`` waits for the card after the embedding launch and after
    the head of every batch, so the ``device_compute`` / ``device_head``
    spans carry device time; it serialises overlap mode.
    """
    dev = device_mod.resolve(device)
    if state is None:
        state = build_serve_state(cfg, shards=shards, alpha=alpha, seed=seed, device=dev)
    elif state.device != dev:
        raise ValueError(f"serve state is for {state.device}, not {dev}")
    if params is None:
        params = dlrm.init_dlrm(cfg, seed=seed, device=dev)
    if mode not in ("overlap", "sequential"):
        raise ValueError(f"unknown mode {mode!r}")
    scheds = state.fresh_schedulers()    # per-run cache state
    emb = state.bags[0].emb

    if data is None:
        data = [synthetic.dlrm_batch(cfg, batch, seed=seed, step=t, alpha=alpha,
                                     device=dev) for t in range(batches)]
    data = [_host_batch(b, dev) for b in data]
    batches, batch = len(data), data[0]["idx"].shape[0]
    rows_np = [
        np.stack([big_rows(b["idx"][:, i], emb) for i in range(cfg.num_tables)], axis=1)
        for b in data
    ]                                          # (B, T, K) big-subtable rows

    gather = make_packed_gather(params, state, packed=packed)

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev, non_blocking=True)

    def prefetch(t: int) -> None:
        with obs.span("prefetch", batch=t):
            for i in range(cfg.num_tables):
                scheds[i].prefetch(rows_np[t][:, i])

    def dispatch_gather(t: int) -> torch.Tensor:
        """Translate batch t through the slot maps and launch its kernel."""
        with obs.span("pack", batch=t):        # host-side slot translation
            slot = np.stack(
                [scheds[i].slots_for(rows_np[t][:, i]) for i in range(cfg.num_tables)],
                axis=1,
            )
            cache_rows = state.engine.packed_cache_rows(scheds)
        with obs.span("h2d", batch=t):         # the three stream uploads
            args = (upload(data[t]["idx"]), upload(slot), upload(cache_rows))
        with obs.span("dispatch", batch=t):    # serve_gather: one kernel launch
            pooled = gather(*args)
        if fence:
            with obs.span("device_compute", batch=t):
                device_mod.synchronize(dev)
        return pooled

    def interact(t: int, pooled: torch.Tensor) -> torch.Tensor:
        with obs.span("interact", batch=t):    # pairwise dot + MLP head
            out = dlrm.forward_from_pooled(params, data[t]["dense"], pooled, cfg)
        if fence:
            with obs.span("device_head", batch=t):
                device_mod.synchronize(dev)
        return out

    logits: list = [None] * batches
    lats: list[float] = []
    device_mod.synchronize(dev)
    tc = time.perf_counter()
    with obs.span("compile_warmup", cat="offline"):
        prefetch(0)                        # cold-start staging for batch 0
        warm = interact(0, dispatch_gather(0))
        logits[0] = warm.cpu().numpy()     # waits for the warm-up batch
    compile_s = time.perf_counter() - tc

    t0 = time.perf_counter()
    if mode == "overlap":
        if batches > 1:
            prefetch(1)
            pooled = dispatch_gather(1)
        prev = time.perf_counter()
        for t in range(1, batches):
            # enqueue batch t's head, then stage + launch batch t+1's gather
            # while the card runs it; wait only at the tail of the stream
            with obs.span("batch", batch=t, mode=mode):
                logits[t] = interact(t, pooled)
                if t + 1 < batches:
                    prefetch(t + 1)
                    pooled = dispatch_gather(t + 1)
            if t < batches - 1:            # cycle time: enqueue-to-enqueue
                now = time.perf_counter()
                lats.append(now - prev)
                prev = now
                obs.observe_batch(batch=t, mode=mode, latency_s=lats[-1])
        with obs.span("tail_sync", mode=mode):
            device_mod.synchronize(dev)
        if batches > 1:                    # last cycle includes the drain
            lats.append(time.perf_counter() - prev)
            obs.observe_batch(batch=batches - 1, mode=mode, latency_s=lats[-1])
        logits = [x if isinstance(x, np.ndarray) else x.cpu().numpy() for x in logits]
    else:
        for t in range(1, batches):
            tb = time.perf_counter()
            with obs.span("batch", batch=t, mode=mode):
                prefetch(t)
                out = interact(t, dispatch_gather(t))
                with obs.span("block", batch=t):
                    device_mod.synchronize(dev)    # per-batch wait: the baseline
            lats.append(time.perf_counter() - tb)
            logits[t] = out.cpu().numpy()
            obs.observe_batch(batch=t, mode=mode, latency_s=lats[-1])
    wall_s = time.perf_counter() - t0

    for lat in lats:                       # the SLO histograms (when enabled)
        obs.observe(f"serve/{mode}/batch_latency_s", lat)
    obs.observe(f"serve/{mode}/compile_s", compile_s)
    obs.inc(f"serve/{mode}/batches", len(lats))
    obs.inc(f"serve/{mode}/requests", batch * len(lats))
    if state.drift is not None and state.predicted_s is not None:
        for lat in lats:
            state.drift.observe(state.predicted_s, lat)

    served = batch * max(0, batches - 1)
    stats = [s.stats for s in scheds]
    hits = sum(s.hits for s in stats)
    acc = sum(s.accesses for s in stats)
    staged = sum(s.staged_rows for s in stats) / max(1, batches)
    report = obs_traffic.collect(state.eplan, scheds, batch=batch)
    if obs.enabled():
        obs.trace_counter(f"serve/{mode}/hit_rate", hit_rate=report.hit_rate)
    return {
        "config": cfg.name,
        "device": str(dev),
        "mode": mode,
        "batch": batch,
        "batches": batches,
        "served": served,
        "compile_s": compile_s,            # warm-up, excluded from qps
        "wall_s": wall_s,
        "qps": served / max(wall_s, 1e-9),
        **_percentiles(lats),
        "latencies_s": lats,
        "hit_rate": hits / max(1, acc),
        "staged_per_batch": staged,
        "slot_budgets": list(state.slot_budgets),
        "traffic": report.describe(),
        "traffic_report": report,          # the live object (attribution joins)
        "drift": state.drift.summary() if state.drift is not None else None,
        "logits": logits,
    }


# result keys dropped from the --json / --metrics-json records (bulk arrays
# and live objects)
_RECORD_DROP = ("logits", "latencies_s", "traffic_report")


# -- resilient front-end mode (--frontend) ------------------------------------

_DEFAULT_ARRIVAL = "rate=400,horizon=3,deadline_ms=250"
_DEFAULT_FRONTEND_SLO = ("p99_ms=60,objective=0.99,fast_window=4,"
                         "slow_window=8,name=frontend")


def run_frontend(cfg, state, params, args, slo_engine=None) -> dict:
    """The ``--frontend`` serving session: open-loop traffic through the
    admission queue, fault injector, and degradation ladder.

    Returns the front end's report with the arrival/fault specs (seeds
    included) stamped in, so a saved record reproduces the run exactly.
    """
    from repro_torch import serve

    aspec = serve.ArrivalSpec.parse(args.arrival or _DEFAULT_ARRIVAL)
    if args.seed and aspec.seed == 0:      # --seed flows into the traffic
        aspec = dataclasses.replace(aspec, seed=args.seed)
    fspec = serve.FaultSpec.parse(args.faults) if args.faults else serve.FaultSpec()
    if slo_engine is None:
        slo_engine = obs.SLOEngine(obs.SLOSpec.parse(_DEFAULT_FRONTEND_SLO))
    fcfg = serve.FrontendConfig(
        batch_size=args.batch or (8 if args.tiny else 16),
        queue_cap=args.queue_cap,
        shed_policy=args.shed_policy,
        queue_order=args.queue_order,
        # adaptation adapts *pinned* residency; the oracle prefetcher would
        # self-heal under drift and mask what the controller does
        residency="pinned" if args.adapt else "prefetch",
        service_mode=args.service_mode,
    )
    adapt_ctl = None
    if args.adapt:
        from repro_torch.adapt import AdaptController

        adapt_ctl = AdaptController(state.eplan, seed=args.seed)
    frontend = serve.Frontend(
        cfg, fcfg, state, params,
        slo=slo_engine, faults=serve.FaultInjector(fspec),
        adapt=adapt_ctl,
    )
    requests = serve.generate(aspec, cfg)
    report = frontend.run(requests)
    report["arrival"] = aspec.describe()
    report["faults"] = fspec.describe()
    report["config"] = cfg.name
    report["device"] = str(state.device)
    report["mode"] = "frontend"

    req = report["requests"]
    print(
        f"[frontend] {req['generated']} requests over {aspec.horizon_s:.1f}s "
        f"(virtual): served {req['served']}, deadline-missed "
        f"{req['deadline_missed']}, shed {req['shed_total']} "
        f"(reject {req['shed_reject']} / evict {req['shed_evict']} / "
        f"shed-mode {req['shed_mode']} / abandoned {req['abandoned']}), "
        f"unaccounted {req['unaccounted']}"
    )
    print(
        f"[frontend] request latency p50={report['req_lat_p50_s'] * 1e3:.1f}ms "
        f"p95={report['req_lat_p95_s'] * 1e3:.1f}ms "
        f"p99={report['req_lat_p99_s'] * 1e3:.1f}ms (virtual), "
        f"miss rate {report['deadline_miss_rate']:.3f}, "
        f"shed rate {report['shed_rate']:.3f}, "
        f"hit rate {report['hit_rate']:.3f}"
    )
    deg = report["degrade"]
    for tr in deg["transitions"]:
        print(f"[degrade] batch {tr['at_batch']} t={tr['t_s']:.2f}s "
              f"{tr['from']} -> {tr['to']} ({tr['reason']})")
    ttr = report["time_to_recover_s"]
    print(
        f"[degrade] final rung {deg['rung']}, "
        f"{len(deg['transitions'])} transitions, time-to-recover "
        f"{'%.2fs' % ttr if ttr is not None else 'n/a'}"
    )
    if adapt_ctl is not None:
        print(f"[adapt] {adapt_ctl.batch_i} batches sketched, "
              f"events {report['adapt']['events'] or '{}'}")
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="dlrm config id (dlrm-qr | dlrm-tt | dlrm-dense)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="CI smoke: --smoke config with batch=8")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--shards", type=int, default=4,
                    help="modeled row-shard count for the duplication plan")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mode", default="overlap",
                    choices=["overlap", "sequential", "both"])
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write measured QPS / latency / hit-rate records")
    ap.add_argument("--plan-json", default=None, metavar="PATH",
                    help="write the EmbeddingPlan summary as JSON")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="enable telemetry; write the metric registry "
                         "(latency histograms, dispatch counters, traffic)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry; write a Chrome-trace JSON of the "
                         "stage spans (fences every stage — perturbs overlap)")
    ap.add_argument("--slo", default=None, metavar="SPEC",
                    help="serving SLO, e.g. 'p99_ms=50,hit=0.5,qps=100,"
                         "objective=0.99' — enables telemetry, burn-rate "
                         "alerts, and the flight recorder")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the serving-report artifact (markdown + JSON "
                         "twin): SLO state, per-stage attribution, traffic. "
                         "Enables telemetry and fences stages like --trace-out")
    ap.add_argument("--flight-dir", default=None, metavar="DIR",
                    help="directory for flight-recorder JSON dumps (written "
                         "when an SLO burns or a latency sample is anomalous)")
    ap.add_argument("--frontend", action="store_true",
                    help="serve open-loop traffic through the resilient "
                         "front end (admission queue + deadline batching + "
                         "fault injection + degradation ladder)")
    ap.add_argument("--arrival", default=None, metavar="SPEC",
                    help="traffic model, e.g. 'rate=400,horizon=3,"
                         "deadline_ms=250,flash=1.0+0.5x8,drift_s=1,seed=0'")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="fault schedule, e.g. 'stall@1.0:0.5,drop@1.5,"
                         "replica@2.0:1.0,gather@3.0:2,retries=3'")
    ap.add_argument("--shed-policy", default="reject_new",
                    choices=["reject_new", "drop_oldest"],
                    help="load-shedding policy at a full admission queue")
    ap.add_argument("--queue-cap", type=int, default=64,
                    help="admission queue bound (requests)")
    ap.add_argument("--service-mode", default="measured",
                    choices=["measured", "fixed"],
                    help="virtual service time: calibrated from measured "
                         "wall ('measured') or exactly one unit per batch "
                         "('fixed' — the deterministic configuration)")
    ap.add_argument("--queue-order", default="fifo", choices=["fifo", "edf"],
                    help="admission-queue dispatch order: arrival order or "
                         "deadline-earliest-first")
    ap.add_argument("--adapt", action="store_true",
                    help="online adaptation (repro_torch.adapt): frequency "
                         "sketches + incremental re-pinning; standalone it "
                         "runs the pinned adaptive session, with --frontend "
                         "it feeds the admission loop's caches")
    ap.add_argument("--drift", default=None, metavar="SPEC",
                    help="batch-indexed hot-set drift for the --adapt "
                         "session, e.g. 'period=8,frac=0.25' (rotations "
                         "every `period` batches)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    telemetry = bool(args.metrics_json or args.trace_out or args.slo
                     or args.report or args.flight_dir)
    if telemetry:
        obs.enable()
    # --report needs device-honest stage durations for attribution, so it
    # fences like --trace-out (and carries the same QPS caveat)
    fence = bool(args.trace_out or args.report)

    slo_engine = recorder = None
    if args.slo:
        slo_engine = obs.SLOEngine(obs.SLOSpec.parse(args.slo))
    if args.slo or args.flight_dir or args.report:
        recorder = obs.FlightRecorder(out_dir=args.flight_dir)
    if slo_engine is not None or recorder is not None:
        # after enable(): the telemetry join cursors into the live registry.
        # In --frontend mode the front end feeds the SLO engine itself, so
        # the observatory carries only the recorder (no double observation).
        obs.install_observatory(
            slo=None if args.frontend else slo_engine, recorder=recorder,
        )

    name = f"{args.arch}-smoke" if (args.smoke or args.tiny) else args.arch
    cfg = registry.get_dlrm(name)
    batch = args.batch or (8 if args.tiny else 16)
    params = dlrm.init_dlrm(cfg, seed=args.seed, device=dev)
    state = build_serve_state(cfg, shards=args.shards, alpha=args.alpha,
                              seed=args.seed, device=dev)
    big_name, _rows = big_subtable(state.bags[0].emb)
    plan = state.plan
    if args.plan_json:
        with open(args.plan_json, "w") as f:
            json.dump(state.engine.summary(), f, indent=1)
        print(f"# wrote EmbeddingPlan summary to {args.plan_json}")
    print(
        f"{cfg.name} on {dev}: {cfg.num_tables} tables, kind={cfg.embedding_kind}, "
        f"slot budgets {min(state.slot_budgets)}..{max(state.slot_budgets)} "
        f"({cfg.cache_slot_policy}), dup budget {cfg.dup_budget_mb} MiB, "
        f"packed rows {state.layout.total_rows}"
    )
    print(
        f"duplication plan: replicated {plan.replicated_bytes} B/chip, "
        f"comm_free={plan.comm_free}, local_share="
        f"{plan.tables[0].local_share:.2f}, "
        f"intra-GnR reuse[{big_name}]={state.locs[0][big_name].mean_intra_reuse:.2f}"
    )

    if args.frontend:
        report = run_frontend(cfg, state, params, args, slo_engine=slo_engine)
        if recorder is not None and recorder.dumps:
            for d in recorder.dumps:
                print(f"[flight] dumped {d['records']} records "
                      f"({d['reason']}) -> {d.get('path', '<memory>')}")
            report["flight_dumps"] = [
                {k: v for k, v in d.items() if k != "context"}
                for d in recorder.dumps
            ]
        if args.json:
            with open(args.json, "w") as f:
                json.dump([report], f, indent=1)
            print(f"# wrote frontend record to {args.json}")
        if args.metrics_json:
            snap = obs.snapshot().to_json()
            snap["config"] = cfg.name
            snap["frontend"] = report
            with open(args.metrics_json, "w") as f:
                json.dump(snap, f, indent=1)
            print(f"# wrote metric registry to {args.metrics_json}")
        return 0

    if args.adapt:
        from repro_torch.adapt import DriftSchedule
        from repro_torch.adapt.loop import serve_adaptive

        schedule = (DriftSchedule.parse(args.drift) if args.drift
                    else DriftSchedule(seed=args.seed))
        res = serve_adaptive(
            cfg, batch=batch, batches=args.batches, alpha=args.alpha,
            seed=args.seed, state=state, params=params,
            schedule=schedule, refit=True,
        )
        print(
            f"[adaptive] served {res['served']} requests in "
            f"{res['wall_s']:.2f}s -> {res['qps']:.1f} QPS on {dev}, hit rate "
            f"{res['hit_rate']:.3f} (pinned residency)"
        )
        hs = res["hit_series"]
        print(f"[adaptive] hit-rate trajectory first->last: "
              f"{hs[0]:.3f} -> {hs[-1]:.3f} over {len(hs)} batches, "
              f"drift {res['schedule']}")
        for ev in res["events"]:
            print(f"[adapt] batch {ev['batch']}: {ev['kind']} "
                  f"(gain {ev.get('gain', 'n/a')})")
        if not res["events"]:
            print("[adapt] no re-plan events (policy held)")
        record = {k: v for k, v in res.items()
                  if k not in _RECORD_DROP and k != "hit_series"}
        record["hit_first"], record["hit_last"] = hs[0], hs[-1]
        if args.json:
            with open(args.json, "w") as f:
                json.dump([record], f, indent=1)
            print(f"# wrote adaptive record to {args.json}")
        if args.metrics_json:
            snap = obs.snapshot().to_json()
            snap["config"] = cfg.name
            snap["adaptive"] = record
            with open(args.metrics_json, "w") as f:
                json.dump(snap, f, indent=1)
            print(f"# wrote metric registry to {args.metrics_json}")
        if args.trace_out:
            obs.tracer().write(
                args.trace_out,
                metadata={"config": cfg.name, "modes": ["adaptive"],
                          "device": str(dev)},
            )
            print(f"# wrote Chrome trace to {args.trace_out}")
        return 0

    modes = ["sequential", "overlap"] if args.mode == "both" else [args.mode]
    records = []
    for mode in modes:
        res = run_pipeline(
            cfg, batch=batch, batches=args.batches, alpha=args.alpha,
            shards=args.shards, seed=args.seed, mode=mode,
            state=state, params=params, device=dev, fence=fence,
        )
        tr = res["traffic"]
        ici = plan.ici_bytes_per_batch(batch, cfg.dim)
        print(
            f"[{mode}] served {res['served']} requests in {res['wall_s']:.2f}s "
            f"-> {res['qps']:.1f} QPS on {dev} (steady state; warm-up "
            f"{res['compile_s']:.2f}s excluded)"
        )
        print(
            f"[{mode}] batch latency p50={res['lat_p50_s'] * 1e3:.2f}ms "
            f"p95={res['lat_p95_s'] * 1e3:.2f}ms "
            f"p99={res['lat_p99_s'] * 1e3:.2f}ms over {len(res['latencies_s'])} "
            f"batches"
        )
        print(
            f"[{mode}] cache hit rate {res['hit_rate']:.3f}, "
            f"staged {res['staged_per_batch']:.1f} rows/batch, "
            f"HBM {tr['hbm_cached_bytes']}B vs baseline "
            f"{tr['hbm_baseline_bytes']}B ({tr['hbm_reduction']:.2f}x)"
        )
        print(
            f"modeled combine traffic/batch: baseline {ici['baseline']:.0f} B -> "
            f"{ici['duplicated']:.0f} B (saved {ici['saved']:.0f} B)"
        )
        print("first logits:", np.asarray(res["logits"][-1][:4]).round(4).tolist())
        records.append({k: v for k, v in res.items() if k not in _RECORD_DROP})

    # -- observatory epilogue: SLO verdict, attribution, serving report -------
    if slo_engine is not None:
        floors = slo_engine.finalize(hit_rate=res["hit_rate"], qps=res["qps"])
        verdict = "BREACHED" if slo_engine.breached else "met"
        print(
            f"[slo] {slo_engine.spec.name}: {verdict} — "
            f"{slo_engine.bad_total}/{slo_engine.n} bad batches, "
            f"budget remaining {slo_engine.budget_remaining_frac * 100:.1f}%, "
            f"{len(slo_engine.alerts)} alerts"
        )
        for fname, f in floors.items():
            print(f"[slo] {fname} floor {f['floor']}: measured "
                  f"{f['measured']:.3f} — "
                  f"{'BREACHED' if f['breached'] else 'met'}")
    if recorder is not None and recorder.dumps:
        for d in recorder.dumps:
            print(f"[flight] dumped {d['records']} records "
                  f"({d['reason']}) -> {d.get('path', '<memory>')}")
    if args.report:
        att = obs_attribution.attribute(
            obs.tracer().events, res["traffic_report"], state.eplan,
            batch=batch, fenced=fence,
        )
        print(f"[attribution] bottleneck stage: {att.bottleneck} "
              f"(measured {att.total_s * 1e3:.2f} ms/batch, "
              f"cost model {att.modeled_total_s() * 1e3:.2f} ms/batch)")
        rep = obs_report.build(
            snapshot=obs.snapshot(),
            slo_state=slo_engine.state() if slo_engine is not None else None,
            attribution=att,
            traffic=res["traffic"],
            results={r["mode"]: r for r in records},
            flight_dumps=recorder.dumps if recorder is not None else None,
            meta={
                "config": cfg.name, "batch": batch, "batches": args.batches,
                "shards": args.shards, "alpha": args.alpha,
                "seed": args.seed, "modes": modes, "fenced": fence,
                "device": str(dev),
            },
        )
        md_path, jpath = obs_report.write(rep, args.report, attribution=att)
        print(f"# wrote serving report to {md_path} (+ {jpath})")

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"# wrote {len(records)} records to {args.json}")
    if args.metrics_json:
        snap = obs.snapshot().to_json()
        snap["config"] = cfg.name
        snap["modes"] = {r["mode"]: r for r in records}
        snap["plan"] = state.engine.summary()
        with open(args.metrics_json, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"# wrote metric registry to {args.metrics_json}")
    if args.trace_out:
        obs.tracer().write(
            args.trace_out,
            metadata={"config": cfg.name, "modes": modes, "fenced": fence,
                      "device": str(dev)},
        )
        print(f"# wrote Chrome trace to {args.trace_out} "
              f"(load in chrome://tracing or ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
