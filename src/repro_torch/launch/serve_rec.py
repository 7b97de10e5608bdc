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

Not ported yet: the ``obs`` spans and traffic report, drift, the tuner,
``--frontend`` and ``--adapt``.

Usage (CPU rehearsal of the smoke config; the card is the default):
    PYTHONPATH=src python -m repro_torch.launch.serve_rec --arch dlrm-tt --smoke --device cpu
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
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.engine import EngineSpec, big_rows, big_subtable
from repro_torch.models import dlrm


@dataclasses.dataclass
class ServeState:
    """The offline pass's output, reusable across pipeline runs (schedulers
    are stateful, so ``run_pipeline`` makes a fresh set per run)."""

    engine: engine_mod.EmbeddingEngine
    device: torch.device

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
                      profile_n: int = 50_000, device=None) -> ServeState:
    """Offline pass, one ``engine.plan`` call: profile -> analyze -> slot
    waterfill -> dup plan -> packed layout, compiled into the serving engine
    for ``device`` (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    # per-table request streams: each sparse feature sees its own skew
    traces = [
        synthetic.zipf_trace(
            cfg.vocab_per_table, profile_n, alpha=alpha, seed=seed + 7 + t
        )
        for t in range(cfg.num_tables)
    ]
    spec = EngineSpec.from_dlrm(cfg, serving=True)
    eplan = engine_mod.plan(spec, traces, num_shards=shards)
    return ServeState(engine=engine_mod.compile(eplan), device=dev)


def make_packed_gather(params, state: ServeState, *, packed: dict | None = None):
    """The per-batch embedding dispatch: packs the tables once (unless the
    caller passes ``packed`` from ``state.engine.pack``), then each call is
    one ``serve_gather`` launch for the batch."""
    eng = state.engine
    if packed is None:
        packed = eng.pack(params["tables"])

    def gather(idx, slot, cache_rows):
        return eng.serve_gather(packed, idx, slot, cache_rows)

    return gather


def latency_percentiles(samples, qs=(50, 95, 99)) -> dict:
    """``lat_p50_s``... from raw per-batch latency samples (numpy.percentile,
    0.0 when empty), the keys of ``repro``'s serving records."""
    samples = np.asarray(samples, dtype=np.float64)
    return {f"lat_p{q:g}_s": float(np.percentile(samples, q)) if samples.size else 0.0
            for q in qs}


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
                 device=None) -> dict:
    """Serve ``batches`` queued request batches; returns logits, QPS, the
    per-batch latency distribution and the cache statistics.

    ``data`` injects the batches (dicts with ``dense`` (B, num_dense) and
    ``idx`` (B, T, K), numpy or tensors) instead of drawing them from
    ``synthetic.dlrm_batch``; ``batch`` and ``batches`` then follow it.
    ``packed`` passes buffers already packed by ``state.engine.pack``, so a
    caller can free the per-table params before serving.

    Batch 0 is the warm-up, timed as ``compile_s`` and excluded from the
    steady-state window.  Sequential latencies are request latencies
    (dispatch to logits on the host); overlap latencies are the pipeline's
    enqueue-to-enqueue cycle, the tail drain folded into the last one.
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
        for i in range(cfg.num_tables):
            scheds[i].prefetch(rows_np[t][:, i])

    def dispatch_gather(t: int) -> torch.Tensor:
        """Translate batch t through the slot maps and launch its kernel."""
        slot = np.stack(
            [scheds[i].slots_for(rows_np[t][:, i]) for i in range(cfg.num_tables)],
            axis=1,
        )
        cache_rows = state.engine.packed_cache_rows(scheds)
        return gather(upload(data[t]["idx"]), upload(slot), upload(cache_rows))

    def head(t: int, pooled: torch.Tensor) -> torch.Tensor:
        return dlrm.forward_from_pooled(params, data[t]["dense"], pooled, cfg)

    logits: list = [None] * batches
    lats: list[float] = []
    device_mod.synchronize(dev)
    tc = time.perf_counter()
    prefetch(0)                            # cold-start staging for batch 0
    warm = head(0, dispatch_gather(0))
    logits[0] = warm.cpu().numpy()         # waits for the warm-up batch
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
            logits[t] = head(t, pooled)
            if t + 1 < batches:
                prefetch(t + 1)
                pooled = dispatch_gather(t + 1)
            if t < batches - 1:            # cycle time: enqueue-to-enqueue
                now = time.perf_counter()
                lats.append(now - prev)
                prev = now
        device_mod.synchronize(dev)
        if batches > 1:                    # last cycle includes the drain
            lats.append(time.perf_counter() - prev)
        logits = [x if isinstance(x, np.ndarray) else x.cpu().numpy() for x in logits]
    else:
        for t in range(1, batches):
            tb = time.perf_counter()
            prefetch(t)
            out = head(t, dispatch_gather(t))
            device_mod.synchronize(dev)    # per-batch wait: the baseline
            lats.append(time.perf_counter() - tb)
            logits[t] = out.cpu().numpy()
    wall_s = time.perf_counter() - t0

    served = batch * max(0, batches - 1)
    stats = [s.stats for s in scheds]
    hits = sum(s.hits for s in stats)
    acc = sum(s.accesses for s in stats)
    staged = sum(s.staged_rows for s in stats) / max(1, batches)
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
        **latency_percentiles(lats),
        "latencies_s": lats,
        "hit_rate": hits / max(1, acc),
        "staged_per_batch": staged,
        "slot_budgets": list(state.slot_budgets),
        "logits": logits,
    }


# result keys dropped from the --json records (bulk arrays)
_RECORD_DROP = ("logits", "latencies_s")


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
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
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

    modes = ["sequential", "overlap"] if args.mode == "both" else [args.mode]
    records = []
    for mode in modes:
        res = run_pipeline(
            cfg, batch=batch, batches=args.batches, alpha=args.alpha,
            shards=args.shards, seed=args.seed, mode=mode,
            state=state, params=params, device=dev,
        )
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
            f"staged {res['staged_per_batch']:.1f} rows/batch"
        )
        print("first logits:", np.asarray(res["logits"][-1][:4]).round(4).tolist())
        records.append({k: v for k, v in res.items() if k not in _RECORD_DROP})

    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"# wrote {len(records)} records to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
