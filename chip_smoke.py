"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each one failing the script if it fails:

1. build every CUDA source of ``src/repro_torch/csrc`` with ``nvcc`` (all
   started together), print the ``-Xptxas -v`` summary and the count of
   tensor-core instructions (``HGMMA``, ``HMMA``) of each K9 and K2/K5 body
   in the built libraries' SASS (``cuobjdump -sass``), failing if K9's bf16
   body has none;
2. reference: serve dlrm-qr-smoke, dlrm-dense-smoke and dlrm-tt-smoke on the
   card and on the CPU (the kernels' plain versions) with the same weights
   and batches; the logits agree; ``EmbeddingEngine.cached_lookup`` on one
   dlrm-qr-smoke and one dlrm-dense-smoke table agrees between card and CPU
   with the same scheduler slots;
3. kernels: call K1 ``packed_qr_bag``, K3 ``packed_bag`` and K2
   ``packed_tt_bag`` at the shapes the full-width main path gives them
   (B = 2048, T = 26, K = 32, dim 128; the cache block holds this batch's
   most used big-table rows, as many as the plan's slot total: 16,384 rows
   of 512 B, 1,024 G2 rows of 8 KiB), and K5 ``tt_bag`` on one dlrm-tt
   table's cores as ``tt_embedding.lookup`` calls it (65,536 lookups of
   K = 1) and pooled (2,048 x 32); hold each against its plain PyTorch
   version on the same inputs (max abs error <= 1e-4, TF32 off), and time
   kernel, plain version and, where one exists, the one PyTorch call that
   computes the same function (``embedding_bag``) with CUDA events (K2 and
   K5: the whole wrapper call, sort, contraction and K sum, beside the
   body that ran, the batch's distinct middle-core rows and elements per
   row, the scratch round trip's floor and the earlier body's time); then
   the per-table kernels at one full-width table's shapes: K4b
   ``cached_qr_bag``, K6 ``gnr_bag`` and K8 ``qr_gather`` on dlrm-qr table 0
   (Q 31,360 x 128, R 64 x 128; (2,048, 32) bags, K4b's cache the batch's
   1,024 most used Q rows; 65,536 unpooled lookups), K4a ``cached_bag`` and
   K7 ``gnr_bag_dense`` on dlrm-dense table 0 (2,000,000 x 128), the same
   checks and times, K6 and K8 also in bf16; then the bf16 entries of K1,
   K3, K2 and K5 at the training path's shapes (train_8k: 8,192 x 26 bags
   of 32, all-miss slots and a 1-row cache; dlrm-dense at 200,000 rows per
   table).  Every bf16 output is held per element within one rounding of
   the plain version computed in fp32 on the same inputs: |out - plain| <=
   2^-8 |plain| + 1e-5 max|plain|.  The bag family's rows (K1, K3, K4, K6,
   K7) also give the time in a CUDA graph (device time without the host's
   per-call work, which sets the back-to-back time of a one-table bag) and
   K1 / K3 the profile readings of their body (``bag_profile``: unique
   bytes against the HBM peak, row-request rate, an all-in-cache probe);
   then K2 and K5 at rank 64 (dims 64 and 128, fp32 and bf16: the
   d2-sliced staging path), held to their plain versions and read for
   bitwise equality with them.  The per-table phase also logs the launch
   overhead: a one-table bag's back-to-back time minus its CUDA-graph time
   (``launch/mesh.py::DISPATCH_OVERHEAD_S`` holds a reading of it);
4. serve dlrm-qr at full width (26 x 2M rows, dim 128, pooling 32), batch
   2048, 6 batches, dlrm-dense at full width, 3 batches, and dlrm-tt at full
   width (26 x 2M logical rows as TT cores, rank 16), 6 batches, each in
   both modes with telemetry off: overlap logits equal sequential logits to
   1e-6, all finite, and the kernel's launch count equals the batches
   served in each run; then one fenced sequential run with telemetry on (4
   batches, dlrm-dense 3) on the same state and packed buffers: every span
   of each steady-state batch is there, ``engine/dispatch/serve_gather``
   counts the batches, the kernel launches once a batch, the traffic
   report's hit rate is the run's; it logs the attribution table
   (``obs.attribution``) and prints a ``{"serve_split": ...}`` line (stage
   -> ms per batch, the fenced total, the unfenced p50s); after
   ``obs.disable()`` and a reset the profiled run records nothing; then
   one ``tt_embedding.lookup`` on a dlrm-tt table launches K5 once; and
   ``serve_rec.main`` on dlrm-qr-smoke with the five telemetry flags
   (``--metrics-json --trace-out --slo --report --flight-dir``, outputs
   under ``build/serve_cli``), every artifact parsed;
5. the per-table paths at full width: ``engine_for(...).cached_lookup`` for
   4 batches of (2,048, 32) on dlrm-qr table 0 (K4b), dlrm-dense table 0
   (K4a) and dlrm-tt table 0 (K5), the scheduler prefetching the next batch
   between calls, one launch per batch, outputs equal to ``bag_lookup`` in
   fp32 to 1e-4; ``ops.qr_lookup`` (K8) and ``ops.gnr_pooled_dense`` (K7)
   once each; ``engine.lookup`` on 26 hashed tables of the dlrm-qr shape at
   (2,048, 26, 32) (the per-table branch: plain gathers) agrees with the
   CPU; the two examples run on the card (quickstart: K6 and K1 once each;
   cache_plan: K4b once per batch);
6. attention: ``ops.flash_attention_fused`` (K9) causal at qwen2-1.5b's width
   (batch 4, 12 query / 2 kv heads, D 128, seq 4,096), granite-34b's (batch
   1, 48 query heads on one kv head, seq 4,096) and a 1,024-query block over
   a 4,096 cache, each in fp32 and bf16, then one backward (blockwise
   recompute) against plain autograd; every output held against K9's plain
   version (bf16 by the one-rounding rule of phase 3) and timed beside its
   bound, ``scaled_dot_product_attention`` and the earlier body's time, each
   case naming its body (fp32 on the CUDA cores, bf16 on the tensor cores);
7. training: 4 steps each of dlrm-qr and dlrm-tt at full width and of
   dlrm-dense at 200,000 rows per table, batch 8,192 (train_8k), through
   ``train_step.make_train_step``: finite losses and gradient norms, one
   launch of the packed kernel (bf16 entry) per step, step-1 table
   gradients on a cut batch within ``GRAD_TOL`` of a plain path whose
   embedding-bag backward runs in fp32, the lookup's backward on that batch
   across 52 recompute chunks within one bf16 rounding (``RECOMPUTE_RULE``)
   of the exact fp32 gradient, ms per step split into forward, backward and
   update, peak memory; the training CLI (``launch.train --arch dlrm-qr``,
   4 steps at full width); one ``tt_embedding.lookup`` on bf16 cores under
   grad (K5 bf16); and the train-DLRM example at TT rank 64
   (``examples.train_dlrm --embedding tt --tt-rank 64``, 25 steps: K2 bf16
   on the sliced staging path);
8. the serving control plane: ``tune.fit(mode="measure", max_samples=4)``
   on full-width dlrm-qr traces at batch 2,048 (each sample's knobs,
   features and CUDA-event time logged, then the coefficients and the
   choice, which must lie in the knob space and be what ``plan(tuner=)``
   freezes), ``build_serve_state(tuner=)`` and 5 sequential batches (the
   prediction against the tuned plan's ``serve_gather`` by CUDA events and
   against its whole batches, and the drift monitor); one batch of 2,048
   through every rung of the degradation ladder on dlrm-qr, dlrm-tt and
   dlrm-dense (1,000,000 rows a table: the ladder holds three copies of the
   tables): rungs 0-2 bitwise identical, ``baseline`` within
   ``BASELINE_TOL``, the packed kernel launched once a call on ``full`` and
   ``nocache``, once per table on ``pertable``, never on ``baseline``, ms a
   batch of each; a chaos session of the front end on full-width dlrm-qr in
   ``measured`` mode (flash crowd, stall, replica loss, gather errors, a
   dropped prefetch): no request unaccounted, the ladder steps down and
   comes back to ``full``; at batch 256, a stationary adaptive session
   bitwise ``run_pipeline``'s, the controller's host cost (one ``observe``,
   one ``evaluate``), then a drifting session with ``refit=True`` on the
   tuner-armed state; ``serve_rec.main`` on dlrm-qr-smoke with ``--frontend
   --arrival --faults`` and with ``--adapt --drift`` (records under
   ``build/serve_cli``).

It prints the card's name and power limit, one ``{"serve_split": ...}``
line per served config, one ``{"training": [...]}`` line, one
``{"control_plane": ...}`` line, one ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's datasheet rates, one definition for the port and this script
from repro_torch.launch.mesh import (  # noqa: E402
    DISPATCH_OVERHEAD_S, HBM_BW as BW_BYTES_S, PEAK_FLOPS_BF16 as BF16_FLOP_S,
    PEAK_FLOPS_FP32 as FP32_FLOP_S,
)
ERR_TOL = 1e-4
BF16_TOL = 1e-2      # card and CPU each round an fp32 sum to bf16 once
# the previous bodies' times on an NVIDIA H100 80GB HBM3 at 700 W, ranges
# over calls (PERF.md, kernel table): K9 and K2/K5 before their sorted-run
# and tensor-core redesign, the bag family (K1, K3, K4, K6, K7) before the
# table-major body.  Printed in
# the log lines beside this run's times, never in the kernels line
EARLIER_MS = {
    "flash_fwd": {"float32": [8.2697, 8.3049], "bfloat16": [8.2338, 8.2617]},
    "packed_tt_bag": [8.3476, 8.5560], "packed_tt_bag_bf16": [32.9784, 33.2118],
    "tt_bag": [0.3442, 0.3700], "tt_bag_bf16": [0.3348, 0.3379],
    "packed_qr_bag": [0.1903, 0.1935], "packed_qr_bag_bf16": [0.4781, 0.4814],
    "packed_bag": [0.1683, 0.1739], "packed_bag_bf16": [0.3597, 0.3619],
    "cached_qr_bag": [0.0223, 0.0432], "gnr_bag": [0.0196, 0.0379],
    "cached_bag": [0.0197, 0.0431], "gnr_bag_dense": [0.0171, 0.0383],
}


def log(*a) -> None:
    print(*a, flush=True)


# the kernel function of each body in the built libraries' SASS
SASS_KERNEL = {("flash", torch.float32): "flash_kernel", ("flash", torch.bfloat16): "flash_tc_kernel",
               ("tt", torch.float32): "tt_rows_kernel<float>",
               ("tt", torch.bfloat16): "tt_rows_kernel<bf16>"}
_MANGLED = {"flash_kernel": "12flash_kernelI", "flash_tc_kernel": "15flash_tc_kernelI",
            "tt_rows_kernel<float>": "14tt_rows_kernelIf",
            "tt_rows_kernel<bf16>": "14tt_rows_kernelI13__nv_bfloat16"}


def tensor_core_sass(build) -> dict:
    """HGMMA and HMMA instructions in the built libraries (``cuobjdump
    -sass``), summed over each body's instances: the proof that K9's bf16
    body runs on the tensor cores (the script fails if it has none; the
    K2/K5 bodies compute in fp32 on the CUDA cores in both types)."""
    out = {}
    for src, kind in (("flash_attention", "flash"), ("tt_bag", "tt")):
        counts = build.sass_counts(src)
        out[src] = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = SASS_KERNEL[kind, dtype]
            out[src][name] = {op: sum(c[op] for fn, c in counts.items() if _MANGLED[name] in fn)
                              for op in ("HGMMA", "HMMA")}
            log(f"[sass] {src}.cu {name}: {out[src][name]}")
    tc = out["flash_attention"][SASS_KERNEL["flash", torch.bfloat16]]
    if tc["HGMMA"] + tc["HMMA"] <= 0:
        raise AssertionError("flash_attention: the bf16 body has no tensor-core instruction")
    return out


def timed(fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after ``warm``."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times (CUDA events), so the host's per-call work (the
    wrapper's checks, the ctypes call) does not gate the launches as it does
    in ``timed`` for kernels of a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = timed(graph.replay, reps) / calls
    del graph
    return ms


# ---------------------------------------------------------------------------
# phase 2: the card against the CPU on small inputs
# ---------------------------------------------------------------------------

def reference_phase(dev, serve_rec, registry, dlrm, synthetic) -> None:
    for arch in ("dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"):
        cfg = registry.get_dlrm(arch)
        params_cpu = dlrm.init_dlrm(cfg, seed=1, device="cpu")
        params_gpu = {k: [{n: v.to(dev) for n, v in p.items()} for p in layers]
                      for k, layers in params_cpu.items()}
        data = [synthetic.dlrm_batch(cfg, 16, seed=0, step=t) for t in range(4)]
        res = {}
        for where, params in (("cpu", params_cpu), ("gpu", params_gpu)):
            res[where] = serve_rec.run_pipeline(
                cfg, mode="sequential", params=params, data=data,
                device="cpu" if where == "cpu" else dev)
        err = max(float(np.abs(a - b).max())
                  for a, b in zip(res["cpu"]["logits"], res["gpu"]["logits"]))
        # bf16 head on two kinds of hardware: products may round one step apart
        if err > 5e-2 or res["cpu"]["hit_rate"] != res["gpu"]["hit_rate"]:
            raise AssertionError(f"{arch}: card vs CPU logits differ by {err}")
        log(f"[reference] {arch}: card vs CPU max |logit diff| {err:.3e}, "
            f"hit rate {res['gpu']['hit_rate']:.4f} on both")


def cached_reference_phase(dev, registry, dlrm, synthetic, qr_embedding, engine) -> None:
    """``cached_lookup`` on one smoke table, card against CPU, fed the same
    scheduler slots: the CPU runs the plain version, the card K4b / K4a."""
    for arch in ("dlrm-qr-smoke", "dlrm-dense-smoke"):
        cfg = registry.get_dlrm(arch)
        bag = dlrm.make_bags(cfg)[0]
        params = qr_embedding.init(bag.emb, generator=torch.Generator().manual_seed(2),
                                   device="cpu")
        eng = engine.engine_for(engine.EngineSpec.from_bags([bag], cache_slots=cfg.cache_slots))
        sched = eng.fresh_schedulers()[0]
        idx = synthetic.zipf_batch(cfg.vocab_per_table, (16, cfg.pooling), seed=3)
        rows = engine.big_rows(idx.numpy(), bag.emb)
        sched.prefetch(rows)
        slot = torch.from_numpy(sched.slots_for(rows))
        cache_rows = torch.from_numpy(sched.cache_rows())
        out = {}
        for where in ("cpu", dev):
            to = lambda t: t.to(where)
            out[str(where)] = eng.cached_lookup(
                {k: to(v) for k, v in params.items()}, to(idx), 0,
                cache_rows=to(cache_rows), slot=to(slot)).cpu()
        err = float((out["cpu"] - out[str(dev)]).abs().max())
        if not err <= ERR_TOL:
            raise AssertionError(f"{arch}: cached_lookup card vs CPU differ by {err}")
        log(f"[reference] {arch} cached_lookup: card vs CPU max abs diff {err:.3e}, "
            f"hit share {float((slot >= 0).float().mean()):.3f}")


# ---------------------------------------------------------------------------
# phase 3: the kernels at the main path's shapes
# ---------------------------------------------------------------------------

def plan_slots(cfg, layout) -> int:
    """The plan's cache-slot total: ``cache_slots`` per table, clamped so the
    block fits ``cache_vmem_mb`` (``tune/knobs.py:slot_budgets``)."""
    return min(cfg.cache_slots * cfg.num_tables,
               cfg.cache_vmem_mb * 2**20 // (layout.big_width * 4))


def main_path_streams(cfg, layout, pt, synthetic, dev, *, batch):
    """One full-width batch's packed (G, K) streams, with this batch's most
    used big-table rows staged in the cache block, as many as the plan has
    slots (the prefetcher's rule, applied to the packed buffer)."""
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=11, step=0, device=dev)
    streams = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    big = streams[{"qr": "q_idx", "tt": "i2"}.get(layout.kind, "idx")]
    streams["slot"], top = top_slots(big, layout.total_rows + 1, plan_slots(cfg, layout))
    return streams, top


def top_slots(big: torch.Tensor, rows: int, slots: int):
    """The batch's ``slots`` most used rows of a (B, K) stream, staged as the
    cache block: (slot stream, staged row ids)."""
    counts = torch.bincount(big.reshape(-1).long(), minlength=rows)
    top = torch.topk(counts, slots).indices
    slot_of = torch.full_like(counts, -1)
    slot_of[top] = torch.arange(slots, device=big.device)
    return slot_of[big.long()].to(torch.int32), top


def bound(streams, read_bytes: int, out_bytes: int, flops: int, *,
          flop_s: float = FP32_FLOP_S):
    """(bound_ms, bound_by, bytes): each input byte read once (the index
    streams, plus ``read_bytes`` of unique rows this batch touches), each
    output byte written once; ``flops`` over the peak ``flop_s`` of their
    type (fp32 by default)."""
    nbytes = sum(s.numel() * 4 for s in streams) + read_bytes + out_bytes
    t_bytes, t_ops = nbytes / BW_BYTES_S, flops / flop_s
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def unique(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


BF16_ULP = 2.0 ** -8    # rounding to nearest bf16 moves a value by at most 2^-8 of it
ROUND_ATOL = 1e-5       # of the output's scale: the fp32 sums' order, kernel against plain
ROUND_RULE = "|out - plain fp32| <= 2^-8 |plain fp32| + 1e-5 max|plain fp32|"


def one_rounding(out: torch.Tensor, plain32: torch.Tensor) -> tuple[float, float]:
    """A bf16 ``out`` against the plain version computed in fp32 on the same
    inputs: (worst ratio of |out - plain32| to 2^-8 |plain32| + ROUND_ATOL x
    max|plain32|, max abs error).  A kernel that computes in fp32 and rounds
    its output once reads <= 1; a dropped or misweighted term reads far
    above."""
    p = plain32.float()
    d = (out.float() - p).abs()
    atol = max(ROUND_ATOL * float(p.abs().max()), 1e-30)
    return float((d / (p.abs() * BF16_ULP + atol)).max()), float(d.max())


def hold(name: str, got: torch.Tensor, plain, args) -> dict:
    """Hold a kernel's output against its plain version on the same inputs:
    fp32 to ``ERR_TOL`` max abs error; bf16 per element within one rounding
    of the plain version computed in fp32 on the inputs widened exactly
    (``one_rounding``).  Returns the row's error keys."""
    if got.dtype == torch.float32:
        err = float((got - plain(*args)).abs().max())
        if not err <= ERR_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error {err}")
        return {"max_abs_err": err, "tolerance": ERR_TOL}
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ratio, err = one_rounding(got, plain(*wide))
    if got.dtype != torch.bfloat16 or not ratio <= 1.0:
        raise AssertionError(f"{name}: {got.dtype}, max |kernel - plain fp32| {err}, "
                             f"{ratio} of one bf16 rounding")
    return {"max_abs_err": err, "rounding_ratio": ratio, "tolerance": ROUND_RULE}


def fmt_err(c: dict) -> str:
    return f"err {c['max_abs_err']:.3e}" + (
        f" ({c['rounding_ratio']:.3f} of one bf16 rounding)" if "rounding_ratio" in c else "")


def staged(cfg, layout, pt, synthetic, dev, batch: int, dtype, big: torch.Tensor):
    """The packed (G, K) streams and cache block a packed kernel gets on its
    path: serving (fp32) stages the batch's most used rows of ``big``, as
    many as the plan has slots (``main_path_streams``); the training lookup
    (bf16, ``packed_multi_bag_lookup``) passes all-miss slots and a 1-row
    zero cache."""
    if dtype == torch.float32:
        s, top = main_path_streams(cfg, layout, pt, synthetic, dev, batch=batch)
        return s, big[top]
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=14, step=0, device=dev)
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    return s, pt.dummy_cache(layout, dtype, dev)


def bag_case(dev, name, batch, dtype, registry, dlrm, synthetic, pt, pg, ref) -> dict:
    """K1 ``packed_qr_bag`` or K3 ``packed_bag`` on the packed streams and
    cache block their path gives them (``staged``): serving in fp32 (dlrm-qr,
    full dlrm-dense), training in bf16 (train_8k, dlrm-dense at 200k rows).
    Returns the call's pieces: the arguments and their all-miss variant, the
    kernel, its plain version, the library call, and what the bound counts."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(5 if name == "packed_qr_bag" else 6)
    train = dtype != torch.float32
    arch = "dlrm-qr" if name == "packed_qr_bag" else "dlrm-dense"
    cfg = train_config(arch, registry) if train else registry.get_dlrm(arch)
    layout = pt.build_layout(dlrm.make_bags(cfg))
    dim = cfg.dim
    big = torch.empty((layout.total_rows + 1, dim), device=dev)
    big = big.normal_(generator=g).mul_(dim ** -0.5).to(dtype)
    s, cache = staged(cfg, layout, pt, synthetic, dev, batch, dtype, big)
    miss = torch.full_like(s["slot"], -1)
    hit = s["slot"] >= 0
    c = {"name": name, "cfg": cfg, "layout": layout, "big": big, "cache": cache, "s": s,
         "hit": hit, "dim": dim, "dtype": dtype, "tables": cfg.num_tables}
    if name == "packed_qr_bag":
        r_lut = torch.randn((layout.total_small + 1, dim), generator=g, device=dev).to(dtype)
        c.update(
            args=(big, cache, r_lut, s["q_idx"], s["slot"], s["r_idx"]),
            miss_args=(big, cache, r_lut, s["q_idx"], miss, s["r_idx"]),
            kern=lambda *a: pg.packed_qr_bag(*a, tables=cfg.num_tables),
            plain=ref.packed_qr_bag_ref, r_lut=r_lut,
            library=lambda: (F.embedding_bag(s["q_idx"], big, mode="sum")
                             + F.embedding_bag(s["r_idx"], r_lut, mode="sum")),
            library_call="embedding_bag(Q) + embedding_bag(R), all-miss stream",
            rows_read=(unique(s["q_idx"][~hit]) + unique(s["slot"][hit])
                       + unique(s["r_idx"])),
            streams=(s["q_idx"], s["slot"], s["r_idx"]),
            adds=2 * s["q_idx"].numel() * dim,
            # rows each element requests: its table (or cache) row and its R row
            element_rows=2 * s["q_idx"].numel())
    else:
        c.update(
            args=(big, cache, s["idx"], s["slot"]),
            miss_args=(big, cache, s["idx"], miss),
            kern=lambda *a: pg.packed_bag(*a, tables=cfg.num_tables),
            plain=ref.packed_bag_ref,
            library=lambda: F.embedding_bag(s["idx"], big, mode="sum"),
            library_call="embedding_bag(T), all-miss stream",
            rows_read=unique(s["idx"][~hit]) + unique(s["slot"][hit]),
            streams=(s["idx"], s["slot"]),
            adds=s["idx"].numel() * dim, element_rows=s["idx"].numel())
    return c


def hot_args(c: dict) -> tuple:
    """The case's arguments with every table index folded onto the first
    256 rows: the same requests, all served by L2 (the profile's probe of
    whether device memory binds)."""
    a = list(c["args"])
    pos = 3 if c["name"] == "packed_qr_bag" else 2
    a[pos] = torch.remainder(a[pos], 256).to(torch.int32)
    return tuple(a)


def bag_profile(c: dict, ms: float, bound_bytes: int, kern=None) -> dict:
    """Readings of a bag body at one shape, in place of a profiler's (no
    Nsight on the card's machine): the unique bytes' rate as a share of the
    HBM peak; the rate of row requests (each element's table or cache row,
    and for K1 its R row, whoever serves them: L1, L2 or memory); and the
    time with every table request folded onto 256 rows that stay in cache
    (``hot_args``).  Hot time near the real time: device memory does not
    bind, the body's own issue and load latency do."""
    kern = kern or c["kern"]
    elem = torch.finfo(c["dtype"]).bits // 8
    req_bytes = c["element_rows"] * c["dim"] * elem
    hot = hot_args(c)
    hot_ms = timed(lambda: kern(*hot), 50)
    return {"ms": ms, "dram_share": bound_bytes / (ms * 1e-3) / BW_BYTES_S,
            "request_bytes": req_bytes, "request_tb_s": req_bytes / (ms * 1e-3) / 1e12,
            "hot_ms": hot_ms, "hot_ratio": hot_ms / ms}


def fmt_profile(p: dict) -> str:
    return (f"profile: unique bytes at {100 * p['dram_share']:.1f}% of the HBM peak, row "
            f"requests {p['request_tb_s']:.2f} TB/s, all-in-cache probe {p['hot_ms']:.4f} ms "
            f"({p['hot_ratio']:.3f} of the real time)")


def kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref, *,
                 dtype=torch.float32) -> list[dict]:
    """K1 ``packed_qr_bag`` and K3 ``packed_bag`` on the packed streams and
    cache block their path gives them (``bag_case``), held against their
    plain versions (``hold``), timed beside the bound and ``embedding_bag``,
    and profiled (``bag_profile``)."""
    out = []
    train = dtype != torch.float32
    elem = torch.finfo(dtype).bits // 8
    for name in ("packed_qr_bag", "packed_bag"):
        c = bag_case(dev, name, batch, dtype, registry, dlrm, synthetic, pt, pg, ref)
        kern, plain, args, s, hit = c["kern"], c["plain"], c["args"], c["s"], c["hit"]
        got = kern(*args)
        torch.cuda.synchronize()
        checked = hold(name, got, plain, args)
        if not train:
            # the library sums in its own order: held in fp32 only
            lib_err = float((kern(*c["miss_args"]) - c["library"]()).abs().max())
            if not lib_err <= ERR_TOL:
                raise AssertionError(f"{name}: all-miss kernel vs library {lib_err}")
        bound_ms, bound_by, nbytes = bound(c["streams"], c["rows_read"] * c["dim"] * elem,
                                           got.numel() * elem, c["adds"],
                                           flop_s=BF16_FLOP_S if train else FP32_FLOP_S)
        row = {
            "name": name + ("_bf16" if train else ""), "route": "cuda",
            "source": "src/repro_torch/csrc/packed_gather.cu",
            "replaces": ("src/repro/kernels/packed_gather.py:130 -> cached_gather.py:123"
                         if name == "packed_qr_bag" else
                         "src/repro/kernels/packed_gather.py:103 -> cached_gather.py:82"),
            "launches": 0, **checked,
            "ms": timed(lambda: kern(*args), 50),
            "device_ms": graph_ms(lambda: kern(*args)),
            "plain_ms": timed(lambda: plain(*args), 3, warm=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed(c["library"], 20),
            "library_call": c["library_call"],
            "all_miss_ms": timed(lambda: kern(*c["miss_args"]), 50),
            "bytes": nbytes, "hit_share": float(hit.float().mean()),
            "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": c["dim"],
                      "tables": c["tables"], "rows": c["big"].shape[0],
                      "slots": c["cache"].shape[0], "dtype": str(dtype).replace("torch.", "")},
        }
        row["kernel_ms"] = row["ms"]
        row["profile"] = bag_profile(c, row["ms"], nbytes)
        log(f"[kernels] {row['name']}: {fmt_err(checked)}, kernel {row['ms']:.4f} ms "
            f"(earlier {fmt_range(EARLIER_MS[row['name']])} ms; in a CUDA graph "
            f"{row['device_ms']:.4f} ms), "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), "
            f"hit share {row['hit_share']:.3f}; {fmt_profile(row['profile'])}")
        out.append(row)
        del c, args, got, s
        torch.cuda.empty_cache()
    return out


TT_LIBRARY = ("none: no one PyTorch call computes a TT bag (a gather of three "
              "cores, two chained per-lookup products, then a pooled sum)")


def tt_bound(spec, streams, i1, i2_miss, hit_slots, i3, out_rows: int, *, elem: int = 4,
             flop_s: float = FP32_FLOP_S):
    """Bound of a TT bag: 20,480 flops per dlrm-tt lookup (two products of
    FMAs), bytes of the streams, the unique G2 / cache, G1 and G3 rows this
    run touches, and the output, ``elem`` bytes a value."""
    d1, d2, d3, r = spec.dims
    lookups = i1.numel()
    flops = 2 * lookups * (d1 * r * d2 * r + d1 * d2 * r * d3)
    read = ((unique(i2_miss) + unique(hit_slots)) * spec.g2_width
            + unique(i1) * spec.g1_width + unique(i3) * spec.g3_width) * elem
    return bound(streams, read, out_rows * spec.dim * elem, flops, flop_s=flop_s)


def chunked(fn, cores, streams, dims, chunk: int = 4096):
    """The plain version over G in chunks of ``chunk`` bags: gathering every
    lookup's 8 KiB G2 row at once would take ~14 GB at full width."""
    g = streams[0].shape[0]
    return torch.cat([fn(*cores, *(s[i:i + chunk] for s in streams), dims=dims)
                      for i in range(0, g, chunk)])


def tt_rows(i2: torch.Tensor, slot, cache_rows: int) -> tuple[int, int]:
    """(distinct middle-core rows, elements) of a TT bag's streams: the
    sources the sorted-run body stages, a cache slot or a G2 row each."""
    key = i2.reshape(-1).long()
    if slot is not None:
        key = torch.where(slot.reshape(-1) >= 0, slot.reshape(-1).long(), key + cache_rows)
    return unique(key), key.numel()


def tt_design(tg, dtype, sass: dict, rows: tuple[int, int]) -> dict:
    """The TT row's design keys: the body that ran, its tensor-core
    instructions in the built library, and the batch's distinct middle-core
    rows and elements per row."""
    distinct, elements = rows
    return {"body": tg.BODY[dtype], "sass": sass["tt_bag"][SASS_KERNEL["tt", dtype]],
            "distinct_middle_rows": distinct, "elements": elements,
            "elements_per_row": elements / max(distinct, 1)}


def scratch_floor_ms(values: int) -> float:
    """The sorted-run body's own floor: its fp32 scratch written once and
    read once at the HBM rate (for the log, beside the bound)."""
    return 2 * values * 4 / BW_BYTES_S * 1e3


def fmt_range(r) -> str:
    return f"{r[0]:.4f}-{r[1]:.4f}"


def fmt_design(k: dict) -> str:
    return (f"body {k['body']}, SASS {k['sass']}, {k['distinct_middle_rows']} distinct middle "
            f"rows, {k['elements_per_row']:.1f} elements a row")


def tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                    sass: dict, *, dtype=torch.float32) -> list[dict]:
    """K2 on the packed streams and cache block its path gives it
    (``staged``) and K5 on one table's cores as ``tt_embedding.lookup``
    calls it (65,536 lookups of K = 1) and pooled (2,048 x 32); each held
    against its plain version (``hold``) and timed.  In bf16 the bound
    counts bf16 bytes and the flops over the bf16 tensor-core peak (the
    least time the card could take; the kernel computes in fp32 on the CUDA
    cores)."""
    from repro_torch.configs.base import DLRM_SHAPES

    cfg = registry.get_dlrm("dlrm-tt")
    bags = dlrm.make_bags(cfg)
    spec = bags[0].emb.tt_spec
    dims = spec.dims
    layout = pt.build_layout(bags)
    train = dtype != torch.float32
    suffix = "_bf16" if train else ""
    elem, flop_s = (2, BF16_FLOP_S) if train else (4, FP32_FLOP_S)
    params = dlrm.init_dlrm(cfg, seed=5, device=dev)          # cores at init scale
    packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    s, cache = staged(cfg, layout, pt, synthetic, dev, batch, dtype, packed["g2"])
    args = (packed["g1"], packed["g2"], packed["g3"], cache,
            s["i1"], s["i2"], s["i3"], s["slot"])
    kern = lambda *a: pg.packed_tt_bag(*a, dims=dims)
    plain = lambda *a: chunked(ref.packed_tt_bag_ref, a[:4], a[4:], dims)
    hit = s["slot"] >= 0
    got = kern(*args)
    torch.cuda.synchronize()
    checked = hold("packed_tt_bag" + suffix, got, plain, args)
    bound_ms, bound_by, nbytes = tt_bound(spec, args[4:], s["i1"], s["i2"][~hit],
                                          s["slot"][hit], s["i3"], got.shape[0],
                                          elem=elem, flop_s=flop_s)
    k2 = {
        "name": "packed_tt_bag" + suffix, "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/packed_gather.py:158",
        "launches": 0, **checked,
        "ms": timed(lambda: kern(*args), 5 if train else 20),
        "plain_ms": timed(lambda: plain(*args), 1 if train else 3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": nbytes, "hit_share": float(hit.float().mean()),
        "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": spec.dim,
                  "rows": packed["g2"].shape[0], "slots": cache.shape[0],
                  "dims": list(dims), "dtype": str(dtype).replace("torch.", "")},
    }
    k2["kernel_ms"] = k2["ms"]
    k2.update(tt_design(tg, dtype, sass, tt_rows(s["i2"], s["slot"], cache.shape[0])))
    floor = scratch_floor_ms(got.shape[0] * s["slot"].shape[1] * spec.dim)
    log(f"[kernels] {k2['name']}: {fmt_err(checked)}, kernel {k2['ms']:.4f} ms "
        f"(earlier {fmt_range(EARLIER_MS[k2['name']])} ms), plain {k2['plain_ms']:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}, {nbytes} B), scratch floor {floor:.4f} "
        f"ms, hit share {k2['hit_share']:.3f}; {fmt_design(k2)}")
    del got, packed, cache, args, s

    # K5 on table 0's cores: the lookup path (K = 1) and one pooled batch
    one = tuple(params["tables"][0][n].to(dtype) for n in ("g1", "g2", "g3"))
    lookup_batch = DLRM_SHAPES[0].global_batch              # tt_embedding.lookup's (2,048, 32)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (lookup_batch, cfg.pooling), seed=12,
                               step=0, device=dev)
    pooled = tt_embedding.tt_decompose(idx, spec)
    lookups = tuple(x.reshape(-1, 1) for x in pooled)
    kern5 = lambda *a: tg.tt_bag(*a, dims=dims)
    plain5 = lambda *a: ref.tt_bag_ref(*a, dims=dims)
    rows = {}
    for shape, st in (("lookup", lookups), ("pooled", pooled)):
        out = kern5(*one, *st)
        torch.cuda.synchronize()
        c = hold(f"tt_bag{suffix} ({shape})", out, plain5, (*one, *st))
        b_ms, b_by, nb = tt_bound(spec, st, st[0], st[1], st[1][:0], st[2], out.shape[0],
                                  elem=elem, flop_s=flop_s)
        rows[shape] = dict(checked=c, bound_ms=b_ms, bound_by=b_by, bytes=nb,
                           ms=timed(lambda: kern5(*one, *st), 20),
                           plain_ms=timed(lambda: plain5(*one, *st), 3, warm=1),
                           rows=tt_rows(st[1], None, 0))
    lk, pl = rows["lookup"], rows["pooled"]
    worst = max((lk["checked"], pl["checked"]),
                key=lambda c: c.get("rounding_ratio", c["max_abs_err"]))
    k5 = {
        "name": "tt_bag" + suffix, "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/tt_gather.py:64",
        "launches": 0, **worst,
        "max_abs_err": max(lk["checked"]["max_abs_err"], pl["checked"]["max_abs_err"]),
        "ms": lk["ms"], "plain_ms": lk["plain_ms"],
        "bound_ms": lk["bound_ms"], "bound_by": lk["bound_by"],
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": lk["bytes"],
        "pooled_ms": pl["ms"], "pooled_plain_ms": pl["plain_ms"],
        "pooled_bound_ms": pl["bound_ms"], "pooled_bound_by": pl["bound_by"],
        "shape": {"lookup": [lookups[0].shape[0], 1], "pooled": list(pooled[0].shape),
                  "dim": spec.dim, "rows": one[1].shape[0], "dims": list(dims),
                  "dtype": str(dtype).replace("torch.", "")},
    }
    k5["kernel_ms"] = k5["ms"]
    k5.update(tt_design(tg, dtype, sass, lk["rows"]))
    k5["pooled_distinct_middle_rows"] = pl["rows"][0]
    k5["pooled_elements_per_row"] = pl["rows"][1] / max(pl["rows"][0], 1)
    log(f"[kernels] {k5['name']}: {fmt_err(k5)}; lookup ({lookups[0].shape[0]} x 1) "
        f"kernel {lk['ms']:.4f} ms (earlier {fmt_range(EARLIER_MS[k5['name']])} ms), plain "
        f"{lk['plain_ms']:.4f} ms, bound {lk['bound_ms']:.4f} ms ({lk['bound_by']}); pooled "
        f"({lookup_batch} x {cfg.pooling}) kernel {pl['ms']:.4f} ms, plain "
        f"{pl['plain_ms']:.4f} ms, bound {pl['bound_ms']:.4f} ms ({pl['bound_by']}), "
        f"{pl['rows'][0]} distinct middle rows; lookup {fmt_design(k5)}")
    del params, one
    torch.cuda.empty_cache()
    return [k2, k5]


# (name, dims): the train-DLRM example's tables at rank 64 (dim 64) and
# dlrm-tt's at rank 64 (dim 128), where a middle-core row (64 / 128 KiB of
# fp32) does not fit a block twice: K2 and K5 stage it in d2 slices
RANK64 = (("train-dlrm example, rank 64", (4, 4, 4, 64)), ("dlrm-tt, rank 64", (4, 8, 4, 64)))
RANK64_BATCH = 256


def tt_rank64_phase(dev, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                    train_dlrm) -> list[dict]:
    """K2 (packed, the path's slots: a staged cache in fp32, all miss in
    bf16) and K5 (one table's lookups, K = 1) at rank 64, dims 64 and 128,
    fp32 and bf16, at batch ``RANK64_BATCH``: each output held against the
    plain version (``hold``) and read for bitwise equality with it (at dim
    64 the plain version's second product does not sum its depth in order
    on the card), timed beside it and the bound."""
    rows = []
    for name, dims in RANK64:
        base = (train_dlrm.config("tt", dims[3]) if dims[:3] == (4, 4, 4) else
                registry.get_dlrm("dlrm-tt").replace(tt_rank=dims[3]))
        bags = dlrm.make_bags(base)
        spec = bags[0].emb.tt_spec
        assert spec.dims == dims, (spec.dims, dims)
        layout = pt.build_layout(bags)
        tables = dlrm.init_dlrm(base, seed=5, device=dev)["tables"]
        for dtype in (torch.float32, torch.bfloat16):
            packed = pt.pack_params(tables, layout, dtype=dtype)
            s, cache = staged(base, layout, pt, synthetic, dev, RANK64_BATCH, dtype,
                              packed["g2"])
            args = (packed["g1"], packed["g2"], packed["g3"], cache,
                    s["i1"], s["i2"], s["i3"], s["slot"])
            one = tuple(tables[0][n].to(dtype) for n in ("g1", "g2", "g3"))
            idx = synthetic.zipf_batch(base.vocab_per_table, (RANK64_BATCH, base.pooling),
                                       seed=12, step=0, device=dev)
            look = tuple(x.reshape(-1, 1) for x in tt_embedding.tt_decompose(idx, spec))
            elem, flop_s = (4, FP32_FLOP_S) if dtype == torch.float32 else (2, BF16_FLOP_S)
            for kernel, kern, plain, a, st in (
                    ("packed_tt_bag", lambda *a: pg.packed_tt_bag(*a, dims=dims),
                     lambda *a: chunked(ref.packed_tt_bag_ref, a[:4], a[4:], dims, 256),
                     args, args[4:]),
                    ("tt_bag", lambda *a: tg.tt_bag(*a, dims=dims),
                     lambda *a: chunked(ref.tt_bag_ref, a[:3], a[3:], dims, 4096),
                     (*one, *look), look)):
                got = kern(*a)
                torch.cuda.synchronize()
                checked = hold(f"{kernel} {name}", got, plain, a)
                bitwise = bool(torch.equal(got, plain(*a)))
                if kernel == "packed_tt_bag":
                    hit = st[3] >= 0
                    g2_rows, slots = st[1][~hit], st[3][hit]
                else:
                    g2_rows, slots = st[1], st[1][:0]
                b_ms, b_by, nbytes = tt_bound(spec, st, st[0], g2_rows, slots, st[2],
                                              got.shape[0], elem=elem, flop_s=flop_s)
                r = {"kernel": kernel, "case": name, "dims": list(dims),
                     "dtype": str(dtype).replace("torch.", ""),
                     "stage_width": tg.staging(dims, dtype), "G": st[0].shape[0],
                     "K": st[0].shape[1], **checked, "bitwise": bitwise,
                     "ms": timed(lambda: kern(*a), 5),
                     "plain_ms": timed(lambda: plain(*a), 1, warm=0),
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
                log(f"[kernels] {kernel} {name} {r['dtype']} (G {r['G']}, K {r['K']}, d2 "
                    f"stage {r['stage_width']} of {dims[1]}): {fmt_err(checked)}, bitwise the "
                    f"plain version: {bitwise}, kernel "
                    f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                    f"({b_by})")
                rows.append(r)
            del packed, cache, args, s, one, got
            torch.cuda.empty_cache()
        del tables
        torch.cuda.empty_cache()
    return rows


def rank64_example_run(mods, train_dlrm) -> int:
    """``python -m repro_torch.examples.train_dlrm --embedding tt --tt-rank
    64`` on the card, cut to 25 steps: K2 bf16 launches once a step and once
    for the held-out evaluation, and the losses are finite."""
    reset_all(mods)
    t0 = time.perf_counter()
    res = train_dlrm.main(["--embedding", "tt", "--tt-rank", "64", "--steps", "25"])
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if counts["packed_tt_bag"] != 26 or sum(counts.values()) != 26 or not all(
            np.isfinite(v) for v in res.values()):
        raise AssertionError(f"train_dlrm --tt-rank 64: launches {counts}, result {res}")
    log(f"[train] examples.train_dlrm --embedding tt --tt-rank 64 --steps 25: loss "
        f"{res['train_loss']:.4f}, held-out loss {res['loss']:.4f}, AUC {res['auc']:.4f}, "
        f"packed_tt_bag launched {counts['packed_tt_bag']} times, "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return counts["packed_tt_bag"]


def pertable_kernel_phase(dev, batch, registry, dlrm, synthetic, hashing, qr_embedding, ref,
                          cg, gb, qg) -> list[dict]:
    """K4b, K6, K8 on dlrm-qr table 0's shapes and K4a, K7 on dlrm-dense
    table 0's, each held against its plain version and timed beside its
    bound and the one PyTorch call that computes the same function."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    rows_out = []

    def row(name, kern, plain, args, *, replaces, streams, rows_read, out_numel, adds,
            library, library_call, check_library, bf16=None, **extra):
        got = kern(*args)
        torch.cuda.synchronize()
        err = float((got - plain(*args)).abs().max())
        lib_err = float((check_library() - library()).abs().max())
        if not err <= ERR_TOL or not lib_err <= ERR_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error {err}, "
                                 f"kernel vs library {lib_err}")
        b_ms, b_by, nbytes = bound(streams, rows_read * extra["shape"]["dim"] * 4,
                                   out_numel * 4, adds)
        r = {"name": name, "route": "cuda", "source": (
                 "src/repro_torch/csrc/qr_gather.cu" if name == "qr_gather"
                 else "src/repro_torch/csrc/packed_gather.cu"),
             "replaces": replaces, "launches": 0, "max_abs_err": err,
             "ms": timed(lambda: kern(*args), 50),
             "device_ms": graph_ms(lambda: kern(*args)),
             "plain_ms": timed(lambda: plain(*args), 3, warm=1),
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": timed(library, 20), "library_call": library_call,
             "bytes": nbytes, **extra}
        if bf16 is not None:
            hargs = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
            hgot = kern(*hargs)
            torch.cuda.synchronize()
            hc = hold(f"{name} bf16", hgot, plain, hargs)
            r["bf16_max_abs_err"] = hc["max_abs_err"]
            r["bf16_rounding_ratio"] = hc["rounding_ratio"]
            r["bf16_tolerance"] = hc["tolerance"]
            r["bf16_ms"] = timed(lambda: kern(*hargs), 50)
            r["bf16_device_ms"] = graph_ms(lambda: kern(*hargs))
        r["kernel_ms"] = r["ms"]
        log(f"[kernels] {name}: err {err:.3e}, kernel {r['ms']:.4f} ms"
            + (f" (earlier {fmt_range(EARLIER_MS[name])} ms)" if name in EARLIER_MS else "")
            + f", in a CUDA graph {r['device_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nbytes} B)"
            + (f", bf16 {r['bf16_ms']:.4f} ms (graph {r['bf16_device_ms']:.4f}) err "
               f"{r['bf16_max_abs_err']:.3e} "
               f"({r['bf16_rounding_ratio']:.3f} of one bf16 rounding)"
               if bf16 is not None else ""))
        rows_out.append(r)

    # dlrm-qr table 0: K4b, K6, K8
    cfg = registry.get_dlrm("dlrm-qr")
    emb = dlrm.make_bags(cfg)[0].emb
    scale = emb.dim ** -0.5
    q_rows = qr_embedding._pad_rows(emb.qr_spec.q_rows)         # 31,360
    q = torch.randn((q_rows, emb.dim), generator=g, device=dev).mul_(scale)
    r_lut = torch.randn((emb.collision, emb.dim), generator=g, device=dev).mul_(scale)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=11,
                               device=dev)
    q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
    slots = min(cfg.cache_slots, cfg.cache_vmem_mb * 2**20 // (emb.dim * 4))
    slot, top = top_slots(q_idx, q.shape[0], slots)
    cache = q[top]
    hit = slot >= 0
    miss = torch.full_like(slot, -1)
    two_bags = lambda: (F.embedding_bag(q_idx, q, mode="sum")
                        + F.embedding_bag(r_idx, r_lut, mode="sum"))
    shape = {"B": batch, "K": cfg.pooling, "dim": emb.dim, "q_rows": q.shape[0],
             "r_rows": r_lut.shape[0]}
    row("cached_qr_bag", cg.cached_qr_bag, ref.cached_qr_bag_ref,
        (q, cache, r_lut, q_idx, slot, r_idx),
        replaces="src/repro/kernels/cached_gather.py:123",
        streams=(q_idx, slot, r_idx),
        rows_read=unique(q_idx[~hit]) + unique(slot[hit]) + unique(r_idx),
        out_numel=batch * emb.dim, adds=2 * q_idx.numel() * emb.dim,
        library=two_bags, library_call="embedding_bag(Q) + embedding_bag(R), all-miss stream",
        check_library=lambda: cg.cached_qr_bag(q, cache, r_lut, q_idx, miss, r_idx),
        hit_share=float(hit.float().mean()), shape={**shape, "slots": slots})
    row("gnr_bag", gb.gnr_bag, ref.gnr_bag_ref, (q, r_lut, q_idx, r_idx),
        replaces="src/repro/kernels/gnr_bag.py:63", streams=(q_idx, r_idx),
        rows_read=unique(q_idx) + unique(r_idx), out_numel=batch * emb.dim,
        adds=2 * q_idx.numel() * emb.dim, library=two_bags,
        library_call="embedding_bag(Q) + embedding_bag(R)",
        check_library=lambda: gb.gnr_bag(q, r_lut, q_idx, r_idx), bf16=True, shape=shape)
    qf, rf = q_idx.reshape(-1), r_idx.reshape(-1)
    row("qr_gather", qg.qr_gather, ref.qr_lookup_ref, (q, r_lut, qf, rf),
        replaces="src/repro/kernels/qr_gather.py:42", streams=(qf, rf),
        rows_read=unique(qf) + unique(rf), out_numel=qf.numel() * emb.dim,
        adds=qf.numel() * emb.dim,
        library=lambda: F.embedding(qf, q) + F.embedding(rf, r_lut),
        library_call="embedding(Q) + embedding(R)",
        check_library=lambda: qg.qr_gather(q, r_lut, qf, rf), bf16=True,
        shape={**shape, "N": qf.numel()})
    del q, r_lut, cache

    # dlrm-dense table 0: K4a, K7
    cfg = registry.get_dlrm("dlrm-dense")
    table = torch.randn((cfg.vocab_per_table, cfg.dim), generator=g, device=dev)
    table.mul_(cfg.dim ** -0.5)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=12,
                               device=dev)
    slot, top = top_slots(idx, table.shape[0], slots)
    cache = table[top]
    hit = slot >= 0
    miss = torch.full_like(slot, -1)
    one_bag = lambda: F.embedding_bag(idx, table, mode="sum")
    shape = {"B": batch, "K": cfg.pooling, "dim": cfg.dim, "rows": table.shape[0]}
    row("cached_bag", cg.cached_bag, ref.cached_bag_ref, (table, cache, idx, slot),
        replaces="src/repro/kernels/cached_gather.py:82", streams=(idx, slot),
        rows_read=unique(idx[~hit]) + unique(slot[hit]), out_numel=batch * cfg.dim,
        adds=idx.numel() * cfg.dim, library=one_bag,
        library_call="embedding_bag(T), all-miss stream",
        check_library=lambda: cg.cached_bag(table, cache, idx, miss),
        hit_share=float(hit.float().mean()), shape={**shape, "slots": slots})
    row("gnr_bag_dense", gb.gnr_bag_dense, ref.dense_bag_ref, (table, idx),
        replaces="src/repro/kernels/gnr_bag.py:100", streams=(idx,),
        rows_read=unique(idx), out_numel=batch * cfg.dim, adds=idx.numel() * cfg.dim,
        library=one_bag, library_call="embedding_bag(T)",
        check_library=lambda: gb.gnr_bag_dense(table, idx), shape=shape)
    del table, cache
    torch.cuda.empty_cache()
    # the host's cost of one launch through a wrapper: back to back, a
    # one-table bag's time is set by it; in a CUDA graph it is gone
    over = {r["name"]: r["ms"] - r["device_ms"] for r in rows_out if r["name"] != "qr_gather"}
    log("[kernels] launch overhead (back to back - CUDA graph), one-table bags at "
        f"({batch}, {cfg.pooling}): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in over.items())
        + f"; median {float(np.median(list(over.values()))):.4f} ms "
        f"(launch/mesh.py DISPATCH_OVERHEAD_S = {DISPATCH_OVERHEAD_S * 1e3:.4f} ms)")
    return rows_out


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

KERNEL_OF = {"qr": "packed_qr_bag", "dense": "packed_bag", "tt": "packed_tt_bag"}


def reset_counts(pg, tg) -> None:
    pg.reset_launches()
    tg.reset_launches()


def serve_phase(dev, arch, batch, batches, tel_batches, serve_rec, registry, dlrm, synthetic,
                pg, tg, tt_embedding, obs, attribution) -> tuple[dict, dict]:
    """Serve ``arch`` at full width in both modes with telemetry off, then
    once fenced and sequential with it on (``telemetry_run``); returns the
    launches of each kernel over the three runs (and, for TT, of K5 in one
    lookup) and the fenced run's split of a batch."""
    cfg = registry.get_dlrm(arch)
    kernel = KERNEL_OF[cfg.embedding_kind]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    launches = {kernel: 0}
    if cfg.embedding_kind == "tt":
        launches["tt_bag"] = tt_lookup_check(dev, cfg, batch, state, params, synthetic,
                                             tt_embedding, tg, pg)
    packed = state.engine.pack(params.pop("tables"))   # frees the per-table copies
    torch.cuda.empty_cache()
    log(f"[{arch}] offline plan + init + pack {time.perf_counter() - t0:.1f} s, "
        f"packed rows {state.layout.total_rows}, slots {sum(state.slot_budgets)}")
    res = {}
    for mode in ("sequential", "overlap"):
        reset_counts(pg, tg)
        r = serve_rec.run_pipeline(cfg, batch=batch, batches=batches, mode=mode,
                                   state=state, params=params, packed=packed, device=dev)
        n = pg.LAUNCHES[kernel]
        if n != batches:
            raise AssertionError(f"{arch} {mode}: {kernel} launched {n} times "
                                 f"for {batches} batches")
        launches[kernel] += n
        res[mode] = r
        log(f"[{arch}] {mode}: {r['qps']:.1f} QPS, batch latency p50 "
            f"{r['lat_p50_s'] * 1e3:.2f} ms p99 {r['lat_p99_s'] * 1e3:.2f} ms, "
            f"warm-up {r['compile_s']:.2f} s, hit rate {r['hit_rate']:.4f}, "
            f"{kernel} launches {n}, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    for a, b in zip(res["sequential"]["logits"], res["overlap"]["logits"]):
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{arch}: non-finite logits")
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    log(f"[{arch}] overlap == sequential to 1e-6 over {batches} batches of {batch}; "
        f"phase {time.perf_counter() - t0:.1f} s")
    split = telemetry_run(dev, arch, cfg, batch, tel_batches, state, params, packed, serve_rec,
                          obs, attribution, pg, tg, kernel, res)
    launches[kernel] += tel_batches
    # telemetry off and wiped: the profiled run below must record nothing
    obs.registry().reset()
    obs.tracer().reset()
    device_share(arch, lambda: serve_rec.run_pipeline(
        cfg, batch=batch, batches=3, mode="sequential", state=state, params=params,
        packed=packed, device=dev))
    snap = obs.snapshot()
    if snap.counters or snap.histograms or obs.tracer().events:
        raise AssertionError(f"{arch}: telemetry recorded while disabled: "
                             f"{sorted(snap.counters)} {len(obs.tracer().events)} events")
    del packed, params, state
    torch.cuda.empty_cache()
    log(f"[{arch}] phase {time.perf_counter() - t0:.1f} s")
    return launches, split


# every span of a steady-state batch in a fenced sequential run
BATCH_SPANS = {"prefetch", "pack", "h2d", "dispatch", "device_compute", "interact",
               "device_head", "block", "batch"}


def telemetry_run(dev, arch, cfg, batch, batches, state, params, packed, serve_rec, obs,
                  attribution, pg, tg, kernel, unfenced: dict) -> dict:
    """One fenced sequential run with telemetry on, on the state and packed
    buffers of the unfenced runs: every span of each steady-state batch is
    there, ``engine/dispatch/serve_gather`` counts the batches, the kernel
    launches once a batch (the fence adds no launch), the traffic report's
    hit rate is the run's.  Logs the attribution table; returns the split
    of a batch (stage -> ms) beside the unfenced runs' p50."""
    obs.enable()
    try:
        reset_counts(pg, tg)
        r = serve_rec.run_pipeline(cfg, batch=batch, batches=batches, mode="sequential",
                                   state=state, params=params, packed=packed, device=dev,
                                   fence=True)
        n = pg.LAUNCHES[kernel]
        events = list(obs.tracer().events)
        counters = obs.snapshot().counters
    finally:
        obs.disable()
    if n != batches:
        raise AssertionError(f"{arch} fenced: {kernel} launched {n} times for {batches} "
                             f"batches")
    spans: dict = {}
    for ev in events:
        b = ev.get("args", {}).get("batch")
        if ev.get("ph") == "X" and b is not None:
            spans.setdefault(b, set()).add(ev["name"])
    for t in range(1, batches):
        if BATCH_SPANS - spans.get(t, set()):
            raise AssertionError(f"{arch} fenced: batch {t} lacks spans "
                                 f"{sorted(BATCH_SPANS - spans.get(t, set()))}")
    if counters.get("engine/dispatch/serve_gather") != batches:
        raise AssertionError(f"{arch} fenced: serve_gather dispatches "
                             f"{counters.get('engine/dispatch/serve_gather')} != {batches}")
    if r["traffic_report"].hit_rate != r["hit_rate"]:
        raise AssertionError(f"{arch} fenced: traffic hit rate "
                             f"{r['traffic_report'].hit_rate} != {r['hit_rate']}")
    att = attribution.attribute(events, r["traffic_report"], state.eplan, batch=batch,
                                fenced=True)
    log(f"[{arch}] attribution of a fenced sequential run ({batches} batches of {batch}, "
        f"telemetry on): bottleneck {att.bottleneck}, stages {att.total_s * 1e3:.2f} "
        f"ms/batch, p50 {r['lat_p50_s'] * 1e3:.2f} ms (unfenced sequential p50 "
        f"{unfenced['sequential']['lat_p50_s'] * 1e3:.2f} ms); {kernel} launches {n}")
    for line in att.format_table().splitlines():
        log(f"[{arch}] {line}")
    return {
        "config": arch, "batch": batch, "batches": batches, "mode": "sequential",
        "fenced": True, "bottleneck": att.bottleneck,
        "stages_ms": {row.stage: row.measured_s * 1e3 for row in att.rows
                      if row.measured_s is not None},
        "fenced_total_ms": att.total_s * 1e3,
        "fenced_p50_ms": r["lat_p50_s"] * 1e3,
        "unfenced_p50_ms": {m: unfenced[m]["lat_p50_s"] * 1e3
                            for m in ("sequential", "overlap")},
    }


def cli_serve_run(serve_rec, obs) -> int:
    """``serve_rec.main`` on dlrm-qr-smoke on the card with all five
    telemetry flags, both modes; every artifact it writes parses.  Returns
    the launches of K1."""
    from repro_torch.kernels import packed_gather as pg

    out = ROOT / "build" / "serve_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pg.reset_launches()
    try:
        rc = serve_rec.main([
            "--arch", "dlrm-qr", "--smoke", "--mode", "both",
            "--metrics-json", str(out / "metrics.json"), "--trace-out", str(out / "trace.json"),
            "--slo", "p99_ms=50,objective=0.99", "--report", str(out / "report.md"),
            "--flight-dir", str(out / "flight")])
    finally:
        obs.disable()
        obs.install_observatory()
    if rc != 0:
        raise AssertionError(f"serve_rec.main returned {rc}")
    metrics = json.loads((out / "metrics.json").read_text())
    trace = json.loads((out / "trace.json").read_text())
    report = json.loads((out / "report.json").read_text())
    dumps = [json.loads(f.read_text()) for f in sorted((out / "flight").glob("*.json"))]
    if not ((out / "report.md").read_text().startswith("# Serving report")
            and metrics["counters"]["engine/dispatch/serve_gather"] == 12
            and any(e.get("name") == "device_compute" for e in trace["traceEvents"])
            and report["schema"] == "serving-report/v1" and report["attribution"]["fenced"]
            and len(dumps) == len(report["flight_dumps"])):
        raise AssertionError("serve_rec.main: an artifact is missing or malformed")
    n = pg.LAUNCHES["packed_qr_bag"]
    log(f"[serve-cli] dlrm-qr-smoke on the card, both modes, fenced: metrics, trace "
        f"({len(trace['traceEvents'])} events), report (bottleneck "
        f"{report['attribution']['bottleneck']}), SLO "
        f"{'breached' if report['slo']['breached'] else 'met'}, {len(dumps)} flight "
        f"dumps; packed_qr_bag launches {n}")
    obs.registry().reset()
    obs.tracer().reset()
    return n


def device_share(arch: str, run) -> None:
    """Trace one short sequential run with ``torch.profiler``: the share of
    its wall time the card spent in kernels and copies, and the device
    operations that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device's own events (kernels, copies): a CPU op's device time
    # counts the same kernels again
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log(f"[{arch}] profiler saw no device time: device share not measured")
        return
    busy_us = sum(t for _k, t in rows)
    top = ", ".join(f"{k[:64]} {t / 1e3:.2f} ms"
                    for k, t in sorted(rows, key=lambda r: -r[1])[:5])
    log(f"[{arch}] profiler, 3 sequential batches: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%); top: {top}")


def tt_lookup_check(dev, cfg, batch, state, params, synthetic, tt_embedding, tg,
                    pg) -> int:
    """One ``tt_embedding.lookup`` of a batch's logical rows of one sparse
    feature (batch x pooling) on a full-width dlrm-tt table: K5 launches
    exactly once, and the rows agree with the plain contraction."""
    emb = state.bags[0].emb
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=13,
                               step=0, device=dev)
    reset_counts(pg, tg)
    got = tt_embedding.lookup(params["tables"][0], idx, emb)
    torch.cuda.synchronize()
    n = tg.LAUNCHES["tt_bag"]
    if n != 1 or sum(pg.LAUNCHES.values()):
        raise AssertionError(f"tt_embedding.lookup launched tt_bag {n} times")
    plain = tt_embedding.lookup(params["tables"][0], idx, dataclasses.replace(
        emb, compute_dtype=torch.float32, tt_exec="jnp"))
    err = float((got.float() - plain.to(emb.compute_dtype).float()).abs().max())
    if got.shape != (*idx.shape, cfg.dim) or got.dtype != emb.compute_dtype or err > 1e-2:
        raise AssertionError(f"tt_embedding.lookup: {got.shape} {got.dtype}, "
                             f"max |kernel - plain| {err}")
    log(f"[{cfg.name}] tt_embedding.lookup {tuple(idx.shape)} -> {tuple(got.shape)} "
        f"{got.dtype}: tt_bag launched {n} time, max |kernel - plain| {err:.3e}")
    return n


# ---------------------------------------------------------------------------
# phase 5: the per-table paths at full width
# ---------------------------------------------------------------------------

PERTABLE_KERNEL = {"qr": "cached_qr_bag", "dense": "cached_bag", "tt": "tt_bag"}


def launches_now(mods) -> dict:
    return {name: n for m in mods for name, n in m.LAUNCHES.items()}


def reset_all(mods) -> None:
    for m in mods:
        m.reset_launches()


def cached_lookup_run(dev, arch, batch, batches, registry, dlrm, synthetic, qr_embedding,
                      embedding_bag, engine, mods) -> int:
    """``cached_lookup`` on table 0 of ``arch`` at full width for ``batches``
    batches, the scheduler prefetching the next batch between calls;
    returns the launches of the table's kernel."""
    cfg = registry.get_dlrm(arch)
    bag = dlrm.make_bags(cfg)[0]
    bag = dataclasses.replace(bag, emb=dataclasses.replace(bag.emb,
                                                           compute_dtype=torch.float32))
    emb = bag.emb
    params = qr_embedding.init(emb, generator=torch.Generator(dev).manual_seed(3), device=dev)
    eng = engine.engine_for(engine.EngineSpec.from_bags([bag], cache_slots=cfg.cache_slots))
    sched = eng.fresh_schedulers()[0]
    idx = [synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=20, step=t,
                                device=dev) for t in range(batches)]
    rows = [engine.big_rows(i.cpu().numpy(), emb) for i in idx]
    up = lambda a: torch.from_numpy(a).to(dev)
    sched.prefetch(rows[0])                                 # cold-start staging
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_all(mods)
    outs = []
    for t in range(batches):
        slot = up(sched.slots_for(rows[t]))
        outs.append(eng.cached_lookup(params, idx[t], 0, cache_rows=up(sched.cache_rows()),
                                      slot=slot if slot.shape == idx[t].shape else None))
        if t + 1 < batches:
            sched.prefetch(rows[t + 1])                    # the prefetch hook
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_now(mods)
    kernel = PERTABLE_KERNEL[emb.kind]
    if counts[kernel] != batches or sum(counts.values()) != batches:
        raise AssertionError(f"{arch} cached_lookup: launches {counts} for {batches} batches")
    plain = dataclasses.replace(bag, emb=dataclasses.replace(emb, tt_exec="jnp"))
    err = max(float((o - embedding_bag.bag_lookup(params, i, plain)).abs().max())
              for o, i in zip(outs, idx))
    if not err <= ERR_TOL or not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"{arch} cached_lookup vs bag_lookup: max abs error {err}")
    log(f"[per-table] {arch} table 0 cached_lookup: {batches} batches of "
        f"{tuple(idx[0].shape)}, {kernel} launched {counts[kernel]} times, "
        f"hit rate {sched.stats.hit_rate:.4f}, max |cached - bag_lookup| {err:.3e}, "
        f"{wall / batches * 1e3:.2f} ms per batch (host scheduler included)")
    return counts[kernel]


def ops_entry_runs(dev, batch, registry, dlrm, synthetic, hashing, qr_embedding, ops,
                   mods) -> dict:
    """``ops.qr_lookup`` (K8) on dlrm-qr table 0 and ``ops.gnr_pooled_dense``
    (K7) on dlrm-dense table 0, once each, against the plain lookups."""
    out = {}
    for arch, kernel in (("dlrm-qr", "qr_gather"), ("dlrm-dense", "gnr_bag_dense")):
        cfg = registry.get_dlrm(arch)
        emb = dataclasses.replace(dlrm.make_bags(cfg)[0].emb, compute_dtype=torch.float32)
        params = qr_embedding.init(emb, generator=torch.Generator(dev).manual_seed(4),
                                   device=dev)
        idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=21,
                                   device=dev)
        reset_all(mods)
        if kernel == "qr_gather":
            q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
            got = ops.qr_lookup(params["q"], params["r"], q_idx, r_idx)
            counts = launches_now(mods)
            expect = qr_embedding.lookup(params, idx, emb)
        else:
            got = ops.gnr_pooled_dense(params["table"], idx)
            counts = launches_now(mods)
            expect = qr_embedding.lookup(params, idx, emb).sum(dim=-2)
        err = float((got - expect).abs().max())
        if counts[kernel] != 1 or sum(counts.values()) != 1 or not err <= ERR_TOL:
            raise AssertionError(f"ops entry for {kernel}: launches {counts}, error {err}")
        log(f"[per-table] {arch} ops entry {tuple(idx.shape)} -> {tuple(got.shape)}: "
            f"{kernel} launched once, max |kernel - plain lookup| {err:.3e}")
        out[kernel] = counts[kernel]
        del params
    torch.cuda.empty_cache()
    return out


def hashed_lookup_run(dev, batch, registry, dlrm, synthetic, embedding_bag, engine,
                      mods) -> None:
    """``engine.lookup`` on 26 hashed tables of the dlrm-qr shape: the
    per-table branch (plain gathers, no kernel), card against CPU."""
    cfg = registry.get_dlrm("dlrm-qr").replace(embedding_kind="hashed")
    bags = dlrm.make_bags(cfg)
    tables = embedding_bag.init_tables(bags, generator=torch.Generator(dev).manual_seed(5),
                                       device=dev)
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=22, device=dev)
    eng = engine.engine_for(engine.EngineSpec.from_bags(bags))
    reset_all(mods)
    t0 = time.perf_counter()
    got = eng.lookup(tables, idx)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sum(launches_now(mods).values()) or eng.plan.packed:
        raise AssertionError("hashed lookup: expected the per-table branch, no kernel")
    cpu = eng.lookup([{k: v.cpu() for k, v in t.items()} for t in tables], idx.cpu())
    err = float((got.cpu().float() - cpu.float()).abs().max())
    if got.shape != (batch, cfg.num_tables, cfg.dim) or not torch.isfinite(got).all() \
            or err > 2 * BF16_TOL:
        raise AssertionError(f"hashed lookup: {tuple(got.shape)}, card vs CPU {err}")
    log(f"[per-table] hashed engine.lookup, {cfg.num_tables} tables of "
        f"{tables[0]['table'].shape[0]} x {cfg.dim}, {tuple(idx.shape)} -> "
        f"{tuple(got.shape)} {got.dtype}: card vs CPU max abs diff {err:.3e}, "
        f"{wall * 1e3:.1f} ms on the card")
    del tables
    torch.cuda.empty_cache()


def examples_run(mods, quickstart, cache_plan) -> dict:
    """Both per-table examples on the card: the quickstart launches K6 and
    K1 once each, the cache walkthrough K4b once per batch."""
    reset_all(mods)
    quickstart.main(["--device", "cuda"])
    counts = launches_now(mods)
    if counts["gnr_bag"] != 1 or counts["packed_qr_bag"] != 1 or sum(counts.values()) != 2:
        raise AssertionError(f"quickstart launches {counts}")
    reset_all(mods)
    res = cache_plan.main(["--device", "cuda"])
    n = launches_now(mods)
    if n["cached_qr_bag"] != res["batches"] or sum(n.values()) != res["batches"]:
        raise AssertionError(f"cache_plan launches {n} for {res['batches']} batches")
    log(f"[per-table] examples: quickstart launched {counts}; cache_plan launched "
        f"cached_qr_bag {n['cached_qr_bag']} times, hit rate {res['hit_rate']:.3f}")
    return {"gnr_bag": counts["gnr_bag"], "packed_qr_bag": counts["packed_qr_bag"],
            "cached_qr_bag": n["cached_qr_bag"]}


# ---------------------------------------------------------------------------
# phase 6: attention, K9
# ---------------------------------------------------------------------------

# (name, batch, query heads, kv heads, Sq, Skv, D): qwen2-1.5b's attention
# (configs/qwen2_1_5b.py) at the train_4k sequence, batch cut from 256 to 4;
# granite-34b's multi-query attention (48 heads on one kv head, the widest
# group in the repo), batch 1; and a query block of 1,024 over a 4,096 cache
FLASH_CASES = [
    ("qwen2-1.5b", 4, 12, 2, 4096, 4096, 128),
    ("granite-34b", 1, 48, 1, 4096, 4096, 128),
    ("qwen2-1.5b Sq 1024 / Skv 4096", 4, 12, 2, 1024, 4096, 128),
]
SDPA_CALL = "scaled_dot_product_attention(is_causal=True, enable_gqa=True), top-left causal"


def flash_flops(b, h, sq, skv, d, causal=True) -> int:
    """4*D flops for each visible (query, key) pair: causal, query i sees
    keys 0..i (top-left), which is S(S+1)/2 pairs for Sq == Skv."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return 4 * b * h * d * pairs


def flash_phase(dev, ops, fa, ref, sass: dict) -> dict:
    """The attention path ``ops.flash_attention_fused`` at the three widths
    above in fp32 and bf16, causal, then one backward; the counts cover that
    run only.  Then each output is held against K9's plain version
    (``hold``: fp32 to ``ERR_TOL``; bf16 per element within one rounding of
    the plain version in fp32 on the same inputs) and kernel, plain version
    and SDPA are timed with CUDA events."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(8)
    fa.reset_launches()
    runs = []
    for name, b, h, kh, sq, skv, d in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
            k = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
            v = torch.randn((b, kh, skv, d), generator=g, device=dev).to(dtype)
            runs.append((name, dtype, (q, k, v), ops.flash_attention_fused(q, k, v,
                                                                           causal=True)))
    # one backward at qwen2's width, batch 1, seq 1,024: the recompute through
    # the blockwise plain attention against plain autograd of K9's plain version
    q, k, v = (torch.randn(s, generator=g, device=dev)
               for s in ((1, 12, 1024, 128), (1, 2, 1024, 128), (1, 2, 1024, 128)))
    w = torch.randn((1, 12, 1024, 128), generator=g, device=dev)
    lhs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ops.flash_attention_fused(*lhs, causal=True) * w).sum().backward()
    torch.cuda.synchronize()
    launches = fa.LAUNCHES["flash_fwd"]
    if launches != len(runs) + 1:
        raise AssertionError(f"flash path launched flash_fwd {launches} times, "
                             f"not {len(runs) + 1}")
    rhs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (ref.flash_fwd_ref(*rhs, causal=True) * w).sum().backward()
    grad_err = max(float((a.grad - b.grad).abs().max()) for a, b in zip(lhs, rhs))
    grad_scale = max(float(b.grad.abs().max()) for b in rhs)
    if not grad_err <= 1e-4 * max(grad_scale, 1.0):
        raise AssertionError(f"flash_mha backward vs plain autograd: {grad_err}")
    log(f"[flash] flash_mha backward (1, 12/2, 1024, 128): max |grad - plain autograd| "
        f"{grad_err:.3e} (largest gradient {grad_scale:.3e})")
    del lhs, rhs, q, k, v, w

    cases = []
    for name, dtype, (q, k, v), out in runs:
        b, h, sq, d = q.shape
        skv = k.shape[2]
        if out.dtype != dtype:
            raise AssertionError(f"flash {name}: {out.dtype} out of {dtype} inputs")
        checked = hold(f"flash {name} {dtype}", out,
                       lambda *a: ref.flash_fwd_ref(*a, causal=True), (q, k, v))
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                         enable_gqa=True)
        lib_err = float((library().float() - out.float()).abs().max())
        flops = flash_flops(b, h, sq, skv, d)
        nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
        peak = FP32_FLOP_S if dtype == torch.float32 else BF16_FLOP_S
        t_ops, t_bytes = flops / peak, nbytes / BW_BYTES_S
        c = {"case": name, "dtype": str(dtype).replace("torch.", ""), "body": fa.BODY[dtype][1],
             "shape": {"B": b, "H": h, "KH": k.shape[1], "Sq": sq, "Skv": skv, "D": d},
             **checked, "ms": timed(lambda: fa.flash_fwd(q, k, v, causal=True), 5),
             "plain_ms": timed(lambda: ref.flash_fwd_ref(q, k, v, causal=True), 2, warm=1),
             "bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes",
             "library_ms": timed(library, 5), "library_max_abs_diff": lib_err,
             "flops": flops, "bytes": nbytes}
        log(f"[flash] {name} {c['dtype']} ({c['body']}): {fmt_err(checked)}, kernel "
            f"{c['ms']:.4f} ms (earlier {fmt_range(EARLIER_MS['flash_fwd'][c['dtype']])} ms at "
            f"qwen2-1.5b width), plain "
            f"{c['plain_ms']:.4f} ms, SDPA {c['library_ms']:.4f} ms (|SDPA - kernel| "
            f"{lib_err:.2e}), bound {c['bound_ms']:.4f} ms ({c['bound_by']}, "
            f"{flops:.3e} flop, {nbytes} B)")
        cases.append(c)
    del runs
    torch.cuda.empty_cache()
    main_case = cases[0]                      # qwen2-1.5b, fp32 (the Pallas body's type)
    bf16_case = cases[1]                      # qwen2-1.5b, bf16: the tensor-core body
    row = {"name": "flash_fwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:88",
           "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases if c["dtype"] == "float32"),
           "bf16_max_abs_err": max(c["max_abs_err"] for c in cases
                                   if c["dtype"] == "bfloat16"),
           "bf16_rounding_ratio": max(c["rounding_ratio"] for c in cases
                                      if c["dtype"] == "bfloat16"),
           "tolerance": {"float32": ERR_TOL, "bfloat16": ROUND_RULE},
           **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms", "shape")},
           "library_call": SDPA_CALL, "dtype": main_case["dtype"], "cases": cases,
           "backward_max_abs_err": grad_err,
           "bodies": {str(t).replace("torch.", ""): b[1] for t, b in fa.BODY.items()},
           "sass": sass["flash_attention"],
           **{f"bf16_{k}": bf16_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                   "library_ms")}}
    row["kernel_ms"] = row["ms"]
    return row


# ---------------------------------------------------------------------------
# phase 7: DLRM training at full width
# ---------------------------------------------------------------------------

TRAIN_STEPS = 4
# of each leaf's largest entry, kernel path against ``plain_dlrm_loss``.
# Both round one fp32 table gradient once to bf16 (the kernel path's chunked
# fp32 recompute, the reference's fp32 embedding-bag backward): where their
# fp32 sums, taken in other orders, straddle a rounding boundary they differ
# by one bf16 step of the element, at most 2^-7 of it.  A second step allows
# for a pooled value that the kernel's in-order sum and the plain reduction
# round one step apart, which the bf16 head carries into the bag's
# cotangent.  The readings at batch 64 / 256 / 1024
# (scripts/torch_step1_grad_readings.py) lie below it; a dropped, doubled or
# miswired chunk reads near 1
GRAD_TOL = 2.0 ** -6


def train_config(arch, registry):
    """dlrm-qr and dlrm-tt at full width; dlrm-dense at 200,000 rows per
    table (the example's vocabulary): at 2M rows its fp32 params, gradient
    and two moments would take 4 x 26.6 GB of the card's 80 GB."""
    cfg = registry.get_dlrm(arch)
    if cfg.embedding_kind == "dense":
        cfg = cfg.replace(name="dlrm-dense-200k", vocab_per_table=200_000)
    return cfg


def plain_packed(layout, packed: dict, cache, s: dict, ref) -> torch.Tensor:
    """The packed bags' plain version on packed buffers and (G, K) streams."""
    if layout.kind == "qr":
        return ref.packed_qr_bag_ref(packed["q"], cache, packed["r"], s["q_idx"], s["slot"],
                                     s["r_idx"])
    if layout.kind == "tt":
        return ref.packed_tt_bag_ref(packed["g1"], packed["g2"], packed["g3"], cache,
                                     s["i1"], s["i2"], s["i3"], s["slot"], dims=layout.tt_dims)
    return ref.packed_bag_ref(packed["table"], cache, s["idx"], s["slot"])


# dlrm-tt's training lookup at train_8k crosses 52 recompute chunks
RECOMPUTE_CHUNKS = 52
# of each element's summed contribution magnitudes m.  The recompute widens
# the buffers and the cotangent to fp32, sums every chunk's gradient in fp32
# and rounds the total once to bf16: at most 2^-8 of the exact value, which
# is at most m (the floor 1e-6 max m in ``exact_grad_check`` covers the fp32
# sums' order)
RECOMPUTE_RULE = 2.0 ** -8


def exact_grad_check(name, run, plain, bufs: dict, ct, row_bytes: int, lead: int, ops):
    """A kernel path's gradient across ``RECOMPUTE_CHUNKS`` recompute chunks,
    held against the exact gradient.  ``run(leaves)`` is the path on bf16
    leaves requiring grad; it takes the bf16 cotangent ``ct`` back with
    ``ops.RECOMPUTE_BYTES`` cut so its ``lead`` bags (``row_bytes`` of fp32
    rows each) cross the chunks.  The exact gradient is plain autograd of
    ``plain`` in one pass on the buffers and cotangent widened to fp32.
    Every element must lie within ``RECOMPUTE_RULE`` of the sum of its
    contributions' magnitudes (``plain``'s gradient on |buffers| and
    |cotangent|: the plain versions are multilinear); a dropped or doubled
    chunk reads far above.  Returns the row's keys."""
    names = list(bufs)
    leaves = {n: bufs[n].detach().requires_grad_(True) for n in names}
    out = run(leaves)
    per_chunk = -(-lead // RECOMPUTE_CHUNKS)
    saved = ops.RECOMPUTE_BYTES
    ops.RECOMPUTE_BYTES = per_chunk * row_bytes
    try:
        got = torch.autograd.grad(out, [leaves[n] for n in names], ct)
    finally:
        ops.RECOMPUTE_BYTES = saved
    wide = {n: bufs[n].float().requires_grad_(True) for n in names}
    exact = torch.autograd.grad(plain(wide), [wide[n] for n in names], ct.float())
    mags = {n: bufs[n].float().abs().requires_grad_(True) for n in names}
    total = torch.autograd.grad(plain(mags), [mags[n] for n in names], ct.float().abs())
    worst, err = 0.0, 0.0
    for n, a, e, m in zip(names, got, exact, total):
        d = (a.float() - e).abs()
        ratio = float((d / (RECOMPUTE_RULE * m + 1e-6 * float(m.max()) + 1e-30)).max())
        worst, err = max(worst, ratio), max(err, float(d.max()) / float(e.abs().max()))
        if a.dtype != bufs[n].dtype or not ratio <= 1.0:
            raise AssertionError(f"{name} recompute across {-(-lead // per_chunk)} chunks, "
                                 f"{n}: {ratio} of the rounding bound")
    return {"chunks": -(-lead // per_chunk), "bags": lead, "recompute_ratio": worst,
            "recompute_rel_err": err}


def recompute_check(dev, cfg, params, idx, dlrm, pt, ops, ref) -> dict:
    """The training lookup's backward (``ops.packed_multi_pooled`` on the
    bf16 packed buffers of ``params`` and the streams of ``idx``, all-miss
    slots and a 1-row cache, as ``packed_multi_bag_lookup`` calls it) across
    many chunks against the exact gradient (``exact_grad_check``)."""
    bags = dlrm.make_bags(cfg)
    layout = pt.layout_for(bags)
    dtype = bags[0].emb.compute_dtype
    with torch.no_grad():
        packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    cache = pt.dummy_cache(layout, dtype, dev)
    ct = torch.randn((s["slot"].shape[0], cfg.dim),
                     generator=torch.Generator(dev).manual_seed(10), device=dev).to(dtype)
    return exact_grad_check(
        cfg.name, lambda leaves: ops.packed_multi_pooled(
            {**leaves, "cache": cache}, s, kind=layout.kind, dims=layout.tt_dims),
        lambda bufs: plain_packed(layout, bufs, cache.float(), s, ref), packed, ct,
        cfg.pooling * layout.big_width * 4, s["slot"].shape[0], ops)


def plain_dlrm_loss(params, batch, cfg, dlrm, pt, ref):
    """The DLRM loss with the embedding layer through the packed bags' plain
    versions on the same packed buffers and streams, autograd all the way:
    the reference of the step-1 check.  The buffers are packed in the
    compute dtype as the kernel path packs them, then widened to fp32, so
    the embedding-bag backward runs in fp32 and each table gradient is
    rounded once to the compute dtype (where the widening's backward casts
    it); the pooled output is rounded to the compute dtype as the kernel's
    is, so both paths feed the head the same values."""
    bags = dlrm.make_bags(cfg)
    layout = pt.layout_for(bags)
    dtype = bags[0].emb.compute_dtype
    packed = pt.pack_params(params["tables"], layout, dtype=dtype)
    wide = {k: v.float() for k, v in packed.items()}
    s = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(batch["idx"],
                                                                 layout).items()}
    s["slot"] = torch.full_like(next(iter(s.values())), -1)
    cache = pt.dummy_cache(layout, torch.float32, s["slot"].device)
    pooled = plain_packed(layout, wide, cache, s, ref).to(dtype)
    pooled = pooled.reshape(*batch["idx"].shape[:2], cfg.dim)
    pooled = pooled * pt.combiner_scale(bags, pooled.dtype, pooled.device)[None, :, None]
    logits = dlrm.forward_from_pooled(params, batch["dense"], pooled, cfg)
    return dlrm.bce_loss(logits, batch["labels"])


def train_phase(dev, arch, batch, registry, dlrm, synthetic, train_step, opt, tree, pt, ops,
                ref, mods) -> dict:
    """``TRAIN_STEPS`` steps of ``make_train_step`` at ``batch``; losses and
    gradient norms finite, one launch of the packed kernel per step; the
    step-1 table gradients on a cut batch (64) within ``GRAD_TOL`` of the
    plain path's with an fp32 embedding-bag backward (``plain_dlrm_loss``;
    dlrm-tt's cut batch fits one recompute chunk); the
    lookup's backward on the same cut batch across ``RECOMPUTE_CHUNKS``
    chunks against the exact gradient (``recompute_check``); then one step
    split into forward, backward and update with CUDA events.  Returns the
    launches of the run."""
    cfg = train_config(arch, registry)
    kernel = KERNEL_OF[cfg.embedding_kind]
    t0 = time.perf_counter()
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    state = opt.init(params)
    truth = synthetic.dlrm_truth(cfg, device=dev)
    batches = [synthetic.dlrm_planted_batch(cfg, truth, batch, seed=0, step=s, device=dev)
               for s in range(TRAIN_STEPS)]
    loss_fn = train_step.make_dlrm_loss(cfg)
    # the train CLI's learning rate, warmed up over the run
    opt_cfg = opt.OptConfig(lr=3e-4, warmup_steps=TRAIN_STEPS, total_steps=TRAIN_STEPS)
    step = train_step.make_train_step(loss_fn, opt_cfg)

    # step-1 gradients on a cut batch: the kernels' path against the plain path
    cut = {k: v[:64] for k, v in batches[0].items()}
    _l, _m, g_kernel = train_step.value_and_grad(loss_fn, params, cut)
    _l, _m, g_plain = train_step.value_and_grad(
        lambda p, b: (plain_dlrm_loss(p, b, cfg, dlrm, pt, ref), {}), params, cut)
    worst = 0.0
    for (path, a), b in zip(tree.leaves_with_paths(g_kernel["tables"]),
                            tree.leaves(g_plain["tables"])):
        scale = max(float(b.abs().max()), 1e-12)
        rel = float((a - b).abs().max()) / scale
        worst = max(worst, rel)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{cfg.name} step-1 gradient {path}: kernel vs plain {rel}")
    del g_kernel, g_plain
    chunks = recompute_check(dev, cfg, params, cut["idx"], dlrm, pt, ops, ref)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    reset_all(mods)
    t0 = time.perf_counter()
    losses, norms = [], []
    for b in batches:
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches_now(mods)
    peak = torch.cuda.max_memory_allocated(dev)
    if counts[kernel] != TRAIN_STEPS or sum(counts.values()) != TRAIN_STEPS:
        raise AssertionError(f"{cfg.name} training launches {counts} for {TRAIN_STEPS} steps")
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"{cfg.name}: losses {losses}, grad norms {norms}")

    # one more step, split: forward, backward, update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    ev[0].record()
    with torch.enable_grad():
        loss, _ = loss_fn(live, batches[0])
        ev[1].record()
        grads = torch.autograd.grad(loss, leaves)
    ev[2].record()
    opt.update(params, tree.unflatten(params, list(grads)), state, opt_cfg)
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    res = {"arch": cfg.name, "batch": batch, "steps": TRAIN_STEPS, "losses": losses,
           "grad_norms": norms, "ms_per_step": wall / TRAIN_STEPS * 1e3,
           "forward_ms": split[0], "backward_ms": split[1], "update_ms": split[2],
           "peak_gib": peak / 2**30, "launches": counts[kernel], "kernel": kernel,
           "step1_grad_rel_err": worst, **chunks}
    log(f"[train] {cfg.name} batch {batch}: {TRAIN_STEPS} steps {res['ms_per_step']:.1f} ms "
        f"per step (forward {split[0]:.1f}, backward {split[1]:.1f}, update {split[2]:.1f} "
        f"ms), losses {', '.join(f'{x:.4f}' for x in losses)}, grad norms "
        f"{', '.join(f'{x:.3f}' for x in norms)}, peak {res['peak_gib']:.2f} GiB, {kernel} "
        f"launches {counts[kernel]}, step-1 table gradients kernel vs plain (batch 64) "
        f"{worst:.2e} of scale; recompute across {chunks['chunks']} chunks vs exact fp32 "
        f"{chunks['recompute_rel_err']:.2e} of scale, {chunks['recompute_ratio']:.3f} of the "
        f"rounding bound; set-up {setup_s:.1f} s")
    del params, state, batches, truth, grads, leaves, live
    torch.cuda.empty_cache()
    return res


def cli_train_run(train_cli, batch, mods) -> int:
    """The training CLI on the card (``python -m repro_torch.launch.train
    --arch dlrm-qr``, full width, 4 steps of ``batch``): exit 0 and one
    launch of K1 per step."""
    reset_all(mods)
    t0 = time.perf_counter()
    rc = train_cli.main(["--arch", "dlrm-qr", "--steps", str(TRAIN_STEPS), "--batch",
                         str(batch), "--log-every", "1"])
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if rc != 0 or counts["packed_qr_bag"] != TRAIN_STEPS or sum(counts.values()) != TRAIN_STEPS:
        raise AssertionError(f"train CLI: exit {rc}, launches {counts}")
    log(f"[train] launch.train --arch dlrm-qr --batch {batch}: {TRAIN_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s (set-up included), packed_qr_bag launched "
        f"{counts['packed_qr_bag']} times")
    torch.cuda.empty_cache()
    return counts["packed_qr_bag"]


def tt_lookup_grad_run(dev, registry, dlrm, synthetic, tt_embedding, ref, ops, mods) -> dict:
    """``tt_embedding.lookup`` with ``tt_exec="pallas"`` on one full-width
    dlrm-tt table's cores held in bf16 and requiring grad (2,048 x 32 rows):
    K5 bf16 launches once, and the core gradients across many recompute
    chunks lie within bf16 rounding of the exact gradient through K5's plain
    version (``exact_grad_check``)."""
    cfg = registry.get_dlrm("dlrm-tt")
    emb = dataclasses.replace(dlrm.make_bags(cfg)[0].emb, param_dtype=torch.bfloat16)
    cores = tt_embedding.init(emb, generator=torch.Generator(dev).manual_seed(9), device=dev)
    cores = {k: v.to(torch.bfloat16) for k, v in cores.items()}
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (2048, cfg.pooling), seed=16, device=dev)
    i1, i2, i3 = (x.reshape(-1, 1) for x in tt_embedding.tt_decompose(idx, emb.tt_spec))
    ct = torch.randn((*idx.shape, cfg.dim), generator=torch.Generator(dev).manual_seed(17),
                     device=dev).to(torch.bfloat16)
    reset_all(mods)
    res = exact_grad_check(
        "bf16 tt_embedding.lookup", lambda leaves: tt_embedding.lookup(leaves, idx, emb),
        lambda bufs: ref.tt_bag_ref(bufs["g1"], bufs["g2"], bufs["g3"], i1, i2, i3,
                                    dims=emb.tt_spec.dims).reshape(ct.shape),
        cores, ct, cores["g2"].shape[1] * 4, i1.shape[0], ops)
    torch.cuda.synchronize()
    counts = launches_now(mods)
    if counts["tt_bag"] != 1 or sum(counts.values()) != 1:
        raise AssertionError(f"bf16 tt_embedding.lookup launches {counts}")
    log(f"[train] tt_embedding.lookup, bf16 cores under grad {tuple(idx.shape)}: tt_bag "
        f"launched once; core gradients across {res['chunks']} recompute chunks vs exact "
        f"fp32 {res['recompute_rel_err']:.2e} of scale, {res['recompute_ratio']:.3f} of the "
        f"rounding bound")
    return {"launches": counts["tt_bag"], **res}


# ---------------------------------------------------------------------------
# phase 8: the serving control plane (tuner, ladder rungs, front end, adaptation)
# ---------------------------------------------------------------------------

# rows per table of dlrm-dense in the rungs phase: the ladder holds three
# copies of the tables (the params the baseline rung reads, the packed
# buffer, the 26 one-table packed buffers); at 2,000,000 rows they would take
# 80 GB
RUNG_DENSE_ROWS = 1_000_000
# the baseline rung (``multi_bag_lookup``) sums each subtable's rows in the
# compute dtype, bf16, and adds the sums there: where the Q and R sums cancel
# it sits up to ~180 roundings of the result away from the kernel rungs'
# fp32 sum (0.0274 max at dlrm-qr's widths on the CPU, batch 2,048), so it is
# held to repro's own bound between its baseline and kernel rungs
# (tests/test_serve_frontend.py: rtol = atol = 2e-2)
BASELINE_TOL = 2e-2
FRONTEND_BATCH = 256
# the adaptive sessions' batch: the controller's host work grows with a
# batch's distinct rows (SpaceSaving walks each against its 256 tracked keys
# in Python); at batch 2,048 on full-width dlrm-qr the adaptive sessions
# took 202.6 s on an NVIDIA H100 80GB HBM3 host (PERF.md, PR 18)
ADAPT_BATCH = 256
ADAPT_POLICY = dict(check_every=4, min_batches=8, min_gain=0.05, cooldown_batches=4)
FRONTEND_ARRIVAL = "rate=1000,horizon=3,deadline_ms=400,flash=0.2+0.3x10,seed=5"
FRONTEND_FAULTS = "stall@0.6:0.5,replica@0.9:0.2,gather@1.2:2,drop@1.3,retries=3"
FRONTEND_SLO = "p99_ms=150,objective=0.99,fast_window=4,slow_window=8,name=frontend"


def launch_delta(mods, before: dict) -> dict:
    now = launches_now(mods)
    return {k: n - before.get(k, 0) for k, n in now.items() if n - before.get(k, 0)}


def add_launches(by_name: dict, delta: dict) -> None:
    """Serving launches are the fp32 entries: each adds to its kernel's row."""
    for name, n in delta.items():
        by_name[name]["launches"] += n


def serving_traces(cfg, synthetic, n: int = 50_000) -> list:
    """The per-table Zipf traces ``build_serve_state`` profiles (seed 0)."""
    return [synthetic.zipf_trace(cfg.vocab_per_table, n, alpha=1.05, seed=7 + t)
            for t in range(cfg.num_tables)]


def tuner_phase(dev, batch, registry, dlrm, synthetic, serve_rec, engine, tune, mods):
    """``tune.fit(mode="measure", max_samples=4)`` on full-width dlrm-qr
    traces at batch ``batch`` (each sample timed by CUDA events, the median of
    3 calls), the choice in the knob space and frozen by ``plan(tuner=)``;
    then ``build_serve_state(tuner=)``, 5 sequential batches, the tuned
    plan's prediction against its measured ``serve_gather`` and its measured
    batches.  Returns (record, the tuned state, its params, launches)."""
    from repro_torch.tune import tuner as tuner_mod

    cfg = registry.get_dlrm("dlrm-qr")
    spec = engine.EngineSpec.from_dlrm(cfg, serving=True)
    traces = serving_traces(cfg, synthetic)
    before = launches_now(mods)
    t0 = time.perf_counter()
    tuner = tune.fit(spec, traces, mode="measure", batch=batch, num_shards=4,
                     max_samples=4, repeats=3, device=dev)
    fit_s = time.perf_counter() - t0
    samples = []
    for s in tuner.samples:
        samples.append({"knobs": s.knobs.describe(),
                        "features": dict(zip(tune.FEATURES, s.features)),
                        "ms": s.measured_s * 1e3})
        log(f"[tuner] sample {s.knobs.backend} slots {s.knobs.cache_slots} "
            f"{s.knobs.cache_slot_policy}, features "
            + ", ".join(f"{k} {v:.6g}" for k, v in samples[-1]["features"].items())
            + f": {s.measured_s * 1e3:.4f} ms (CUDA events, median of 3)")
    coef = {b: dict(zip(tune.FEATURES, m.coef)) for b, m in tuner.models.items()}
    for b, c in coef.items():
        log(f"[tuner] {b} model: " + ", ".join(f"{k} {v:.4g}" for k, v in c.items()))
    space = tune.knob_space(spec, packable=True)
    choice = tuner.choose(spec, backend="packed")
    if choice not in space:
        raise AssertionError(f"tuner chose {choice} outside the knob space")
    eplan = engine.plan(spec, traces, num_shards=4, tuner=tuner)
    if eplan.knobs != tuner.choose(spec, packable=True):
        raise AssertionError(f"plan(tuner=) froze {eplan.knobs}, not the tuner's choice")
    log(f"[tuner] fit {fit_s:.2f} s ({len(tuner.samples)} samples, {tuner.source}, "
        f"{tuner.metadata['device_kind']}); chosen (packed) {choice.describe()}, "
        f"default {choice == tune.default_knobs(spec, packable=True)}")

    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev,
                                        tuner=tuner)
    if state.eplan.knobs != choice or state.drift is None or state.predicted_s is None:
        raise AssertionError("build_serve_state(tuner=) did not plan the choice and arm "
                             "the drift monitor")
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    r = serve_rec.run_pipeline(cfg, batch=batch, batches=5, mode="sequential", state=state,
                               params=params, device=dev)
    if not all(np.isfinite(x).all() for x in r["logits"]):
        raise AssertionError("tuned plan: non-finite logits")
    idx = synthetic.dlrm_batch(cfg, batch, seed=0, step=1)["idx"].numpy()
    fn, args = tuner_mod._serving_call(state.engine, params["tables"], idx, dev)
    gather_s = tuner_mod._time_call(fn, *args, device=dev, iters=5)
    del fn, args
    drift = state.drift.summary()
    rec = {"config": "dlrm-qr", "batch": batch, "fit_s": fit_s, "samples": samples,
           "coef": coef, "choice": choice.describe(),
           "predicted_ms": state.predicted_s * 1e3, "serve_gather_ms": gather_s * 1e3,
           "batch_p50_ms": r["lat_p50_s"] * 1e3, "drift": drift}
    log(f"[tuner] tuned plan: predicted {state.predicted_s * 1e3:.4f} ms a batch, "
        f"serve_gather measured {gather_s * 1e3:.4f} ms (CUDA events, median of 5; "
        f"{gather_s / state.predicted_s:.3f}x the prediction), whole sequential batch p50 "
        f"{r['lat_p50_s'] * 1e3:.2f} ms ({r['lat_p50_s'] / state.predicted_s:.1f}x: the "
        f"host's prefetch and slot translation, which the model does not price); drift "
        f"monitor: {drift['observations']} observations, recent residual "
        f"{drift['recent_residual']:.1f}, refit recommended {drift['refit_recommended']}")
    return rec, state, params, launch_delta(mods, before)


def rungs_phase(dev, arch, batch, registry, dlrm, synthetic, serve_rec, engine, serve,
                mods) -> tuple[dict, dict]:
    """One batch of ``batch`` through every rung of the degradation ladder
    on ``arch`` at full width (dlrm-dense at ``RUNG_DENSE_ROWS`` rows a
    table): rungs 0-2 bitwise identical, ``baseline`` within
    ``BASELINE_TOL`` of them (it sums in the compute dtype, bf16), the packed kernel
    launched once on ``full`` and ``nocache``, once per table on
    ``pertable``, never on ``baseline``.  ms: host clock around the rung's
    call and a synchronise, median of 3."""
    from repro_torch.serve.degrade import RUNGS

    cfg = registry.get_dlrm(arch)
    if cfg.embedding_kind == "dense":
        cfg = cfg.replace(vocab_per_table=RUNG_DENSE_ROWS)
    kernel = KERNEL_OF[cfg.embedding_kind]
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    ladder = serve.DegradationLadder(state, params)
    emb = state.bags[0].emb
    idx = synthetic.dlrm_batch(cfg, batch, seed=0, step=1)["idx"].numpy()
    rows = np.stack([engine.big_rows(idx[:, t], emb) for t in range(cfg.num_tables)], axis=1)
    scheds = state.fresh_schedulers()
    for t in range(cfg.num_tables):
        scheds[t].prefetch(rows[:, t])
    hit = float(np.mean(np.stack([scheds[t].slots_for(rows[:, t], record=False) >= 0
                                  for t in range(cfg.num_tables)])))
    if hit <= 0:
        raise AssertionError(f"{arch} rungs: the staged cache takes no hit")
    ladder.warm(idx, rows, scheds)
    out, ms, per_call = {}, {}, {}
    for rung in RUNGS[:-1]:
        ladder.rung_i = RUNGS.index(rung)
        walls = []
        for rep in range(3):
            b0 = launches_now(mods)
            tw = time.perf_counter()
            pooled = ladder.pooled(idx, rows, scheds)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - tw)
            if rep == 0:
                per_call[rung] = launch_delta(mods, b0)
                out[rung] = pooled
        ms[rung] = sorted(walls)[1] * 1e3
    ladder.rung_i = 0
    want = {"full": 1, "nocache": 1, "pertable": cfg.num_tables, "baseline": 0}
    got = {r: per_call[r].get(kernel, 0) for r in want}
    if got != want:
        raise AssertionError(f"{arch} rungs: {kernel} launches {got}, want {want}")
    for rung in ("nocache", "pertable"):
        if out[rung].dtype != out["full"].dtype or not torch.equal(out[rung], out["full"]):
            diff = float((out[rung].float() - out["full"].float()).abs().max())
            raise AssertionError(f"{arch}: rung {rung} is not bitwise the full rung "
                                 f"(max |diff| {diff})")
    base = out["baseline"].float()
    err = float((base - out["full"]).abs().max())
    if not torch.allclose(base, out["full"], rtol=BASELINE_TOL, atol=BASELINE_TOL):
        raise AssertionError(f"{arch}: baseline rung vs kernel rungs max |diff| {err}")
    rec = {"config": arch, "rows_per_table": cfg.vocab_per_table, "batch": batch,
           "hit_share": hit, "ms": ms, "launches": {r: per_call[r] for r in want},
           "baseline_max_abs_err": err, "baseline_dtype": str(out["baseline"].dtype)}
    log(f"[rungs] {arch} ({cfg.vocab_per_table:,} rows a table, batch {batch}, hit share "
        f"{hit:.3f}): full == nocache == pertable bitwise; baseline "
        f"({out['baseline'].dtype}) within {BASELINE_TOL} (max |diff| {err:.3e}); ms a batch "
        + ", ".join(f"{r} {v:.3f}" for r, v in ms.items())
        + f"; {kernel} launches a call " + ", ".join(f"{r} {got[r]}" for r in want)
        + (f"; baseline runs K5 {per_call['baseline'].get('tt_bag', 0)} times"
           if cfg.embedding_kind == "tt" else "")
        + f"; phase {time.perf_counter() - t0:.1f} s")
    del ladder, state, params, out, pooled, base
    torch.cuda.empty_cache()
    return rec, launch_delta(mods, before)


def frontend_phase(dev, registry, dlrm, serve_rec, serve, obs, mods) -> tuple[dict, dict]:
    """A chaos session on full-width dlrm-qr in ``measured`` service mode:
    a flash crowd, a stall, a replica loss, two transient gather errors and a
    dropped prefetch.  Every request lands in a bucket, and the ladder steps
    down and comes back to ``full``."""
    cfg = registry.get_dlrm("dlrm-qr")
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    aspec = serve.ArrivalSpec.parse(FRONTEND_ARRIVAL)
    fspec = serve.FaultSpec.parse(FRONTEND_FAULTS)
    fe = serve.Frontend(
        cfg, serve.FrontendConfig(batch_size=FRONTEND_BATCH, queue_cap=1024,
                                  service_mode="measured"),
        state, params, slo=obs.SLOEngine(obs.SLOSpec.parse(FRONTEND_SLO)),
        faults=serve.FaultInjector(fspec))
    reqs = serve.generate(aspec, cfg)
    rep = fe.run(reqs)
    st, deg = rep["requests"], rep["degrade"]
    if st["unaccounted"] != 0 or st["generated"] != len(reqs):
        raise AssertionError(f"frontend: accounting broken {st}")
    if not any(t["from"] == "full" for t in deg["transitions"]):
        raise AssertionError("frontend: the ladder never stepped down")
    if not rep["recoveries_s"]:
        raise AssertionError(f"frontend: the ladder never came back to full "
                             f"({deg['transitions']})")
    if not fe.faults.exhausted():
        raise AssertionError("frontend: a scheduled fault never latched")
    pcts = {k: rep[k] * 1e3 for k in rep if k.startswith(("req_lat_p", "batch_lat_p"))}
    rec = {"config": "dlrm-qr", "batch": FRONTEND_BATCH, "arrival": FRONTEND_ARRIVAL,
           "faults": FRONTEND_FAULTS, "slo": FRONTEND_SLO, "requests": st,
           "virtual_ms": pcts, "s0_wall_ms": rep["calibration"]["s0_wall_s"] * 1e3,
           "hit_rate": rep["hit_rate"], "batches_at": deg["batches_at"],
           "transitions": deg["transitions"], "recoveries_s": rep["recoveries_s"],
           "wall_s": time.perf_counter() - t0}
    log(f"[frontend] dlrm-qr, batch {FRONTEND_BATCH}, measured mode (s0 = "
        f"{rec['s0_wall_ms']:.2f} ms of wall a full-rung batch = one 10 ms virtual unit), "
        f"{st['generated']} requests: served {st['served']}, missed {st['deadline_missed']}, "
        f"shed {st['shed_total']} (abandoned {st['abandoned']}), retries {st['retries']}, "
        f"unaccounted {st['unaccounted']}, hit rate {rep['hit_rate']:.4f}")
    log("[frontend] virtual latency ms: " + ", ".join(f"{k} {v:.2f}" for k, v in pcts.items()))
    for tr in deg["transitions"]:
        log(f"[frontend] batch {tr['at_batch']} t={tr['t_s']:.3f}s {tr['from']} -> "
            f"{tr['to']} ({tr['reason']})")
    log(f"[frontend] batches per rung {deg['batches_at']}, time to recover "
        f"{rep['time_to_recover_s']:.3f} s (virtual); phase {rec['wall_s']:.1f} s")
    del fe, state, params
    torch.cuda.empty_cache()
    return rec, launch_delta(mods, before)


def adapt_phase(dev, registry, dlrm, synthetic, serve_rec, adapt, tuned_state, tuned_params,
                mods) -> tuple[dict, dict]:
    """A stationary ``serve_adaptive`` session on full-width dlrm-qr is
    bitwise ``run_pipeline`` on the same batches (pinned residency against
    the oracle prefetcher: hits and misses load the same bits); the
    controller's host costs (``observe`` of one batch, ``evaluate`` over
    every table's 2M rows); then a drifting session with ``refit=True`` on
    the tuner-armed state.  Batch ``ADAPT_BATCH``."""
    from repro_torch.adapt import loop

    cfg = registry.get_dlrm("dlrm-qr")
    batch = ADAPT_BATCH
    before = launches_now(mods)
    t0 = time.perf_counter()
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    ref = serve_rec.run_pipeline(cfg, batch=batch, batches=4, mode="sequential", state=state,
                                 params=params, device=dev)
    idx = [synthetic.dlrm_batch(cfg, batch, seed=0, step=t, device=dev)["idx"].cpu().numpy()
           for t in range(4)]
    res = loop.serve_adaptive(cfg, batch=batch, batches=4, seed=0, state=state,
                              params=params, idx_override=idx)
    for t in range(4):
        if not np.array_equal(ref["logits"][t], res["logits"][t]):
            raise AssertionError(f"adapt: stationary logits of batch {t} are not the "
                                 f"pipeline's")
    log(f"[adapt] stationary: 4 batches of {batch}, logits bitwise run_pipeline's "
        f"(hit rate pinned {res['hit_rate']:.4f}, prefetch {ref['hit_rate']:.4f})")
    ctl = adapt.AdaptController(state.eplan, seed=0)
    tc = time.perf_counter()
    ctl.observe(idx[1])
    observe_s = time.perf_counter() - tc
    tc = time.perf_counter()
    ctl.evaluate(ctl.fresh_caches())
    evaluate_s = time.perf_counter() - tc
    log(f"[adapt] controller host cost on full-width dlrm-qr: observe one batch of {batch} "
        f"{observe_s:.3f} s, evaluate (26 tables x {cfg.vocab_per_table:,} rows) "
        f"{evaluate_s:.3f} s")
    del state, params, ctl
    torch.cuda.empty_cache()
    engine_before = tuned_state.engine
    ctl = adapt.AdaptController(tuned_state.eplan, policy=adapt.AdaptPolicy(**ADAPT_POLICY),
                                seed=0)
    drift = loop.serve_adaptive(
        cfg, batch=batch, batches=16, seed=0, state=tuned_state, params=tuned_params,
        controller=ctl, schedule=adapt.DriftSchedule(period=6, fraction=0.25), refit=True,
        refit_kw=dict(max_samples=2, repeats=1))
    hs = drift["hit_series"]
    for ev in drift["events"]:
        log(f"[adapt] drift event at batch {ev['batch']}: {ev['kind']}"
            + (f", gain {ev['gain']}" if "gain" in ev else "")
            + (f", staged {ev['staged_rows']} rows" if "staged_rows" in ev else "")
            + (f", refit knobs {ev['knobs']}" if "knobs" in ev else ""))
    rec = {"config": "dlrm-qr", "batch": batch, "stationary_bitwise": True,
           "observe_s": observe_s, "evaluate_s": evaluate_s,
           "drift_schedule": drift["schedule"], "policy": ADAPT_POLICY, "hit_series": hs,
           "staged_series": drift["staged_series"],
           "events": [{k: v for k, v in e.items() if k != "drift"} for e in drift["events"]],
           "engine_rebuilt": tuned_state.engine is not engine_before,
           "batch_p50_ms": drift["lat_p50_s"] * 1e3, "wall_s": time.perf_counter() - t0}
    log(f"[adapt] drifting (period 6 batches, fraction 0.25), 16 batches of {batch}: "
        f"hit rate per batch {' '.join(f'{h:.3f}' for h in hs)}; "
        f"{len(drift['events'])} events, engine rebuilt {rec['engine_rebuilt']}, batch p50 "
        f"{rec['batch_p50_ms']:.2f} ms; phase {rec['wall_s']:.1f} s")
    return rec, launch_delta(mods, before)


def cli_control_runs(serve_rec, obs, mods) -> tuple[dict, dict]:
    """``serve_rec.main`` on dlrm-qr-smoke with ``--frontend --arrival
    --faults`` and with ``--adapt --drift``; each ``--json`` record parses."""
    out = ROOT / "build" / "serve_cli"
    out.mkdir(parents=True, exist_ok=True)
    before = launches_now(mods)
    runs = {
        "frontend": ["--frontend", "--arrival", "rate=400,horizon=2,flash=0.5+0.4x6",
                     "--faults", "stall@0.6:0.5,drop@0.7,replica@0.8:0.3,gather@1.0:1"],
        "adaptive": ["--adapt", "--drift", "period=8,frac=0.25", "--batches", "24"],
    }
    recs = {}
    for mode, flags in runs.items():
        path = out / f"{mode}.json"
        try:
            rc = serve_rec.main(["--arch", "dlrm-qr", "--smoke", *flags, "--json", str(path)])
        finally:
            obs.disable()
            obs.install_observatory()
        (rec,) = json.loads(path.read_text())
        if rc != 0 or rec["mode"] != mode:
            raise AssertionError(f"serve_rec.main --{mode}: rc {rc}, record {rec.get('mode')}")
        recs[mode] = rec
    fr, ad = recs["frontend"], recs["adaptive"]
    if fr["requests"]["unaccounted"] != 0 or not ad["events"]:
        raise AssertionError("serve_rec.main: frontend accounting or adaptive events wrong")
    log(f"[control-cli] --frontend: {fr['requests']['generated']} requests, served "
        f"{fr['requests']['served']}, {len(fr['degrade']['transitions'])} transitions, "
        f"virtual p99 {fr['req_lat_p99_s'] * 1e3:.1f} ms; --adapt: hit "
        f"{ad['hit_first']:.3f} -> {ad['hit_last']:.3f}, events "
        f"{[e['kind'] for e in ad['events']]}")
    obs.registry().reset()
    obs.tracer().reset()
    return ({"frontend": {"requests": fr["requests"],
                          "transitions": len(fr["degrade"]["transitions"])},
             "adaptive": {"hit_first": ad["hit_first"], "hit_last": ad["hit_last"],
                          "events": [e["kind"] for e in ad["events"]]}},
            launch_delta(mods, before))


def control_plane_phase(dev, batch, by_name, mods) -> dict:
    """Phase 8: the tuner, the ladder's rungs on the three configs, the front
    end, adaptation and the two CLI runs; their launches add to the kernel
    rows.  Returns the ``{"control_plane": ...}`` record."""
    from repro_torch import adapt, engine, obs, serve, tune
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.launch import serve_rec
    from repro_torch.models import dlrm

    t0 = time.perf_counter()
    record = {}
    tp = time.perf_counter()
    record["tuner"], tuned_state, tuned_params, n = tuner_phase(
        dev, batch, registry, dlrm, synthetic, serve_rec, engine, tune, mods)
    add_launches(by_name, n)
    log(f"[tuner] phase {time.perf_counter() - tp:.1f} s")
    record["rungs"] = []
    for arch in ("dlrm-qr", "dlrm-tt", "dlrm-dense"):
        rec, n = rungs_phase(dev, arch, batch, registry, dlrm, synthetic, serve_rec, engine,
                             serve, mods)
        record["rungs"].append(rec)
        add_launches(by_name, n)
    record["frontend"], n = frontend_phase(dev, registry, dlrm, serve_rec, serve, obs, mods)
    add_launches(by_name, n)
    record["adapt"], n = adapt_phase(dev, registry, dlrm, synthetic, serve_rec, adapt,
                                     tuned_state, tuned_params, mods)
    add_launches(by_name, n)
    del tuned_state, tuned_params
    torch.cuda.empty_cache()
    record["cli"], n = cli_control_runs(serve_rec, obs, mods)
    add_launches(by_name, n)
    record["phase_s"] = time.perf_counter() - t0
    log(f"[control] phase {record['phase_s']:.1f} s")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    from repro_torch import engine, obs
    from repro_torch.configs import registry
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.core import embedding_bag, hashing, qr_embedding, tt_embedding
    from repro_torch.core import packed_tables as pt
    from repro_torch.data import synthetic
    from repro_torch.examples import cache_plan, quickstart, train_dlrm
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cached_gather as cg
    from repro_torch.kernels import gnr_bag as gb
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.kernels import tt_gather as tg
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve_rec
    from repro_torch.launch import train as train_cli
    from repro_torch.models import dlrm
    from repro_torch.obs import attribution
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step
    mods = (pg, tg, cg, gb, qg, fa)

    # the plain versions' products in full fp32, as the kernels compute them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    logs = build.build(sources)
    log(f"[build] {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in logs[src].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[ptxas] {line.strip()}")
    sass = tensor_core_sass(build)

    reference_phase(dev, serve_rec, registry, dlrm, synthetic)
    cached_reference_phase(dev, registry, dlrm, synthetic, qr_embedding, engine)
    batch = DLRM_SHAPES[0].global_batch          # serve_2k: 2048 requests
    kernels = kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref)
    kernels += tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                               tt_embedding, sass)
    kernels += pertable_kernel_phase(dev, batch, registry, dlrm, synthetic, hashing,
                                     qr_embedding, ref, cg, gb, qg)
    # the packed kernels' bf16 entries at the training path's shapes (train_8k)
    train_batch = DLRM_SHAPES[1].global_batch                # 8,192
    kernels += kernel_phase(dev, train_batch, registry, dlrm, synthetic, pt, pg, ref,
                            dtype=torch.bfloat16)
    kernels += tt_kernel_phase(dev, train_batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                               tt_embedding, sass, dtype=torch.bfloat16)
    by_name = {k["name"]: k for k in kernels}
    # K2 and K5 at rank 64: the sliced staging path, in each type's row
    for r in tt_rank64_phase(dev, registry, dlrm, synthetic, pt, pg, tg, ref, tt_embedding,
                             train_dlrm):
        suffix = "" if r["dtype"] == "float32" else "_bf16"
        by_name[r["kernel"] + suffix].setdefault("rank64", []).append(r)
    splits = []
    for arch, batches, tel_batches in (("dlrm-qr", 6, 4), ("dlrm-dense", 3, 3),
                                       ("dlrm-tt", 6, 4)):
        launches, split = serve_phase(dev, arch, batch, batches, tel_batches, serve_rec,
                                      registry, dlrm, synthetic, pg, tg, tt_embedding, obs,
                                      attribution)
        splits.append(split)
        for name, n in launches.items():
            by_name[name]["launches"] = n
    by_name["packed_qr_bag"]["launches"] += cli_serve_run(serve_rec, obs)
    # phase 5: each run's launches add to its kernel's count
    t0 = time.perf_counter()
    for arch in ("dlrm-qr", "dlrm-dense", "dlrm-tt"):
        n = cached_lookup_run(dev, arch, batch, 4, registry, dlrm, synthetic, qr_embedding,
                              embedding_bag, engine, mods)
        by_name[PERTABLE_KERNEL[registry.get_dlrm(arch).embedding_kind]]["launches"] += n
    for name, n in ops_entry_runs(dev, batch, registry, dlrm, synthetic, hashing,
                                  qr_embedding, ops, mods).items():
        by_name[name]["launches"] += n
    hashed_lookup_run(dev, batch, registry, dlrm, synthetic, embedding_bag, engine, mods)
    for name, n in examples_run(mods, quickstart, cache_plan).items():
        by_name[name]["launches"] += n
    log(f"[per-table] phase {time.perf_counter() - t0:.1f} s")

    # phase 6: attention
    t0 = time.perf_counter()
    kernels.append(flash_phase(dev, ops, fa, ref, sass))
    log(f"[flash] phase {time.perf_counter() - t0:.1f} s")

    # phase 7: training at train_8k (every launch of the packed kernels there
    # is their bf16 entry: the lookup packs in the compute dtype)
    t0 = time.perf_counter()
    training = []
    for arch in ("dlrm-qr", "dlrm-tt", "dlrm-dense"):
        r = train_phase(dev, arch, train_batch, registry, dlrm, synthetic, train_step, opt,
                        tree, pt, ops, ref, mods)
        training.append(r)
        by_name[r["kernel"] + "_bf16"]["launches"] += r["launches"]
    by_name["packed_qr_bag_bf16"]["launches"] += cli_train_run(train_cli, train_batch, mods)
    by_name["packed_tt_bag_bf16"]["launches"] += rank64_example_run(mods, train_dlrm)
    lookup_grad = tt_lookup_grad_run(dev, registry, dlrm, synthetic, tt_embedding, ref, ops,
                                     mods)
    by_name["tt_bag_bf16"]["launches"] += lookup_grad.pop("launches")
    by_name["tt_bag_bf16"]["lookup_grad"] = lookup_grad
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")

    # phase 8: the serving control plane (fp32 serving launches of K1/K3/K2/K5)
    control = control_plane_phase(dev, batch, by_name, mods)
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    for split in splits:
        print(json.dumps({"serve_split": split}), flush=True)
    print(json.dumps({"training": training}), flush=True)
    print(json.dumps({"control_plane": control}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
