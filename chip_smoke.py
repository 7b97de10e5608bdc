"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each one failing the script if it fails:

1. build every CUDA source of ``src/repro_torch/csrc`` with ``nvcc`` (all
   started together) and print the ``-Xptxas -v`` summary;
2. reference: serve dlrm-qr-smoke, dlrm-dense-smoke and dlrm-tt-smoke on the
   card and on the CPU (the kernels' plain versions) with the same weights
   and batches; the logits agree;
3. kernels: call K1 ``packed_qr_bag``, K3 ``packed_bag`` and K2
   ``packed_tt_bag`` at the shapes the full-width main path gives them
   (B = 2048, T = 26, K = 32, dim 128; the cache block holds this batch's
   most used big-table rows, as many as the plan's slot total: 16,384 rows
   of 512 B, 1,024 G2 rows of 8 KiB), and K5 ``tt_bag`` on one dlrm-tt
   table's cores as ``tt_embedding.lookup`` calls it (65,536 lookups of
   K = 1) and pooled (2,048 x 32); hold each against its plain PyTorch
   version on the same inputs (max abs error <= 1e-4, TF32 off), and time
   kernel, plain version and, where one exists, the one PyTorch call that
   computes the same function (``embedding_bag``) with CUDA events;
4. serve dlrm-qr at full width (26 x 2M rows, dim 128, pooling 32), batch
   2048, 6 batches, dlrm-dense at full width, 3 batches, and dlrm-tt at full
   width (26 x 2M logical rows as TT cores, rank 16), 6 batches, each in
   both modes: overlap logits equal sequential logits to 1e-6, all finite,
   and the kernel's launch count equals the batches served in each run;
   then one ``tt_embedding.lookup`` on a dlrm-tt table launches K5 once.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits
with code 2 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BW_BYTES_S = 3.35e12          # H100 SXM HBM3 (data sheet)
FP32_FLOP_S = 67e12           # H100 SXM fp32 outside the tensor cores
ERR_TOL = 1e-4


def log(*a) -> None:
    print(*a, flush=True)


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
    slots = plan_slots(cfg, layout)
    counts = torch.bincount(big.reshape(-1).long(), minlength=layout.total_rows + 1)
    top = torch.topk(counts, slots).indices
    slot_of = torch.full_like(counts, -1)
    slot_of[top] = torch.arange(slots, device=dev)
    streams["slot"] = slot_of[big.long()].to(torch.int32)
    return streams, top


def bound(streams, read_bytes: int, out_bytes: int, flops: int):
    """(bound_ms, bound_by, bytes): each input byte read once (the index
    streams, plus ``read_bytes`` of unique rows this batch touches), each
    output byte written once; ``flops`` over the fp32 peak."""
    nbytes = sum(s.numel() * 4 for s in streams) + read_bytes + out_bytes
    t_bytes, t_ops = nbytes / BW_BYTES_S, flops / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


def unique(t: torch.Tensor) -> int:
    return int(torch.unique(t).numel())


def kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref) -> list[dict]:
    import torch.nn.functional as F

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    out = []
    for name, arch in (("packed_qr_bag", "dlrm-qr"), ("packed_bag", "dlrm-dense")):
        cfg = registry.get_dlrm(arch)
        layout = pt.build_layout(dlrm.make_bags(cfg))
        s, top = main_path_streams(cfg, layout, pt, synthetic, dev, batch=batch)
        dim = cfg.dim
        big = torch.empty((layout.total_rows + 1, dim), device=dev)
        big.normal_(generator=g).mul_(dim ** -0.5)
        cache = big[top]
        miss = torch.full_like(s["slot"], -1)
        hit = s["slot"] >= 0
        if name == "packed_qr_bag":
            r_lut = torch.randn((layout.total_small + 1, dim), generator=g, device=dev)
            args = (big, cache, r_lut, s["q_idx"], s["slot"], s["r_idx"])
            kern, plain = pg.packed_qr_bag, ref.packed_qr_bag_ref
            miss_args = (big, cache, r_lut, s["q_idx"], miss, s["r_idx"])
            library = lambda: (F.embedding_bag(s["q_idx"], big, mode="sum")
                               + F.embedding_bag(s["r_idx"], r_lut, mode="sum"))
            library_call = "embedding_bag(Q) + embedding_bag(R), all-miss stream"
            rows_read = (unique(s["q_idx"][~hit]) + unique(s["slot"][hit])
                         + unique(s["r_idx"]))
            streams = (s["q_idx"], s["slot"], s["r_idx"])
            adds = 2 * s["q_idx"].numel() * dim
        else:
            args = (big, cache, s["idx"], s["slot"])
            kern, plain = pg.packed_bag, ref.packed_bag_ref
            miss_args = (big, cache, s["idx"], miss)
            library = lambda: F.embedding_bag(s["idx"], big, mode="sum")
            library_call = "embedding_bag(T), all-miss stream"
            rows_read = unique(s["idx"][~hit]) + unique(s["slot"][hit])
            streams = (s["idx"], s["slot"])
            adds = s["idx"].numel() * dim
        got = kern(*args)
        torch.cuda.synchronize()
        expect = plain(*args)
        err = float((got - expect).abs().max())
        lib_err = float((kern(*miss_args) - library()).abs().max())
        if not err <= ERR_TOL or not lib_err <= ERR_TOL:
            raise AssertionError(f"{name}: kernel vs plain max abs error {err}, "
                                 f"all-miss kernel vs library {lib_err}")
        del expect
        bound_ms, bound_by, nbytes = bound(streams, rows_read * dim * 4,
                                           got.numel() * 4, adds)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/packed_gather.cu",
            "replaces": ("src/repro/kernels/packed_gather.py:130 -> cached_gather.py:123"
                         if name == "packed_qr_bag" else
                         "src/repro/kernels/packed_gather.py:103 -> cached_gather.py:82"),
            "launches": 0,
            "max_abs_err": err,
            "ms": timed(lambda: kern(*args), 50),
            "plain_ms": timed(lambda: plain(*args), 3, warm=1),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timed(library, 20),
            "library_call": library_call,
            "all_miss_ms": timed(lambda: kern(*miss_args), 50),
            "bytes": nbytes, "hit_share": float(hit.float().mean()),
            "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": dim,
                      "rows": big.shape[0], "slots": cache.shape[0]},
        }
        row["kernel_ms"] = row["ms"]
        log(f"[kernels] {name}: err {err:.3e}, kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes} B), "
            f"hit share {row['hit_share']:.3f}")
        out.append(row)
        del big, cache, args, miss_args, got, s, top
        torch.cuda.empty_cache()
    return out


TT_LIBRARY = ("none: no one PyTorch call computes a TT bag (a gather of three "
              "cores, two chained per-lookup products, then a pooled sum)")


def tt_bound(spec, streams, i1, i2_miss, hit_slots, i3, out_rows: int):
    """Bound of a TT bag: 20,480 flops per dlrm-tt lookup (two products of
    FMAs), bytes of the streams, the unique G2 / cache, G1 and G3 rows this
    run touches, and the fp32 output."""
    d1, d2, d3, r = spec.dims
    lookups = i1.numel()
    flops = 2 * lookups * (d1 * r * d2 * r + d1 * d2 * r * d3)
    read = ((unique(i2_miss) + unique(hit_slots)) * spec.g2_width
            + unique(i1) * spec.g1_width + unique(i3) * spec.g3_width) * 4
    return bound(streams, read, out_rows * spec.dim * 4, flops)


def chunked(fn, cores, streams, dims, chunk: int = 4096):
    """The plain version over G in chunks: gathering every lookup's 8 KiB
    G2 row at once would take ~14 GB at full width."""
    g = streams[0].shape[0]
    return torch.cat([fn(*cores, *(s[i:i + chunk] for s in streams), dims=dims)
                      for i in range(0, g, chunk)])


def tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                    tt_embedding) -> list[dict]:
    """K2 at the main path's shapes and K5 on one table's cores, each held
    against its plain version and timed."""
    cfg = registry.get_dlrm("dlrm-tt")
    bags = dlrm.make_bags(cfg)
    spec = bags[0].emb.tt_spec
    dims = spec.dims
    layout = pt.build_layout(bags)
    params = dlrm.init_dlrm(cfg, seed=5, device=dev)          # cores at init scale
    packed = pt.pack_params(params["tables"], layout)
    s, top = main_path_streams(cfg, layout, pt, synthetic, dev, batch=batch)
    cache = packed["g2"][top]
    cores = (packed["g1"], packed["g2"], packed["g3"], cache)
    streams = (s["i1"], s["i2"], s["i3"], s["slot"])
    hit = s["slot"] >= 0
    got = pg.packed_tt_bag(*cores, *streams, dims=dims)
    torch.cuda.synchronize()
    err = float((got - chunked(ref.packed_tt_bag_ref, cores, streams, dims)).abs().max())
    if not err <= ERR_TOL:
        raise AssertionError(f"packed_tt_bag: kernel vs plain max abs error {err}")
    bound_ms, bound_by, nbytes = tt_bound(spec, streams, s["i1"], s["i2"][~hit],
                                          s["slot"][hit], s["i3"], got.shape[0])
    k2 = {
        "name": "packed_tt_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/packed_gather.py:158",
        "launches": 0, "max_abs_err": err,
        "ms": timed(lambda: pg.packed_tt_bag(*cores, *streams, dims=dims), 20),
        "plain_ms": timed(lambda: chunked(ref.packed_tt_bag_ref, cores, streams, dims),
                          3, warm=1),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": nbytes, "hit_share": float(hit.float().mean()),
        "shape": {"G": s["slot"].shape[0], "K": s["slot"].shape[1], "dim": spec.dim,
                  "rows": packed["g2"].shape[0], "slots": cache.shape[0],
                  "dims": list(dims)},
    }
    k2["kernel_ms"] = k2["ms"]
    log(f"[kernels] packed_tt_bag: err {err:.3e}, kernel {k2['ms']:.4f} ms, "
        f"plain {k2['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
        f"{nbytes} B), hit share {k2['hit_share']:.3f}")
    del got, packed, cache, cores, streams, s, top

    # K5 on table 0's cores: the lookup path (K = 1) and one pooled batch
    table = params["tables"][0]
    one = (table["g1"], table["g2"], table["g3"])
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.pooling), seed=12,
                               step=0, device=dev)
    pooled = tt_embedding.tt_decompose(idx, spec)
    lookups = tuple(x.reshape(-1, 1) for x in pooled)
    rows = {}
    for shape, st in (("lookup", lookups), ("pooled", pooled)):
        out = tg.tt_bag(*one, *st, dims=dims)
        torch.cuda.synchronize()
        e = float((out - ref.tt_bag_ref(*one, *st, dims=dims)).abs().max())
        if not e <= ERR_TOL:
            raise AssertionError(f"tt_bag ({shape}): kernel vs plain max abs error {e}")
        b_ms, b_by, nb = tt_bound(spec, st, st[0], st[1], st[1][:0], st[2], out.shape[0])
        rows[shape] = dict(err=e, bound_ms=b_ms, bound_by=b_by, bytes=nb,
                           ms=timed(lambda: tg.tt_bag(*one, *st, dims=dims), 20),
                           plain_ms=timed(lambda: ref.tt_bag_ref(*one, *st, dims=dims),
                                          3, warm=1))
    lk, pl = rows["lookup"], rows["pooled"]
    k5 = {
        "name": "tt_bag", "route": "cuda",
        "source": "src/repro_torch/csrc/tt_bag.cu",
        "replaces": "src/repro/kernels/tt_gather.py:64",
        "launches": 0, "max_abs_err": max(lk["err"], pl["err"]),
        "ms": lk["ms"], "plain_ms": lk["plain_ms"],
        "bound_ms": lk["bound_ms"], "bound_by": lk["bound_by"],
        "library_ms": None, "library_call": TT_LIBRARY,
        "bytes": lk["bytes"],
        "pooled_ms": pl["ms"], "pooled_plain_ms": pl["plain_ms"],
        "pooled_bound_ms": pl["bound_ms"], "pooled_bound_by": pl["bound_by"],
        "shape": {"lookup": [lookups[0].shape[0], 1], "pooled": list(pooled[0].shape),
                  "dim": spec.dim, "rows": table["g2"].shape[0], "dims": list(dims)},
    }
    k5["kernel_ms"] = k5["ms"]
    log(f"[kernels] tt_bag: err {k5['max_abs_err']:.3e}; lookup ({lookups[0].shape[0]} x 1) "
        f"kernel "
        f"{lk['ms']:.4f} ms, plain {lk['plain_ms']:.4f} ms, bound {lk['bound_ms']:.4f} ms "
        f"({lk['bound_by']}); pooled ({batch} x {cfg.pooling}) kernel {pl['ms']:.4f} ms, "
        f"plain {pl['plain_ms']:.4f} ms, bound {pl['bound_ms']:.4f} ms ({pl['bound_by']})")
    del params, table, one
    torch.cuda.empty_cache()
    return [k2, k5]


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

KERNEL_OF = {"qr": "packed_qr_bag", "dense": "packed_bag", "tt": "packed_tt_bag"}


def reset_counts(pg, tg) -> None:
    pg.reset_launches()
    tg.reset_launches()


def serve_phase(dev, arch, batch, batches, serve_rec, registry, dlrm, synthetic, pg,
                tg, tt_embedding) -> dict:
    """Serve ``arch`` at full width in both modes; returns the launches of
    each kernel over both runs (and, for TT, of K5 in one lookup)."""
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
    device_share(arch, lambda: serve_rec.run_pipeline(
        cfg, batch=batch, batches=3, mode="sequential", state=state, params=params,
        packed=packed, device=dev))
    del packed, params, state
    torch.cuda.empty_cache()
    return launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.core import packed_tables as pt
    from repro_torch.core import tt_embedding
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import tt_gather as tg
    from repro_torch.launch import serve_rec
    from repro_torch.models import dlrm

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

    reference_phase(dev, serve_rec, registry, dlrm, synthetic)
    batch = DLRM_SHAPES[0].global_batch          # serve_2k: 2048 requests
    kernels = kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, ref)
    kernels += tt_kernel_phase(dev, batch, registry, dlrm, synthetic, pt, pg, tg, ref,
                               tt_embedding)
    by_name = {k["name"]: k for k in kernels}
    for arch, batches in (("dlrm-qr", 6), ("dlrm-dense", 3), ("dlrm-tt", 6)):
        launches = serve_phase(dev, arch, batch, batches, serve_rec, registry, dlrm,
                               synthetic, pg, tg, tt_embedding)
        for name, n in launches.items():
            by_name[name]["launches"] = n
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
