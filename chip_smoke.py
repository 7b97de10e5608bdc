"""Drive the PyTorch + CUDA port on one card and check it end to end.

    python3 chip_smoke.py

Phases, each one failing the script if it fails:

1. build every CUDA source of ``src/repro_torch/csrc`` with ``nvcc`` (all
   started together) and print the ``-Xptxas -v`` summary;
2. reference: serve dlrm-qr-smoke and dlrm-dense-smoke on the card and on
   the CPU (the kernels' plain versions) with the same weights and batches;
   the logits agree;
3. kernels: call K1 ``packed_qr_bag`` and K3 ``packed_bag`` at the shapes the
   full-width main path gives them (B = 2048, T = 26, K = 32, dim 128,
   16,384 cache slots holding this batch's most used rows), hold each against
   its plain PyTorch version on the same inputs (max abs error <= 1e-4), and
   time kernel, plain version and ``embedding_bag`` with CUDA events;
4. serve dlrm-qr at full width (26 x 2M rows, dim 128, pooling 32), batch
   2048, 6 batches, then dlrm-dense at full width, 3 batches, each in both
   modes: overlap logits equal sequential logits to 1e-6, all finite, and
   the kernel's launch count equals the batches served in each run.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits
with code 2 and prints no result.
"""

from __future__ import annotations

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
    for arch in ("dlrm-qr-smoke", "dlrm-dense-smoke"):
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

def main_path_streams(cfg, layout, pt, synthetic, dev, *, batch, slots=16_384):
    """One full-width batch's packed streams, with this batch's ``slots``
    most used big-table rows staged in the cache block (the prefetcher's
    rule, applied to the packed buffer)."""
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
                               seed=11, step=0, device=dev)
    streams = {k: v.reshape(-1, cfg.pooling) for k, v in pt.pack_indices(idx, layout).items()}
    big = streams["q_idx" if layout.kind == "qr" else "idx"]
    counts = torch.bincount(big.reshape(-1).long(), minlength=layout.total_rows + 1)
    top = torch.topk(counts, slots).indices
    slot_of = torch.full_like(counts, -1)
    slot_of[top] = torch.arange(slots, device=dev)
    streams["slot"] = slot_of[big.long()].to(torch.int32)
    return streams, top


def bound(streams, rows_read: int, out_bytes: int, adds: int):
    """(bound_ms, bound_by, bytes): each input byte read once, each output
    byte written once; rows_read unique 512 B rows this batch touches."""
    nbytes = sum(s.numel() * 4 for s in streams) + rows_read * 512 + out_bytes
    t_bytes, t_ops = nbytes / BW_BYTES_S, adds / FP32_FLOP_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            nbytes)


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
            rows_read = (int(torch.unique(s["q_idx"][~hit]).numel())
                         + int(torch.unique(s["slot"][hit]).numel())
                         + int(torch.unique(s["r_idx"]).numel()))
            streams = (s["q_idx"], s["slot"], s["r_idx"])
            adds = 2 * s["q_idx"].numel() * dim
        else:
            args = (big, cache, s["idx"], s["slot"])
            kern, plain = pg.packed_bag, ref.packed_bag_ref
            miss_args = (big, cache, s["idx"], miss)
            library = lambda: F.embedding_bag(s["idx"], big, mode="sum")
            library_call = "embedding_bag(T), all-miss stream"
            rows_read = (int(torch.unique(s["idx"][~hit]).numel())
                         + int(torch.unique(s["slot"][hit]).numel()))
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
        bound_ms, bound_by, nbytes = bound(streams, rows_read, got.numel() * 4, adds)
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


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def serve_phase(dev, arch, batch, batches, serve_rec, registry, dlrm, pg) -> int:
    """Serve ``arch`` at full width in both modes; returns the kernel's
    launches over both runs."""
    cfg = registry.get_dlrm(arch)
    kernel = "packed_qr_bag" if cfg.embedding_kind == "qr" else "packed_bag"
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=dev)
    packed = state.engine.pack(params.pop("tables"))   # frees the per-table copies
    torch.cuda.empty_cache()
    log(f"[{arch}] offline plan + init + pack {time.perf_counter() - t0:.1f} s, "
        f"packed rows {state.layout.total_rows}, slots {sum(state.slot_budgets)}")
    res, launches = {}, 0
    for mode in ("sequential", "overlap"):
        pg.reset_launches()
        r = serve_rec.run_pipeline(cfg, batch=batch, batches=batches, mode=mode,
                                   state=state, params=params, packed=packed, device=dev)
        n = pg.LAUNCHES[kernel]
        if n != batches:
            raise AssertionError(f"{arch} {mode}: {kernel} launched {n} times "
                                 f"for {batches} batches")
        launches += n
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
    del packed, params, state
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import registry
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.core import packed_tables as pt
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.launch import serve_rec
    from repro_torch.models import dlrm

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
    by_name = {k["name"]: k for k in kernels}
    by_name["packed_qr_bag"]["launches"] = serve_phase(
        dev, "dlrm-qr", batch, 6, serve_rec, registry, dlrm, pg)
    by_name["packed_bag"]["launches"] = serve_phase(
        dev, "dlrm-dense", batch, 3, serve_rec, registry, dlrm, pg)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
