"""Profile readings of the bag body (K1 ``packed_qr_bag``, K3 ``packed_bag``)
at the four shapes of its main paths, and device times of the per-table bags
(K4a, K4b, K6, K7) at one table's shapes, on the card, optionally beside an
earlier version of ``csrc/packed_gather.cu`` built in the same run.

Shapes (``chip_smoke.bag_case``): K1 fp32 serving (dlrm-qr, batch 2,048 x
26 tables x 32, the batch's hottest rows in the cache block), K1 bf16 at
train_8k (8,192 x 26 x 32, all miss), K3 fp32 serving (full dlrm-dense),
K3 bf16 at train_8k on dlrm-dense-200k.  Each line gives the time, the
unique bytes' share of the HBM peak, the row requests' rate and the time
with every request served from cache (``chip_smoke.bag_profile``).  Then
K4b / K6 (fp32 and bf16) on dlrm-qr table 0's shapes and K4a / K7 on
dlrm-dense table 0's, (2,048, 32) bags, timed in a CUDA graph
(``chip_smoke.graph_ms``: device time, without the wrapper's per-call host
work, which sets the back-to-back time of a bag this small).

With ``--baseline FILE`` an earlier source (the C interface without table
count, run length and load width) is built into ``build/baseline/``, held
bitwise equal to the current body on the same inputs and timed in turns
(baseline, current, current, baseline).

Usage (from the repo root, on a machine with a CUDA card):
    python3 scripts/torch_bag_profile.py [--baseline experiments/parent/packed_gather.cu]
        [--baseline-only]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import DLRM_SHAPES  # noqa: E402
from repro_torch.core import hashing  # noqa: E402
from repro_torch.core import packed_tables as pt  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import cached_gather as cg  # noqa: E402
from repro_torch.kernels import gnr_bag as gb  # noqa: E402
from repro_torch.kernels import packed_gather as pg  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the bag entries' C interface before the table count and run length
OLD_ARGS = {"packed_qr_bag": [_P] * 7 + [_I64, _INT, _INT, _I64, _I64, _I64, _P],
            "packed_bag": [_P] * 5 + [_I64, _INT, _INT, _I64, _I64, _P],
            "gnr_bag": [_P] * 5 + [_I64, _INT, _INT, _I64, _I64, _P],
            "gnr_bag_dense": [_P] * 3 + [_I64, _INT, _INT, _I64, _P]}


def load_baseline(src: Path) -> ctypes.CDLL:
    """Build ``src`` with the port's nvcc flags into build/baseline/ and load it."""
    out = build.BUILD_DIR.parent / "baseline" / f"lib{src.stem}_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    for name, args in OLD_ARGS.items():
        for sfx in pg.SUFFIX.values():
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def baseline_kern(lib, name: str):
    """The earlier body's entry as a callable of the case's arguments (the
    arguments of ``packed_qr_bag``, ``packed_bag``, ``gnr_bag`` or
    ``gnr_bag_dense``)."""
    def call(*a):
        t = a[0]
        g, k = a[-1].shape
        dim = t.shape[1]
        out = torch.empty((g, dim), dtype=t.dtype, device=t.device)
        fn = getattr(lib, f"{name}_{pg.SUFFIX[t.dtype]}")
        rows = [b.shape[0] for b in a if b.is_floating_point()]
        ptrs = [b.data_ptr() for b in a]
        err = fn(*ptrs, out.data_ptr(), g, k, dim, *rows,
                 torch.cuda.current_stream(t.device).cuda_stream)
        if err:
            raise RuntimeError(f"baseline {name} launch failed: cudaError {err}")
        return out
    return call


def pertable_cases(dev):
    """(label, entry, kernel, arguments) of the per-table bags at one
    full-width table's shapes, as ``chip_smoke.pertable_kernel_phase`` makes
    them: (2,048, 32) Zipf bags, the batch's 1,024 most used rows cached."""
    g = torch.Generator(device=dev).manual_seed(7)
    cfg = registry.get_dlrm("dlrm-qr")
    emb = dlrm.make_bags(cfg)[0].emb
    q = torch.randn((31_360, emb.dim), generator=g, device=dev) * emb.dim ** -0.5
    r = torch.randn((emb.collision, emb.dim), generator=g, device=dev) * emb.dim ** -0.5
    idx = synthetic.zipf_batch(cfg.vocab_per_table, (2048, cfg.pooling), seed=11, device=dev)
    qi, ri = hashing.qr_decompose(idx, emb.collision)
    slot, top = cs.top_slots(qi, q.shape[0], 1024)
    yield "K4b cached_qr_bag", "packed_qr_bag", cg.cached_qr_bag, (q, q[top], r, qi, slot, ri)
    yield "K6 gnr_bag", "gnr_bag", gb.gnr_bag, (q, r, qi, ri)
    yield "K6 gnr_bag bf16", "gnr_bag", gb.gnr_bag, (q.bfloat16(), r.bfloat16(), qi, ri)
    dense = torch.randn((2_000_000, emb.dim), generator=g, device=dev) * emb.dim ** -0.5
    idx = synthetic.zipf_batch(2_000_000, (2048, cfg.pooling), seed=12, device=dev)
    slot, top = cs.top_slots(idx, dense.shape[0], 1024)
    yield "K4a cached_bag", "packed_bag", cg.cached_bag, (dense, dense[top], idx, slot)
    yield "K7 gnr_bag_dense", "gnr_bag_dense", gb.gnr_bag_dense, (dense, idx)


def in_turns(bodies: dict, args, time) -> dict:
    """Each body's times, run in turns a, b, b, a."""
    order = list(bodies) + list(reversed(bodies))
    times = {b: [] for b in bodies}
    for b in order:
        times[b].append(time(lambda: bodies[b](*args)))
    return times


def check_same(bodies: dict, args, what: str) -> None:
    outs = {b: k(*args) for b, k in bodies.items()}
    torch.cuda.synchronize()
    if len(outs) == 2 and not torch.equal(outs["baseline"], outs["current"]):
        raise AssertionError(f"{what}: current body differs from the baseline")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--baseline-only", action="store_true",
                    help="profile only the baseline source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are of the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.log(card)
    base = load_baseline(args.baseline) if args.baseline else None
    rows = []
    for name, dtype, batch in (("packed_qr_bag", torch.float32, DLRM_SHAPES[0].global_batch),
                               ("packed_qr_bag", torch.bfloat16, DLRM_SHAPES[1].global_batch),
                               ("packed_bag", torch.float32, DLRM_SHAPES[0].global_batch),
                               ("packed_bag", torch.bfloat16, DLRM_SHAPES[1].global_batch)):
        c = cs.bag_case(dev, name, batch, dtype, registry, dlrm, synthetic, pt, pg, ref)
        elem = torch.finfo(dtype).bits // 8
        bound_ms, _by, nbytes = cs.bound(c["streams"], c["rows_read"] * c["dim"] * elem,
                                         c["s"]["slot"].shape[0] * c["dim"] * elem, c["adds"])
        bodies = {}
        if base is not None:
            bodies["baseline"] = baseline_kern(base, name)
        if not args.baseline_only:
            bodies["current"] = c["kern"]
        check_same(bodies, c["args"], f"{name} {dtype}")
        times = in_turns(bodies, c["args"], lambda f: cs.timed(f, 50))
        row = {"kernel": name, "dtype": str(dtype).replace("torch.", ""),
               "G": c["s"]["slot"].shape[0], "bound_ms": bound_ms,
               "hit_share": float(c["hit"].float().mean())}
        for b, k in bodies.items():
            row[b] = cs.bag_profile(c, min(times[b]), nbytes, kern=k)
            row[b]["ms_runs"] = times[b]
            cs.log(f"[profile] {name} {row['dtype']} G {row['G']} {b}: "
                   f"{', '.join(f'{t:.4f}' for t in times[b])} ms (bound {bound_ms:.4f}); "
                   f"{cs.fmt_profile(row[b])}")
        rows.append(row)
        del c
        torch.cuda.empty_cache()
    for label, entry, kern, a in pertable_cases(dev):
        bodies = {}
        if base is not None:
            bodies["baseline"] = baseline_kern(base, entry)
        if not args.baseline_only:
            bodies["current"] = kern
        check_same(bodies, a, label)
        times = in_turns(bodies, a, cs.graph_ms)
        rows.append({"kernel": label, "device_ms": times})
        cs.log(f"[profile] {label} (2,048 x 32), in a CUDA graph: " + "; ".join(
            f"{b} {', '.join(f'{t:.4f}' for t in ts)} ms" for b, ts in times.items()))
    print(json.dumps({"bag_profile": rows, "card": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
