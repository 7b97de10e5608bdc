"""Readings of ``chip_smoke.py``'s step-1 table-gradient check at several
batch sizes, on the card.

The check holds the dlrm-qr / dlrm-tt / dlrm-dense step-1 table gradients
of the kernel path (``train_step.make_dlrm_loss``: the kernels' forward, the
fp32 chunked recompute backward) against the plain path
(``chip_smoke.plain_dlrm_loss``: the packed buffers widened to fp32, so its
embedding-bag backward runs in fp32 and rounds once) at batch 64, per leaf
as max |kernel − plain| over max |plain|, against ``chip_smoke.GRAD_TOL``.
This script prints the same reading at more batch sizes (more recompute
chunks for dlrm-tt: 1 / 2 / 7 at 64 / 256 / 1024), so that the limit rests
on what sound runs read rather than on one batch.  It changes nothing.

Usage (from the repo root, on a machine with a CUDA card):
    python3 scripts/torch_step1_grad_readings.py [--arch dlrm-tt] [--batches 64 256 1024]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import packed_tables as pt  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.train import train_step  # noqa: E402


def readings(arch: str, batches: list[int], dev: torch.device) -> list[dict]:
    """Per batch size: every table leaf's reading and the worst."""
    cfg = cs.train_config(arch, registry)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    truth = synthetic.dlrm_truth(cfg, device=dev)
    full = synthetic.dlrm_planted_batch(cfg, truth, max(batches), seed=0, step=0, device=dev)
    loss_fn = train_step.make_dlrm_loss(cfg)
    plain_fn = lambda p, b: (cs.plain_dlrm_loss(p, b, cfg, dlrm, pt, ref), {})
    rows = []
    for n in batches:
        cut = {k: v[:n] for k, v in full.items()}
        _l, _m, g_kernel = train_step.value_and_grad(loss_fn, params, cut)
        _l, _m, g_plain = train_step.value_and_grad(plain_fn, params, cut)
        leaves = {}
        for (path, a), b in zip(tree.leaves_with_paths(g_kernel["tables"]),
                                tree.leaves(g_plain["tables"])):
            scale = max(float(b.abs().max()), 1e-12)
            leaves[str(path)] = float((a - b).abs().max()) / scale
        worst = max(leaves, key=leaves.get)
        rows.append({"arch": cfg.name, "batch": n, "worst_leaf": worst,
                     "worst": leaves[worst], "limit": cs.GRAD_TOL, "leaves": leaves})
        cs.log(f"[grad] {cfg.name} batch {n}: worst {leaves[worst]:.4g} ({worst}), "
               f"limit {cs.GRAD_TOL}")
        del g_kernel, g_plain
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["dlrm-tt"])
    ap.add_argument("--batches", nargs="+", type=int, default=[64, 256, 1024])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are of the card's kernel path", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = [r for arch in args.arch for r in readings(arch, args.batches, dev)]
    print(json.dumps({"step1_grad_readings": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
