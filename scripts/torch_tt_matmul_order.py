"""Whether the plain TT contraction's two fp32 products (``torch.matmul`` on
the card, as ``kernels/ref.py::_tt_rows`` runs them) sum their depth in
order, for the TT dims the port serves.

Each product is held against a sequential fmaf chain over its depth,
emulated in float64 (each product exact, one rounding to fp32 a step; this
emulation can differ from a true fmaf chain in about one step in 2^29).
The kernels K2 / K5 sum in depth order, so where a product reads "in order"
their outputs can be bitwise the plain version's; where it does not, no
in-order body can be, and the kernels are held to the plain version by the
contract (1e-4 fp32, one rounding bf16) instead.

Usage (from the repo root, on a machine with a CUDA card):
    python3 scripts/torch_tt_matmul_order.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

DIMS = [(4, 4, 4, 64), (4, 8, 4, 64), (4, 8, 4, 16), (4, 4, 2, 4)]
BATCHES = (1024, 8192)


def in_order(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1] + (y.shape[-1],), dtype=torch.float32, device=x.device)
    for p in range(x.shape[-1]):
        acc = (acc.double() + x[..., p, None].double() * y[..., p, None, :].double()).float()
    return acc


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card: the readings are of the card's matmul", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dims in DIMS:
        d1, d2, d3, r = dims
        for n in BATCHES:
            a = torch.randn((n, d1, r), generator=g, device=dev)
            m = torch.randn((n, r, d2 * r), generator=g, device=dev)
            c = torch.randn((n, r, d3), generator=g, device=dev)
            t = torch.matmul(a, m)
            t2 = t.reshape(n, d1 * d2, r)
            row = {"dims": list(dims), "n": n,
                   "a_at_m_differing": float((t != in_order(a, m)).float().mean()),
                   "t_at_c_differing": float((torch.matmul(t2, c) != in_order(t2, c)).float()
                                             .mean())}
            rows.append(row)
            print(f"[order] dims {dims} n {n}: A@M outputs off the in-order chain "
                  f"{row['a_at_m_differing']:.2e}, t@C {row['t_at_c_differing']:.2e}",
                  flush=True)
    print(json.dumps({"tt_matmul_order": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
