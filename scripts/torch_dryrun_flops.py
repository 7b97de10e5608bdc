"""The dry run's counted flops beside ``chip_smoke.py``'s formulas, on the CPU.

For each arch at full width and depth: one ``prefill_32k`` sequence (the
prefill traced on meta by ``launch.dryrun.trace_serve``) beside the
script's ``prefill_flops`` / ``ssm_prefill_flops`` / ``prefix_prefill_flops``,
and one ``train_4k`` step of one sequence in one microbatch
(``trace_train``) beside ``lm_train_flops`` (the transformers and pixtral;
the others have no step formula).  The counted flops are PyTorch's
products (``FlopCounterMode``'s formulas) plus the kernels' (K9's 4·D a
visible pair).  Both are linear in the batch, so one sequence stands for
the cell.  Prints one line per cell, the ratio, and a ``{"flops": ...}``
line.

Usage (from the repo root; no card):
    PYTHONPATH=src python3 scripts/torch_dryrun_flops.py [--arch qwen2-1.5b ...] [--no-train]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

SEQ_PREFILL, SEQ_TRAIN = 32768, 4096


def formula(binding, cfg, kind: str):
    if kind == "train":
        if binding.kind not in ("transformer", "pixtral"):
            return None
        return cs.lm_train_flops(cfg, SEQ_TRAIN, SEQ_TRAIN)
    if binding.kind in ("zamba2", "xlstm"):
        return cs.ssm_prefill_flops(cfg, 1, SEQ_PREFILL)
    if binding.kind in ("whisper", "pixtral"):
        return cs.prefix_prefill_flops(cfg, 1, SEQ_PREFILL)
    return cs.prefill_flops(cfg, 1, SEQ_PREFILL)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(registry.ARCHS))
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args()
    out = []
    for arch in args.arch:
        b = registry.get(arch)
        cfg = b.config
        for kind in ("prefill",) + (() if args.no_train else ("train",)):
            if kind == "prefill":
                rec = dryrun.trace_serve(b, cfg, "prefill", 1, SEQ_PREFILL)
            else:
                rec = dryrun.trace_train(b, cfg, 1, SEQ_TRAIN)
            counted = rec["torch_flops"] + rec["kernel_flops"]
            want = formula(b, cfg, kind)
            row = {"arch": arch, "cell": "prefill_32k" if kind == "prefill" else "train_4k",
                   "counted": counted, "torch": rec["torch_flops"],
                   "kernels": rec["kernel_flops"], "formula": want,
                   "ratio": None if want is None else counted / want, "trace_s": rec["seconds"]}
            out.append(row)
            ratio = "no formula" if want is None else f"{row['ratio']:.4f}"
            print(f"{arch:22s} {row['cell']:12s} counted {counted:.4e} (torch {rec['torch_flops']:.4e}"
                  f", kernels {rec['kernel_flops']:.4e}) formula "
                  f"{'-' if want is None else f'{want:.4e}'} ratio {ratio} "
                  f"({rec['seconds']:.1f} s)", flush=True)
    print(json.dumps({"flops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
