"""``chip_smoke.py``'s LM phases (11–16) and its CLI drills (17) alone, on
the card, from the checkout at ``--root`` (this one by default); 18 is
phase 16's meshed section (the prefix models on (1, 2) ranks) alone, and
``--phases 17 18`` runs phase 17 with phases 15's and 16's meshed sections
beside it, as the script does (``cli_and_meshed_phase``, the card's memory
in use watched): build
the sources those phases
launch (``flash_attention``, ``qr_gather``, ``tt_bag``), run the phases in
the script's order and print each phase's seconds and their sum as a
``{"lm_phases": ...}`` line (with the dry run's traces and peak holds
where the checkout's phases are sized by it).  Run it once on this checkout and once on an
earlier one (``git archive`` unpacked under ``experiments/``) in one call
to compare the phases' time on the same machine.

Usage (from the repo root, on a machine with a CUDA card):
    python3 scripts/torch_lm_phases.py [--root DIR] [--phases 11 12 13 14 15 16 17 18]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PHASES = {11: "lm_serving_phase", 12: "lm_train_phase", 13: "lm_mesh_phase", 14: "moe_phase",
          15: "ssm_phase", 16: "prefix_phase", 17: "cli_phase", 18: "prefix_mesh_phase"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", type=int, nargs="+", default=sorted(PHASES))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs         # puts root/src first on the path
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg
    from repro_torch.kernels import tt_gather as tg

    if not torch.cuda.is_available():
        print("torch_lm_phases: no CUDA card is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip())
    cs.log(f"checkout {root}")
    t0 = time.perf_counter()
    build.build(["flash_attention", "packed_gather", "qr_gather", "tt_bag"])
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    by_name = {name: {"launches": 0} for name in ("flash_fwd", "qr_gather", "tt_bag")}
    mods = (fa, qg, tg)
    secs = {}
    beside = {17, 18} <= set(args.phases)
    for n in args.phases:
        t0 = time.perf_counter()
        if beside and n == 17:
            continue
        if beside and n == 18:
            cs.cli_and_meshed_phase(dev, by_name, mods)
        else:
            getattr(cs, PHASES[n])(dev, by_name, mods)
        secs[n] = time.perf_counter() - t0
        cs.log(f"[phases] phase {n} {secs[n]:.1f} s")
    rec = {"root": str(root), "s": secs, "total_s": sum(secs.values()),
           "launches": {k: v["launches"] for k, v in by_name.items()}}
    if hasattr(cs, "DRYRUN"):        # a checkout whose phases are sized by the dry run
        rec["dryrun"] = {"traces": cs.DRYRUN["traces"], "s": cs.DRYRUN["s"],
                         "holds": cs.PEAK_HOLDS}
        cs.log(f"[dryrun] {cs.DRYRUN['traces']} traces on the CPU in {cs.DRYRUN['s']:.1f} s; "
               f"missed: {[h['cell'] for h in cs.PEAK_HOLDS if not h['ok']] or 'none'}")
    print(json.dumps({"lm_phases": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
