"""Batched LM serving entry point (port of ``repro.launch.serve``): prefill a
prompt batch, decode greedily, print the generated shape, tokens/s and the
first sequence.

Usage (CPU smoke; without ``--device cpu`` it needs a CUDA card):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b --smoke \
        --device cpu --batch 4 --prompt-len 32 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-large-v3 --smoke \
        --device cpu --batch 2 --prompt-len 8 --max-new 4

Every arch of the registry serves; the prefix models' batches carry
whisper's frames or pixtral's patches (``registry.make_batch_fn``).

``repro``'s tokens/s includes its compile time.  The port has no compile
step: its time is the host clock from the prefill's start to the last
token on the device (synchronised), the kernels' one-time build included
on a card that has not built them yet.  The weights are cast once to the
compute dtype before serving (``ServeFamily.prepare``), which gives the
same tokens as casting them on every call.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch import device as device_mod
from repro_torch.configs import registry
from repro_torch.train.serve_step import greedy_generate, serve_family


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--embedding", default=None, choices=[None, "dense", "hashed", "qr"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (the default) needs a card; cpu runs the "
                         "kernels' plain versions")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    binding = registry.get(args.arch)
    cfg = binding.smoke if args.smoke else binding.config
    if args.embedding:
        cfg = cfg.replace(embedding_kind=args.embedding)
    fam = serve_family(binding.kind)
    params, _ = registry.init_fn(binding)(cfg, seed=args.seed, device=dev)
    params = fam.prepare(params, cfg)
    make_batch = registry.make_batch_fn(binding, cfg)
    batch = make_batch(args.batch, args.prompt_len, seed=args.seed, step=0, device=dev)
    max_len = args.prompt_len + args.max_new

    t0 = time.perf_counter()
    out = greedy_generate(fam, params, batch, cfg, max_new=args.max_new, max_len=max_len)
    device_mod.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s on {dev.type}: "
          f"prefill of {args.batch} x {args.prompt_len} + {args.max_new} decode steps, "
          f"host clock to the last token)")
    print("first sequence:", out[0].tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
