"""Batched LM serving with the weight-sharing vocabulary (port of
``examples/serve_lm.py``): prefill a prompt batch, decode greedily, report
tokens/s, then the steady decode rate.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch xlstm-125m] [--device cpu]

The default arch is ``repro``'s, xlstm-125m; ``--arch`` offers every arch
of the registry (whisper-large-v3's and pixtral-12b's batches carry their
frames or patches).  The smoke config is served, as in ``repro``, with the
QR vocabulary at collision 8 by default.  The steady decode steps run at
the positions after the prompt (pixtral's counted from the start of its
patches, as ``greedy_generate`` counts them).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_mod
from repro_torch.configs import registry
from repro_torch.train.serve_step import greedy_generate, serve_family


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=sorted(registry.ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--embedding", default="qr", choices=["dense", "hashed", "qr"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    binding = registry.get(args.arch)
    cfg = binding.smoke.replace(embedding_kind=args.embedding, qr_collision=8)
    fam = serve_family(binding.kind)
    params, _ = registry.init_fn(binding)(cfg, seed=0, device=dev)
    params = fam.prepare(params, cfg)
    batch = registry.make_batch_fn(binding, cfg)(args.batch, args.prompt_len, seed=0, step=0,
                                                 device=dev)
    max_len = args.prompt_len + args.max_new

    t0 = time.perf_counter()
    out = greedy_generate(fam, params, batch, cfg, max_new=args.max_new, max_len=max_len)
    device_mod.synchronize(dev)
    dt = time.perf_counter() - t0
    n = args.batch * args.max_new
    print(f"{args.arch} ({args.embedding} embedding): generated {tuple(out.shape)} "
          f"in {dt:.2f}s -> {n / dt:.1f} tok/s (prefill and decode, no compile step)")

    # steady-state decode rate
    with torch.inference_mode():
        logits, cache = fam.prefill(params, batch, cfg, max_len)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
        pos0 = args.prompt_len + (batch["patches"].shape[1] if "patches" in batch else 0)
        _, cache = fam.decode(params, cache, tok, pos0, cfg)      # warm
        iters = min(20, args.max_new)
        device_mod.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(iters):
            logits, cache = fam.decode(params, cache, tok, pos0 + i, cfg)
        device_mod.synchronize(dev)
        dt = time.perf_counter() - t0
    print(f"steady-state decode: {args.batch * iters / dt:.1f} tok/s "
          f"({dt / iters * 1000:.1f} ms/step)")


if __name__ == "__main__":
    main()
