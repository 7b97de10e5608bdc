"""Train a DLRM whose embedding layer is the paper's weight-sharing operator
(port of ``examples/train_dlrm.py``), with checkpoints.

26 tables x 200,000 rows x 64 dims, pooling 8: ~333M logical embedding
parameters served by ~5.3M physical ones through QR (collision 64), trained
on synthetic long-tail (Zipf) CTR batches with planted structure; it reports
the loss on the way and the held-out loss and AUC at the end.  The embedding
layer runs through ``EmbeddingEngine.lookup``: one packed kernel launch a
step on the card, its gradient by the kernels' plain-version recompute.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_dlrm [--steps 300] \\
          [--embedding qr|tt|dense] [--ckpt-dir DIR] [--device cpu]

Unlike ``repro``'s example, it checkpoints only when ``--ckpt-dir`` is given
(every 100 steps, resuming from the newest).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import DLRMConfig
from repro_torch.data.synthetic import dlrm_planted_batch, dlrm_truth
from repro_torch.models import dlrm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_dlrm_loss, make_train_step


def config(kind: str, tt_rank: int = 16) -> DLRMConfig:
    return DLRMConfig(
        name=f"dlrm-{kind}-example",
        num_tables=26,
        vocab_per_table=200_000,
        dim=64,
        pooling=8,
        bottom_mlp=(256, 128, 64),
        top_mlp=(256, 128, 1),
        embedding_kind=kind,
        qr_collision=64,
        tt_rank=tt_rank,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--embedding", choices=["qr", "tt", "dense"], default="qr",
                    help="weight-sharing algorithm (dense = paper baseline)")
    ap.add_argument("--dense-baseline", action="store_true",
                    help="alias for --embedding dense (paper baseline)")
    ap.add_argument("--tt-rank", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    kind = "dense" if args.dense_baseline else args.embedding

    cfg = config(kind, args.tt_rank)
    logical = cfg.num_tables * cfg.vocab_per_table * cfg.dim
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    physical = sum(t.numel() for t in tree.leaves(params["tables"]))
    print(f"logical embedding params {logical / 1e6:.0f}M -> physical "
          f"{physical / 1e6:.2f}M ({logical / max(physical, 1):.0f}x)")

    opt_cfg = opt_mod.OptConfig(lr=2e-3, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(make_dlrm_loss(cfg), opt_cfg)
    opt = opt_mod.init(params)

    start = 0
    latest = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest:
        (params, opt), _extra = ckpt.restore(args.ckpt_dir, latest, (params, opt))
        start = latest
        print(f"[resume] from step {start}")

    truth = dlrm_truth(cfg, device=dev)       # planted structure -> learnable AUC
    loss = None
    t0 = time.time()
    for s in range(start, args.steps):
        batch = dlrm_planted_batch(cfg, truth, args.batch, seed=0, step=s, device=dev)
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        if (s + 1) % 25 == 0:
            print(f"step {s + 1:4d}  loss {loss:.4f}  "
                  f"({(time.time() - t0) / (s - start + 1):.2f}s/step)")
        if args.ckpt_dir and (s + 1) % 100 == 0:
            ckpt.save(args.ckpt_dir, s + 1, (params, opt))
            ckpt.prune(args.ckpt_dir, keep=2)

    # evaluation on held-out batches
    test = dlrm_planted_batch(cfg, truth, 4096, seed=123, step=10_000, device=dev)
    with torch.no_grad():
        logits = dlrm.forward_dlrm(params, test["dense"], test["idx"], cfg)
        final = {"train_loss": loss,
                 "loss": float(dlrm.bce_loss(logits, test["labels"])),
                 "auc": float(dlrm.auc(logits, test["labels"]))}
    print(f"final: loss {final['loss']:.4f}  auc {final['auc']:.4f}")
    return final


if __name__ == "__main__":
    main()
