"""DLRM training launcher: config -> params -> train loop, fault-tolerant (port
of ``repro.launch.train`` for ``--arch dlrm-*``).

* auto-resume from the newest atomic checkpoint (params, optimizer state and
  the data pipeline's cursor) under ``--ckpt-dir``;
* preemption safety: SIGTERM or SIGINT makes the loop checkpoint after the
  step in flight and exit 0;
* deterministic data: batch = f(seed, step), so a restart replays the same
  batches;
* the embedding layer runs through ``EmbeddingEngine.lookup`` (one packed
  kernel launch a step, differentiable), and batches carry planted CTR
  structure so the loss is learnable.

Runs on the card unless ``--device cpu`` is given.  ``--mesh-shape`` waits
for the sharded slice of the port and ``--seq`` (and the LM archs) for its
LM side.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-qr --smoke \\
        --steps 20 --batch 16 --device cpu --ckpt-dir <dir>
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import time

from repro_torch import device as device_mod
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.engine import EngineSpec, engine_for
from repro_torch.models import dlrm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_dlrm_loss, make_train_step


def build(args, dev):
    """-> (cfg, params, opt_state, step_fn, make_batch)."""
    if not args.arch.startswith("dlrm"):
        raise ValueError(f"--arch {args.arch}: the port trains dlrm-* only "
                         "(the LM archs wait for its LM side)")
    cfg = registry.get_dlrm(f"{args.arch}-smoke" if args.smoke else args.arch)
    if args.embedding:
        cfg = dataclasses.replace(cfg, embedding_kind=args.embedding)
    params = dlrm.init_dlrm(cfg, seed=args.seed, device=dev)
    opt_state = opt_mod.init(params)
    eng = engine_for(EngineSpec.from_bags(dlrm.make_bags(cfg)))
    print(f"[engine] {cfg.name}: {eng.summary()}")
    truth = synthetic.dlrm_truth(cfg, device=dev)

    def make_batch(batch, **kw):
        return synthetic.dlrm_planted_batch(cfg, truth, batch, device=dev, **kw)

    opt_cfg = opt_mod.OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                                total_steps=args.steps)
    step_fn = make_train_step(make_dlrm_loss(cfg), opt_cfg, microbatches=args.microbatches)
    return cfg, params, opt_state, step_fn, make_batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, help="dlrm-qr | dlrm-tt | dlrm-dense")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--embedding", default=None,
                    choices=[None, "dense", "hashed", "qr", "tt"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    cfg, params, opt_state, step_fn, make_batch = build(args, dev)
    pipe = synthetic.Pipeline(
        make_batch=lambda seed, step: make_batch(args.batch, seed=seed, step=step),
        seed=args.seed,
    )

    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt.restore(args.ckpt_dir, latest,
                                        {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            pipe.seek(extra["pipeline"])
            start = latest
            print(f"[resume] step {start} from {args.ckpt_dir}")

    stop = {"now": False}

    def _graceful(signum, frame):
        stop["now"] = True

    previous = {s: signal.signal(s, _graceful) for s in (signal.SIGTERM, signal.SIGINT)}

    def save(step):
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step, {"params": params, "opt": opt_state},
                      extra={"pipeline": pipe.state(), "arch": args.arch})
            ckpt.prune(args.ckpt_dir, keep=3)

    try:
        t_last = time.time()
        for step in range(start, args.steps):
            batch = next(pipe)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if (step + 1) % args.log_every == 0 or step == start:
                dt = time.time() - t_last
                t_last = time.time()
                print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} gnorm "
                      f"{float(metrics['grad_norm']):.3f} ({dt:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            if stop["now"]:
                print(f"[preempt] checkpointing at step {step + 1} and exiting")
                save(step + 1)
                return 0
        save(args.steps)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    print("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
