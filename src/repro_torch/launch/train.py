"""Training launcher: config -> params -> train loop, fault-tolerant (port
of ``repro.launch.train``).

``--arch dlrm-*`` trains the paper's model; an LM arch (the dense
transformers qwen2-1.5b, granite-34b, chatglm3-6b, minitron-4b, the MoE
granite-moe-3b-a800m, qwen3-moe-235b-a22b, the hybrid zamba2-7b,
xlstm-125m and the prefix models whisper-large-v3 and pixtral-12b) trains
the causal LM through the registry's ``init_fn``, ``train_loss_fn`` and
``make_batch_fn`` on ``--batch`` sequences of ``--seq`` tokens (whisper's
behind its frames, pixtral's behind its patches), each layer (each mamba
layer of zamba2; each encoder and decoder layer of whisper; xlstm has no
recompute, as ``repro``'s) recomputed in the backward as the config's
``remat`` says; ``--embedding`` picks either's vocabulary or tables.

* auto-resume from the newest atomic checkpoint (params, optimizer state and
  the data pipeline's cursor) under ``--ckpt-dir``;
* preemption safety: SIGTERM or SIGINT makes the loop checkpoint after the
  step in flight and exit 0;
* deterministic data: batch = f(seed, step), so a restart replays the same
  batches;
* a DLRM's embedding layer runs through ``EmbeddingEngine.inline_gnr`` (one
  packed kernel launch a step, differentiable), and its batches carry
  planted CTR structure so the loss is learnable; an LM's batches are
  uniform tokens, as ``repro``'s;
* ``--mesh-shape`` trains sharded, ``repro``'s axis names (two dims or fewer
  ``("data", "model")``, three ``("pod", "data", "model")``): the CLI process
  starts one process a rank (``launch.mesh.spawn``; nccl where every rank
  has a card, gloo where ranks share one or run on the CPU) and forwards
  SIGTERM / SIGINT to them.  Each rank places the params by their logical
  axes, takes its ``data`` block of the global batch and averages the
  gradients over ``data``.  A DLRM (``sharding.TRAIN_PARAM_RULES``: tables
  row-sharded over ``model``) runs the two-level GnR; an LM
  (``sharding.lm_param_rules``: whole heads, ``d_ff`` and the vocabulary
  split over ``model``; an MoE's experts too; zamba2's mamba layers by SSM
  head and xlstm's blocks by head or FFN unit, ``registry.lm_axes``;
  whisper's encoder and decoder layers, its cross-attention among them)
  runs tensor-parallel (its MoE layers expert-parallel), its tokens through
  the two-level GnR and its loss vocab-parallel, its params stored FSDP
  over ``data`` (each ``embed`` dim split, gathered at its use, its
  gradient reduce-scattered); whisper's frames and pixtral's patches split
  with the batch.  The ranks agree on the stop flag
  every step (a MAX all-reduce), so all of them checkpoint at the same
  step.  Checkpoints hold the full logical arrays, so a run resumes on
  another mesh shape, on one card, or in ``repro`` (the elastic restart).
  Only the rank at coordinates 0 prints.

Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-qr --smoke \\
        --steps 20 --batch 16 --device cpu --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
        --steps 20 --batch 8 --seq 128 --device cpu --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-qr --smoke \\
        --device cpu --mesh-shape 2,2 --steps 4 --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \\
        --device cpu --mesh-shape 2,2 --steps 4 --batch 8 --seq 32 --embedding qr \\
        --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m --smoke \\
        --device cpu --mesh-shape 1,2 --steps 2 --batch 4 --seq 32 --ckpt-dir <dir>
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-large-v3 --smoke \\
        --device cpu --mesh-shape 1,2 --steps 2 --batch 2 --seq 16 --embedding qr \\
        --ckpt-dir <dir>
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import signal
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.engine import EngineSpec, engine_for
from repro_torch.models import dlrm
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_dlrm_loss, make_train_step


def mesh_axes(shape: tuple[int, ...]) -> tuple[str, ...]:
    """``repro``'s axis names for a ``--mesh-shape``."""
    if len(shape) > 3:
        raise ValueError(f"--mesh-shape {shape}: at most three dims (pod, data, model)")
    return ("data", "model")[:len(shape)] if len(shape) <= 2 else ("pod", "data", "model")


def _opt_cfg(args) -> opt_mod.OptConfig:
    return opt_mod.OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 10 + 1),
                             total_steps=args.steps)


def place(params, axes, mesh, rules):
    """-> (this rank's blocks of ``params``, their specs, the specs of the
    whole state ``{"params", "opt"}``), laid out on ``mesh`` under
    ``rules``."""
    specs = SH.tree_specs(params, axes, mesh, rules)
    meta = tree.tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"), params)
    state_specs = SH.tree_specs({"params": meta, "opt": opt_mod.init(meta)},
                                {"params": axes, "opt": opt_mod.opt_axes(axes)}, mesh, rules)
    return SH.shard_tree(params, specs, mesh), specs, state_specs


def build_lm(args, dev, mesh=None):
    """-> (cfg, params, opt_state, step_fn, make_batch, state_specs) for an
    LM arch: the registry's bindings, batches of ``--seq`` tokens.  With
    ``mesh``, the params laid out by ``sharding.lm_param_rules`` (tensor
    parallel over ``model``, whole heads only; the sub-quadratic models'
    fused tensors by ``registry.lm_axes``; FSDP over ``data``)."""
    binding = registry.get(args.arch)
    cfg = binding.smoke if args.smoke else binding.config
    if args.embedding:
        cfg = cfg.replace(embedding_kind=args.embedding)
    params, axes = registry.init_fn(binding)(cfg, seed=args.seed, device=dev)
    specs = state_specs = None
    if mesh is not None:
        params, specs, state_specs = place(params, registry.lm_axes(cfg, axes, mesh), mesh,
                                           SH.lm_param_rules(cfg, mesh))
    make = registry.make_batch_fn(binding, cfg)

    def make_batch(batch, **kw):
        return make(batch, args.seq, device=dev, **kw)

    step_fn = make_train_step(registry.train_loss_fn(binding, cfg), _opt_cfg(args),
                              microbatches=args.microbatches, mesh=mesh, specs=specs)
    return cfg, params, opt_mod.init(params), step_fn, make_batch, state_specs


def build(args, dev, mesh=None):
    """-> (cfg, params, opt_state, step_fn, make_batch, state_specs).

    With ``mesh``: this rank's blocks of the params and the optimizer state,
    and ``state_specs``, one spec per leaf of ``{"params", "opt"}`` (the
    checkpoint's); without, the whole state and None."""
    if not args.arch.startswith("dlrm"):
        return build_lm(args, dev, mesh)
    cfg = registry.get_dlrm(f"{args.arch}-smoke" if args.smoke else args.arch)
    if args.embedding:
        cfg = dataclasses.replace(cfg, embedding_kind=args.embedding)
    params = dlrm.init_dlrm(cfg, seed=args.seed, device=dev)
    specs = state_specs = None
    if mesh is not None:
        params, specs, state_specs = place(params, dlrm.param_axes(cfg), mesh,
                                           SH.TRAIN_PARAM_RULES)
    opt_state = opt_mod.init(params)
    eng = engine_for(EngineSpec.from_bags(dlrm.make_bags(cfg)))
    if ckpt.is_writer(mesh):
        print(f"[engine] {cfg.name}: {eng.summary()}")
    truth = synthetic.dlrm_truth(cfg, device=dev)

    def make_batch(batch, **kw):
        return synthetic.dlrm_planted_batch(cfg, truth, batch, device=dev, **kw)

    step_fn = make_train_step(make_dlrm_loss(cfg), _opt_cfg(args),
                              microbatches=args.microbatches, mesh=mesh, specs=specs)
    return cfg, params, opt_state, step_fn, make_batch, state_specs


def run(args, dev, mesh=None, *, wants_stop=None) -> dict:
    """The train loop on the whole state (``mesh`` None) or on this rank's
    blocks.  ``wants_stop(step)`` may ask this rank to stop after ``step``
    as a signal would.  Returns ``{"rc", "step", "losses"}``."""
    writer = ckpt.is_writer(mesh)
    say = print if writer else (lambda *a, **k: None)
    cfg, params, opt_state, step_fn, make_batch, specs = build(args, dev, mesh)
    pipe = synthetic.Pipeline(
        make_batch=lambda seed, step: make_batch(args.batch, seed=seed, step=step),
        seed=args.seed, mesh=mesh)

    start = 0
    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            state, extra = ckpt.restore(args.ckpt_dir, latest,
                                        {"params": params, "opt": opt_state},
                                        mesh=mesh, specs=specs)
            params, opt_state = state["params"], state["opt"]
            pipe.seek(extra["pipeline"])
            start = latest
            say(f"[resume] step {start} from {args.ckpt_dir}")

    stop = {"now": False}

    def _graceful(signum, frame):
        stop["now"] = True

    previous = {s: signal.signal(s, _graceful) for s in (signal.SIGTERM, signal.SIGINT)}

    def save(step):
        if args.ckpt_dir:
            ckpt.save(args.ckpt_dir, step, {"params": params, "opt": opt_state},
                      extra={"pipeline": pipe.state(), "arch": args.arch}, mesh=mesh,
                      specs=specs)
            if writer:
                ckpt.prune(args.ckpt_dir, keep=3)

    losses = []
    try:
        t_last = time.time()
        for step in range(start, args.steps):
            batch = next(pipe)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0 or step == start:
                dt = time.time() - t_last
                t_last = time.time()
                say(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                    f"lr {float(metrics['lr']):.2e} gnorm "
                    f"{float(metrics['grad_norm']):.3f} ({dt:.2f}s)", flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1)
            now = stop["now"] or bool(wants_stop and wants_stop(step + 1))
            if mesh is not None:
                # every rank leaves at the same step, or the others would
                # wait in the next step's collectives
                now = collectives.any_rank(now, dev)
            if now:
                say(f"[preempt] checkpointing at step {step + 1} and exiting")
                save(step + 1)
                return {"rc": 0, "step": step + 1, "losses": losses}
        save(args.steps)
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
    say("done")
    return {"rc": 0, "step": args.steps, "losses": losses}


def _rank(mesh, args) -> dict:
    """One rank of a ``--mesh-shape`` run (``launch.mesh.spawn``)."""
    return run(args, mesh.device, mesh)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="dlrm-qr | dlrm-tt | dlrm-dense, or an LM arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--embedding", default=None,
                    choices=[None, "dense", "hashed", "qr", "tt"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128, help="tokens a sequence (LM archs)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,2 for (data, model); 2,1,2 for (pod, data, model)")
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="seconds a meshed run and each of its collectives may take")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    if not args.mesh_shape:
        return run(args, dev)["rc"]

    from repro_torch.launch import mesh as mesh_mod

    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    axes = mesh_axes(shape)
    world = math.prod(shape)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = "nccl" if dev.type == "cuda" and world <= cards else "gloo"
    if dev.type == "cuda":
        from repro_torch.kernels import build as kbuild

        # here, not in the ranks: K1 / K3 and K2 for a DLRM, K9 and K8 for an LM
        kbuild.build(["packed_gather", "tt_bag"] if args.arch.startswith("dlrm")
                     else ["flash_attention", "qr_gather"])
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        results = mesh_mod.spawn(_rank, shape, axes=axes, args=(args,), device=dev.type,
                                 backend=backend, init_file=Path(tmp) / "rdv",
                                 timeout_s=args.rank_timeout,
                                 forward_signals=(signal.SIGTERM, signal.SIGINT))
    steps = {r["step"] for r in results}
    if len(steps) != 1:
        raise RuntimeError(f"the ranks stopped at different steps: {sorted(steps)}")
    return max(r["rc"] for r in results)


if __name__ == "__main__":
    sys.exit(main())
