"""Fault-tolerance drill (port of ``examples/elastic_restart.py``): train on
one mesh, "lose" ranks, resume on a smaller mesh from the atomic
checkpoint; the losses line up across the re-mesh.

qwen2-1.5b-smoke trains 6 steps on a (2, 4) mesh (``data`` x ``model``),
checkpoints, then resumes on (1, 4) for 6 more.  Checkpoints hold the full
logical arrays, the data pipeline's cursor is kept beside them, and batches
are functions of (seed, step), so the restarted run replays the batch
stream.  Each phase is one process a rank (``launch.mesh.spawn``: 8, then
4 gloo ranks, sharing the card or on the CPU); every rank restores the full
state and keeps its blocks (``elastic.reshard_tree`` under the LM's layout,
``sharding.lm_param_rules``).

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_restart [--device cpu]
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
from pathlib import Path

import torch

from repro_torch import device as device_mod
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry
from repro_torch.data.synthetic import Pipeline
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_train_step

ARCH = "qwen2-1.5b"
STEPS = 6                      # steps a phase
BATCH, SEQ = 8, 64
OPT = opt_mod.OptConfig(lr=1e-3, warmup_steps=2, total_steps=40)


def phase(mesh, directory: str) -> dict:
    """One rank of a phase: the state from the newest checkpoint under
    ``directory`` (or a fresh one), its blocks on ``mesh``, ``STEPS`` steps,
    a checkpoint.  Returns the losses and the step it started from."""
    binding = registry.get(ARCH)
    cfg = binding.smoke
    params, axes = registry.init_fn(binding)(cfg, seed=0, device=mesh.device)
    state = {"params": params, "opt": opt_mod.init(params)}
    extra = {"pipeline": {"seed": 0, "step": 0}}
    latest = ckpt.latest_step(directory)
    if latest is not None:
        state, extra = ckpt.restore(directory, latest, state)
    rules = SH.lm_param_rules(cfg, mesh)
    placed = {"params": elastic.reshard_tree(state["params"], axes, mesh, rules),
              "opt": {"mu": elastic.reshard_tree(state["opt"]["mu"], axes, mesh, rules),
                      "nu": elastic.reshard_tree(state["opt"]["nu"], axes, mesh, rules),
                      "step": state["opt"]["step"]}}
    del state
    make = registry.make_batch_fn(binding, cfg)
    pipe = Pipeline(make_batch=lambda seed, step: make(BATCH, SEQ, seed=seed, step=step,
                                                       device=mesh.device), mesh=mesh)
    pipe.seek(extra["pipeline"])
    start = pipe.step
    specs = SH.tree_specs(params, axes, mesh, rules)
    step = make_train_step(registry.train_loss_fn(binding, cfg), OPT, mesh=mesh, specs=specs)
    p, o = placed["params"], placed["opt"]
    losses = []
    for _ in range(STEPS):
        p, o, m = step(p, o, next(pipe))
        losses.append(float(m["loss"]))
    meta = tree.tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params)
    state_specs = SH.tree_specs({"params": meta, "opt": opt_mod.init(meta)},
                                {"params": axes, "opt": opt_mod.opt_axes(axes)}, mesh, rules)
    ckpt.save(directory, pipe.step, {"params": p, "opt": o}, extra={"pipeline": pipe.state()},
              mesh=mesh, specs=state_specs)
    return {"start": start, "losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, removed after)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.build(["flash_attention", "qr_gather"])       # here, not in the ranks
    own = args.ckpt_dir is None
    directory = tempfile.mkdtemp(prefix="repro_torch_elastic_") if own else args.ckpt_dir
    shutil.rmtree(directory, ignore_errors=True)
    out = {}
    try:
        for name, shape, say in (("healthy", (2, 4), "mesh (data=2, model=4)"),
                                 ("degraded", (1, 4), "degraded mesh (data=1, model=4)")):
            with tempfile.TemporaryDirectory(prefix="repro_torch_rdv_") as rdv:
                ranks = mesh_mod.spawn(phase, shape, args=(directory,), device=dev.type,
                                       backend="gloo", init_file=Path(rdv) / "rdv",
                                       timeout_s=900)
            rec = ranks[0]
            where = "" if rec["start"] == 0 else f"resumed step {rec['start']} on "
            print(f"phase {len(out) + 1}: {where}{say}")
            print(f"  step {rec['start'] + STEPS}: loss {rec['losses'][-1]:.4f}")
            if not out:
                print(f"  checkpointed at step {rec['start'] + STEPS}; simulating loss of "
                      f"4 ranks")
            out[name] = rec
        print("elastic restart complete: same model, new mesh, replayed data stream")
    finally:
        if own:
            shutil.rmtree(directory, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
