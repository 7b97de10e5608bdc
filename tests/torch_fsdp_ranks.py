"""Rank bodies of the FSDP tests (``tests/test_torch_fsdp.py``).  No jax and
no tests: every rank of ``repro_torch.launch.mesh.spawn`` imports this
module, not the test file that spawns it.

Each body runs qwen2-1.5b-smoke (fp32 compute, QR ``twolevel`` at collision
4, the vocabulary cut to 498 tokens: ``torch_lm_mesh_ranks.CASES``) on one
rank of a gloo mesh on the CPU, its params placed by the training layout
(``launch.train.place`` under ``sharding.lm_param_rules``: FSDP over
``data``), and returns the full logical leaves gathered as numpy.
"""

from __future__ import annotations

import numpy as np

import torch_lm_mesh_ranks as R
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data import synthetic
from repro_torch.distributed import sharding as SH
from repro_torch.launch.train import place
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

NAME = "qr-twolevel"
STEPS = 4


def config():
    return R.config(NAME)


def batch(cfg, step: int, mesh=None) -> dict:
    """Step ``step``'s global batch (a numpy draw), the rank's ``data``
    block of it on ``mesh``."""
    b = {"tokens": R.tokens(cfg, seed=10 + step)}
    return b if mesh is None else synthetic.data_block(b, mesh)


def two_steps(mesh) -> dict:
    """The step-1 gradients (averaged over ``data``), then two steps of
    ``make_train_step(mesh=)``: the gradients and new params gathered, the
    losses, and the local and logical shapes of each param and moment."""
    cfg = config()
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    local, specs, _ = place(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
    fn = R.loss_fn(cfg)
    loss, _m, grads = ts.meshed_grads(fn, local, batch(cfg, 0, mesh), mesh, specs)
    step = ts.make_train_step(fn, opt.OptConfig(**R.OPT), mesh=mesh, specs=specs)
    state = opt.init(local)
    losses = []
    for s in range(2):
        local, state, m = step(local, state, batch(cfg, s, mesh))
        losses.append(float(m["loss"]))
    return {"grads": R.gathered(grads, specs, mesh), "loss": float(loss), "losses": losses,
            "params": R.gathered(local, specs, mesh),
            "local": [tuple(x.shape) for x in tree.leaves(local)],
            "moments": [tuple(x.shape) for x in tree.leaves(state["mu"])],
            "full": [tuple(x.shape) for x in tree.leaves(params)],
            "specs": [tuple(s) for s in specs]}


def single_two_steps() -> dict:
    """``two_steps`` on the whole state, no mesh."""
    cfg = config()
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    fn = R.loss_fn(cfg)
    loss, _m, grads = ts.value_and_grad(fn, params, batch(cfg, 0))
    step = ts.make_train_step(fn, opt.OptConfig(**R.OPT))
    state = opt.init(params)
    losses = []
    for s in range(2):
        params, state, m = step(params, state, batch(cfg, s))
        losses.append(float(m["loss"]))
    return {"grads": [R._np(g) for g in tree.leaves(grads)], "loss": float(loss),
            "losses": losses, "params": [R._np(p) for p in tree.leaves(params)]}


def run_until(mesh, directory: str, stop: int, save: bool = False) -> dict:
    """Steps up to ``stop`` on ``mesh`` (None: the whole state on this
    process), from the newest checkpoint under ``directory`` where there is
    one (the full logical arrays, each rank taking its blocks), else from
    the draw; with ``save`` a checkpoint at ``stop``.  Returns the first
    step run, the losses and the params gathered."""
    cfg = config()
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    specs = state_specs = None
    if mesh is not None:
        params, specs, state_specs = place(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
    state = {"params": params, "opt": opt.init(params)}
    start = ckpt.latest_step(directory) or 0
    if start:
        state, _extra = ckpt.restore(directory, start, state, mesh=mesh, specs=state_specs)
    step = ts.make_train_step(R.loss_fn(cfg), opt.OptConfig(**R.OPT), mesh=mesh, specs=specs)
    losses = []
    for s in range(start, stop):
        p, o, m = step(state["params"], state["opt"], batch(cfg, s, mesh))
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    if save:
        ckpt.save(directory, stop, state, extra={"pipeline": {"seed": 0, "step": stop}},
                  mesh=mesh, specs=state_specs)
    got = (R.gathered(state["params"], specs, mesh) if mesh is not None
           else [R._np(x) for x in tree.leaves(state["params"])])
    return {"start": start, "losses": losses, "params": got,
            "opt_step": int(state["opt"]["step"])}


def local_blocks_hold(mesh) -> bool:
    """Whether this rank's blocks, gathered back, are the logical leaves
    bitwise (the FSDP layout's ``local_shard`` / ``gather`` pair)."""
    cfg = config()
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    local, specs, _ = place(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
    return all(np.array_equal(R._np(SH.gather(x, s, mesh)), R._np(w))
               for x, s, w in zip(tree.leaves(local), specs, tree.leaves(params)))
