"""Rank bodies of the meshed-training tests, and ``repro``'s side of their
parity cases as a script for a child process.  No jax and no tests: every
rank of ``repro_torch.launch.mesh.spawn`` imports this module, not the test
files that spawn it.

Each body runs on one rank of a gloo mesh on the CPU: it places the params
by their logical axes, takes its ``data`` block of the global batch, runs
the port's meshed step, and returns the full logical leaves (gathered from
the ranks' blocks) as numpy, rank 0's only where every rank would return
the same.
"""

from __future__ import annotations

import numpy as np
import torch
from torch_one_thread import one_thread  # noqa: F401

from repro_torch import convert, tree
from repro_torch import engine as E
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives, elastic
from repro_torch.distributed import sharding as SH
from repro_torch.engine import EngineSpec
from repro_torch.launch import mesh as M
from repro_torch.launch import train as train_cli
from repro_torch.models import dlrm
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ARCHS = ("dlrm-qr-smoke", "dlrm-tt-smoke", "dlrm-dense-smoke")
OPT = dict(lr=3e-3, warmup_steps=1, total_steps=3)
REPRO_STEPS = 3
SPAWN_S = 240

# repro's meshed step (launch/train.py::build), its params, batches and
# results written to an .npz for the port
REPRO_CHILD = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import checkpointer as ckpt
from repro.configs import registry
from repro.data import synthetic
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import dlrm
from repro.train import optimizer as opt
from repro.train.train_step import make_dlrm_loss, make_train_step

ARCH, PATH, MODE, CKPT = __ARCH__, __PATH__, __MODE__, __CKPT__
OPT = opt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=3)


def meshed(cfg, params, shape):
    mesh = make_mesh(shape, ("data", "model"))
    _, axes = dlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
    pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)
    loss0 = make_dlrm_loss(cfg)

    def loss_fn(p, b):
        with SH.use_rules(mesh, SH.DEFAULT_RULES):
            return loss0(p, b)

    return mesh, pshard, loss_fn


def place(state, pshard):
    return {"params": jax.device_put(state["params"], pshard),
            "opt": {"mu": jax.device_put(state["opt"]["mu"], pshard),
                    "nu": jax.device_put(state["opt"]["nu"], pshard),
                    "step": state["opt"]["step"]}}


cfg = registry.get_dlrm(ARCH)
params, _ = dlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
truth = synthetic.dlrm_truth(cfg)
batches = [synthetic.dlrm_planted_batch(cfg, truth, 16, seed=0, step=s) for s in range(STEPS)]
out = {}
for s, b in enumerate(batches):
    for k, v in b.items():
        out[f"batch{s}/{k}"] = np.asarray(v)
for part in ("bottom", "top", "tables"):
    for i, leaf in enumerate(params[part]):
        for k, v in leaf.items():
            out[f"{part}/{i}/{k}"] = np.asarray(v)

if MODE == "steps":
    mesh, pshard, loss_fn = meshed(cfg, params, (2, 2))
    state = place({"params": params, "opt": opt.init(params)}, pshard)
    step = jax.jit(make_train_step(loss_fn, OPT))
    p, o = state["params"], state["opt"]
    for s, b in enumerate(batches):
        p, o, m = step(p, o, b)
        out[f"loss{s}"] = np.asarray(m["loss"])
        out[f"gnorm{s}"] = np.asarray(m["grad_norm"])
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    mesh, pshard, loss32 = meshed(cfg32, params, (2, 2))
    g = jax.jit(jax.grad(lambda q, b: loss32(q, b)[0]))(jax.device_put(params, pshard),
                                                         batches[0])
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"grad32/{i}"] = np.asarray(leaf)
elif MODE == "write":
    # two meshed steps on (2, 2), a checkpoint of the full arrays, the next loss
    mesh, pshard, loss_fn = meshed(cfg, params, (2, 2))
    state = place({"params": params, "opt": opt.init(params)}, pshard)
    step = jax.jit(make_train_step(loss_fn, OPT))
    p, o = state["params"], state["opt"]
    for b in batches[:2]:
        p, o, m = step(p, o, b)
    ckpt.save(CKPT, 2, {"params": p, "opt": o}, extra={"pipeline": {"seed": 0, "step": 2}})
    _, _, m = step(p, o, batches[2])
    out["next_loss"] = np.asarray(m["loss"])
else:
    # restore the port's checkpoint on (4, 1) and take the next step
    mesh, pshard, loss_fn = meshed(cfg, params, (4, 1))
    like = {"params": params, "opt": opt.init(params)}
    state, extra = ckpt.restore(CKPT, ckpt.latest_step(CKPT), like)
    state = place(state, pshard)
    out["q_shape"] = np.asarray(state["opt"]["mu"]["tables"][0][
        "q" if "q" in params["tables"][0] else next(iter(params["tables"][0]))].shape)
    step = jax.jit(make_train_step(loss_fn, OPT))
    _, o, m = step(state["params"], state["opt"], batches[2])
    out["next_loss"] = np.asarray(m["loss"])
    out["next_step"] = np.asarray(o["step"])
np.savez(PATH, **out)
""".replace("STEPS", str(REPRO_STEPS))




def repro_child(mesh_runner, tmp_path, arch: str, mode: str, ckpt_dir="") -> dict:
    """``REPRO_CHILD`` in a child with four host devices (the tests'
    ``mesh_runner``): ``mode`` "steps", "write" or "read"; its .npz."""
    path = str(tmp_path / f"{mode}.npz")
    code = (REPRO_CHILD.replace("__ARCH__", repr(arch)).replace("__PATH__", repr(path))
            .replace("__MODE__", repr(mode)).replace("__CKPT__", repr(str(ckpt_dir))))
    mesh_runner(code, n_devices=4, timeout=300)
    return np.load(path)


def spawn_cpu(tmp_path, fn, shape, *args) -> list:
    """``fn`` on gloo ranks of a ``("data", "model")`` mesh on the CPU."""
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


def config(arch: str, compute: str | None = None):
    cfg = registry.get_dlrm(arch)
    return cfg if compute is None else cfg.replace(compute_dtype=compute)


def global_batch(cfg, batch: int, step: int) -> dict:
    return synthetic.dlrm_planted_batch(cfg, synthetic.dlrm_truth(cfg), batch, seed=0,
                                        step=step)


def _np_leaves(t) -> list:
    return [x.detach().float().cpu().numpy() for x in tree.leaves(t)]


def _gathered(local, specs, mesh) -> list:
    return [SH.gather(x, s, mesh).detach().float().cpu().numpy()
            for x, s in zip(tree.leaves(local), specs)]


def place(params, cfg, mesh):
    specs = SH.tree_specs(params, dlrm.param_axes(cfg), mesh, SH.TRAIN_PARAM_RULES)
    return SH.shard_tree(params, specs, mesh), specs


def single_step(cfg, params, batch: dict, microbatches: int = 1) -> dict:
    """The single-rank reference: step-1 gradients, then one step."""
    loss_fn = ts.make_dlrm_loss(cfg)
    _l, _m, grads = ts.value_and_grad(loss_fn, params, batch)
    step = ts.make_train_step(loss_fn, opt.OptConfig(**OPT), microbatches=microbatches)
    new, _state, m = step(params, opt.init(params), batch)
    return {"grads": _np_leaves(grads), "loss": float(m["loss"]),
            "gnorm": float(m["grad_norm"]), "params": _np_leaves(new)}


def meshed_step(mesh, arch: str, compute: str | None, batch: int,
                microbatches: int = 1) -> dict:
    """One meshed step of ``arch`` from ``init_dlrm(seed=0)`` on the global
    batch (seed 0, step 0): the data-averaged gradients, the loss, the norm
    and the new params, all gathered to their logical shapes, and the
    collectives a step by site."""
    cfg = config(arch, compute)
    params = dlrm.init_dlrm(cfg, seed=0, device="cpu")
    local, specs = place(params, cfg, mesh)
    b = synthetic.data_block(global_batch(cfg, batch, 0), mesh)
    loss_fn = ts.make_dlrm_loss(cfg)
    loss, _m, grads = ts.meshed_grads(loss_fn, local, b, mesh, specs)
    step = ts.make_train_step(loss_fn, opt.OptConfig(**OPT), microbatches=microbatches,
                              mesh=mesh, specs=specs)
    collectives.reset_counts()
    new, _state, m = step(local, opt.init(local), b)
    sites = {f"{s}/{a}": v[0] for (s, a), v in collectives.SITES.items()}
    return {"grads": _gathered(grads, specs, mesh), "loss": float(m["loss"]),
            "gnorm": float(m["grad_norm"]), "params": _gathered(new, specs, mesh),
            "sites": sites}


def meshed_steps(mesh, cases) -> dict:
    """``meshed_step`` for each (arch, compute, batch, microbatches)."""
    return {i: meshed_step(mesh, *case) for i, case in enumerate(cases)}


def pertable_grads(mesh, arch: str) -> dict:
    """``forward_partial`` under grad on the per-table plan and on the
    packed plan (fp32 compute), this rank's row shards and batch block: the
    pooled output and the tables' gradients of a fixed cotangent, gathered,
    with the collectives of each."""
    cfg = config(arch, "float32")
    bags = dlrm.make_bags(cfg)
    params = dlrm.init_dlrm(cfg, seed=0, device="cpu")
    idx = synthetic.data_block({"idx": global_batch(cfg, 16, 0)["idx"]}, mesh)["idx"]
    specs = SH.tree_specs(params["tables"], dlrm.param_axes(cfg)["tables"], mesh,
                          SH.TRAIN_PARAM_RULES)
    local = SH.shard_tree(params["tables"], specs, mesh)
    g = torch.Generator().manual_seed(5)
    ct = torch.randn((16, cfg.num_tables, cfg.dim), generator=g)
    ct = synthetic.data_block({"ct": ct}, mesh)["ct"]
    out = {}
    for packing in ("auto", "off"):
        eng = E.compile(E.plan(EngineSpec.from_bags(bags, packing=packing), mesh=mesh))
        leaves = [x.detach().requires_grad_(True) for x in tree.leaves(local)]
        live = tree.unflatten(local, leaves)
        collectives.reset_counts()
        pooled = eng.forward_partial(live, idx, mesh=mesh)
        grads = torch.autograd.grad(pooled, leaves, ct)
        grads, _ = ts.data_mean(tree.unflatten(local, list(grads)), torch.zeros(()), mesh,
                                specs)
        sites = {f"{s}/{a}": v[0] for (s, a), v in collectives.SITES.items()}
        out[packing] = {"pooled": pooled.detach().numpy(),
                        "grads": _gathered(grads, specs, mesh), "sites": sites}
    return out


def repro_steps(mesh, path: str, arch: str, steps: int) -> dict:
    """``steps`` meshed steps from ``repro``'s params and batches (an
    ``.npz`` its child wrote): losses and norms; step-1 gradients in fp32
    compute, gathered."""
    arrs = np.load(path)
    params = _params_from(arrs)
    res = {}
    for compute in (None, "float32"):
        cfg = config(arch, compute)
        local, specs = place(params, cfg, mesh)
        loss_fn = ts.make_dlrm_loss(cfg)
        batches = [synthetic.data_block(_batch_from(arrs, s), mesh) for s in range(steps)]
        if compute == "float32":
            _loss, _m, grads = ts.meshed_grads(loss_fn, local, batches[0], mesh, specs)
            res["grads32"] = _gathered(grads, specs, mesh)
            continue
        step = ts.make_train_step(loss_fn, opt.OptConfig(**OPT), mesh=mesh, specs=specs)
        state = opt.init(local)
        losses, norms = [], []
        for b in batches:
            local, state, m = step(local, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        res["losses"], res["norms"] = losses, norms
    return res


def _params_from(arrs) -> dict:
    tree_: dict = {"bottom": {}, "top": {}, "tables": {}}
    for name in arrs.files:
        part, _, rest = name.partition("/")
        if part in tree_:
            i, _, k = rest.partition("/")
            tree_[part].setdefault(int(i), {})[k] = arrs[name]
    return convert.params_from_numpy(
        {p: [tree_[p][i] for i in sorted(tree_[p])] for p in tree_}, "cpu")


def _batch_from(arrs, step: int) -> dict:
    return {k: torch.from_numpy(np.array(arrs[f"batch{step}/{k}"]))
            for k in ("dense", "idx", "labels")}


def cli_run(mesh, argv: list, stop_rank: int | None = None, stop_at: int | None = None):
    """The launcher's rank loop (``train.run``) on this rank, as
    ``--mesh-shape`` runs it; rank ``stop_rank`` asks to stop after step
    ``stop_at`` (as a signal to that rank alone would)."""
    args = train_cli.parser().parse_args(argv)
    me = int(np.ravel_multi_index(list(mesh.coords.values()), list(mesh.shape.values())))
    wants = None if stop_rank is None else (lambda s: me == stop_rank and s >= stop_at)
    return train_cli.run(args, mesh.device, mesh, wants_stop=wants)


def reshard_round_trip(mesh) -> dict:
    """``repro``'s ``test_elastic_reshard_roundtrip`` on this rank: a tree
    placed on the (2, 2) mesh under ``PARAM_RULES``, gathered, placed again
    on a (4, 1) mesh of the same ranks and gathered again."""
    full = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(8)}
    axes = {"w": ("ffn", "embed"), "b": ("ffn",)}
    placed = elastic.reshard_tree(full, axes, mesh, SH.PARAM_RULES)
    specs1 = SH.tree_specs(full, axes, mesh, SH.PARAM_RULES)
    back = tree.unflatten(full, [SH.gather(x, s, mesh)
                                 for x, s in zip(tree.leaves(placed), specs1)])
    m2 = M.make_mesh((4, 1), ("data", "model"), device="cpu")
    moved = elastic.reshard_tree(back, axes, m2, SH.PARAM_RULES)
    specs2 = SH.tree_specs(full, axes, m2, SH.PARAM_RULES)
    again = [SH.gather(x, s, m2).numpy() for x, s in zip(tree.leaves(moved), specs2)]
    return {"specs1": [tuple(s) for s in specs1], "specs2": [tuple(s) for s in specs2],
            "blocks1": [tuple(x.shape) for x in tree.leaves(placed)],
            "blocks2": [tuple(x.shape) for x in tree.leaves(moved)],
            "again": again, "full": _np_leaves(full)}


def restore_and_step(mesh, directory: str, path: str, arch: str,
                     train_steps: int | None) -> dict:
    """With ``train_steps``: that many meshed steps from ``repro``'s params
    on its batches (``path``), saved to ``directory`` (the full logical
    arrays); without: this rank's blocks restored from the newest
    checkpoint there.  Then the next step on batch 2: its loss."""
    from repro_torch.checkpoint import checkpointer as ckpt

    arrs = np.load(path)
    cfg = config(arch)
    params = _params_from(arrs)
    local, specs = place(params, cfg, mesh)
    state = {"params": local, "opt": opt.init(local)}
    axes = dlrm.param_axes(cfg)
    state_specs = SH.tree_specs({"params": params, "opt": opt.init(params)},
                                {"params": axes, "opt": opt.opt_axes(axes)}, mesh,
                                SH.TRAIN_PARAM_RULES)
    step = ts.make_train_step(ts.make_dlrm_loss(cfg), opt.OptConfig(**OPT), mesh=mesh,
                              specs=specs)
    res = {}
    if train_steps is None:
        res["restored_step"] = ckpt.latest_step(directory)
        state, _extra = ckpt.restore(directory, res["restored_step"], state, mesh=mesh,
                                     specs=state_specs)
    else:
        for s in range(train_steps):
            p, o, _m = step(state["params"], state["opt"],
                            synthetic.data_block(_batch_from(arrs, s), mesh))
            state = {"params": p, "opt": o}
        ckpt.save(directory, train_steps, state, extra={"pipeline": {"seed": 0,
                                                                      "step": train_steps}},
                  mesh=mesh, specs=state_specs)
    _p, o, m = step(state["params"], state["opt"], synthetic.data_block(_batch_from(arrs, 2),
                                                                         mesh))
    res["next_loss"], res["opt_step"] = float(m["loss"]), int(o["step"])
    return res


def world1_step(mesh, arch: str, batch: int) -> dict:
    """One meshed step on this rank's device (world 1: the whole state):
    the step-1 gradients, the loss and the norm, and the packed launches."""
    from repro_torch.kernels import packed_gather as pg
    from repro_torch.kernels import tt_gather as tg

    dev = mesh.device
    cfg = config(arch)
    params = dlrm.init_dlrm(cfg, seed=0, device=dev)
    local, specs = place(params, cfg, mesh)
    b = {k: v.to(dev) for k, v in global_batch(cfg, batch, 0).items()}
    loss_fn = ts.make_dlrm_loss(cfg)
    before = sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values())
    _loss, _m, grads = ts.meshed_grads(loss_fn, local, b, mesh, specs)
    step = ts.make_train_step(loss_fn, opt.OptConfig(**OPT), mesh=mesh, specs=specs)
    _p, _s, m = step(local, opt.init(local), b)
    return {"grads": _gathered(grads, specs, mesh), "loss": float(m["loss"]),
            "gnorm": float(m["grad_norm"]),
            "launches": sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values()) - before}
