"""Rank bodies of the meshed MoE tests.  No jax and no tests: every rank of
``repro_torch.launch.mesh.spawn`` imports this module, not the test files
that spawn it.

``ep_rank`` runs the MoE transformers' meshed step (``lm_param_rules``
placement, the rank's ``data`` block, the loss under ``use_rules``) and one
MoE layer on the rank's block of a global input, at an ample capacity, and
returns what the single rank computes, gathered to the logical shapes.
``repro_layer_rank`` runs one MoE layer on ``repro``'s params and input (an
.npz written by a child running ``repro``) and returns the output and the
gradients of a sum-of-squares loss, gathered.
"""

from __future__ import annotations

import numpy as np
import torch

import torch_lm_mesh_ranks as R
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

# capacity factor of the EP checks: every expert holds every token
# (k x 8 >= the padded experts), so no rank drops and the mesh is held to
# the single rank, as tests/test_moe.py holds repro's mesh at 8.0
AMPLE = 8.0
# name -> (arch, overrides) on the smoke configs (498 tokens)
CASES = {
    "granite": ("granite-moe-3b-a800m", dict(embedding_kind="dense")),
    "qwen3-qr": ("qwen3-moe-235b-a22b", dict(embedding_kind="qr", qr_collision=4,
                                             embedding_exec="twolevel")),
    # 6 experts: split over a model axis of 2, whole (padded to 8) over 4
    "uneven": ("granite-moe-3b-a800m", dict(embedding_kind="dense", num_experts=6)),
}
LAYER_SHAPE = (4, 8)      # batch, sequence of the layer check's input


def config(name: str, **kw) -> ModelConfig:
    arch, over = CASES[name]
    return registry.get(arch).smoke.replace(vocab=R.VOCAB, compute_dtype="float32",
                                            capacity_factor=AMPLE, **{**over, **kw})


def layer_input(cfg, seed: int = 5) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((*LAYER_SHAPE, cfg.d_model))
                            .astype(np.float32))


def layer_params(cfg, seed: int = 0) -> tuple[dict, dict]:
    return moe.init_moe(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")


def single(name: str) -> dict:
    """The single rank's step-1 gradients, loss, norm and new params of
    ``name``, and its MoE layer on the whole ``layer_input``."""
    cfg = config(name)
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    out = R.single_step(cfg, params, R.tokens(cfg))
    lp, _ = layer_params(cfg)
    with torch.no_grad():
        out["layer"] = moe.apply_moe(lp, layer_input(cfg), cfg).numpy()
    return out


def _data_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    return SH.gather(x, SH.P("data"), mesh) if "data" in mesh.shape else x


def ep_rank(mesh, names) -> dict:
    """For each case: this rank's meshed step (gradients, loss, norm and new
    params gathered; the collectives of the gradient by site; the MoE
    leaves' specs) and its MoE layer on its ``data`` block of the layer
    input (gathered over ``data``)."""
    res = {}
    for name in names:
        cfg = config(name)
        params, axes = T.init_lm(cfg, seed=0, device="cpu")
        local, specs = R.place(params, axes, cfg, mesh)
        b = synthetic.data_block({"tokens": R.tokens(cfg)}, mesh)
        fn = R.loss_fn(cfg)

        collectives.reset_counts()
        loss, _m, grads = ts.meshed_grads(fn, local, b, mesh, specs)
        sites = {f"{s}/{a}": v[0] for (s, a), v in collectives.SITES.items()}
        step = ts.make_train_step(fn, opt.OptConfig(**R.OPT), mesh=mesh, specs=specs)
        new, _state, m = step(local, opt.init(local), b)
        paths = [p for p, _ in tree.leaves_with_paths(params)]
        lp, laxes = layer_params(cfg)
        # one layer on its own: the tensor-parallel layout, ``embed`` whole
        lspecs = SH.tree_specs(lp, laxes, mesh, SH.lm_param_rules(cfg, mesh, serve=True))
        xb = synthetic.data_block({"x": layer_input(cfg)}, mesh)["x"]
        with torch.no_grad():
            y = moe.apply_moe(SH.shard_tree(lp, lspecs, mesh), xb, cfg, mesh=mesh)
        res[name] = {"grads": R.gathered(grads, specs, mesh), "loss": float(loss),
                     "step_loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
                     "params": R.gathered(new, specs, mesh), "sites": sites,
                     "specs": {p: tuple(s) for p, s in zip(paths, specs) if "/moe/" in p},
                     "layer": _data_gather(y, mesh).numpy()}
    return res


def repro_layer_rank(mesh, path: str, cfg: ModelConfig) -> dict:
    """One MoE layer on ``repro``'s params and input (``path``'s .npz): the
    rank's blocks placed by ``lm_param_rules``, its ``data`` block of x;
    the output and the gradients of ``sum(out ** 2)`` over the whole batch
    in x, the router and the stacks, gathered (a stack's gradient and the
    router's summed over ``data``, x's gathered over it)."""
    arrs = np.load(path)
    _like, axes = layer_params(cfg)
    p = {k: torch.from_numpy(np.array(arrs[k])) for k in axes}
    # one layer on its own: the tensor-parallel layout, ``embed`` whole
    specs = SH.tree_specs(p, axes, mesh, SH.lm_param_rules(cfg, mesh, serve=True))
    local = SH.shard_tree(p, specs, mesh)
    live = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    xb = synthetic.data_block({"x": torch.from_numpy(np.array(arrs["x"]))}, mesh)["x"]
    xb.requires_grad_(True)
    out = moe.apply_moe(live, xb, cfg, mesh=mesh)
    (out ** 2).sum().backward()
    grads = {}
    for (k, spec) in zip(sorted(live), specs):
        g = collectives.psum(live[k].grad, mesh, "data")
        grads[k] = SH.gather(g, spec, mesh).numpy()
    return {"out": _data_gather(out.detach(), mesh).numpy(), "grads": grads,
            "x_grad": _data_gather(xb.grad, mesh).numpy(),
            "specs": {k: tuple(s) for k, s in zip(sorted(live), specs)}}


# ---------------------------------------------------------------------------
# the meshed step against repro's on a (2, 2) host mesh: both FSDP over data
# ---------------------------------------------------------------------------

STEP_CASE = "granite"


def write_step_inputs(path: str) -> None:
    """``STEP_CASE``'s params (the port's draw, seed 0) and tokens to an
    .npz, which ``repro``'s child and the ranks read."""
    cfg = config(STEP_CASE)
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    out = {f"param/{i}": leaf.numpy() for i, leaf in enumerate(tree.leaves(params))}
    out["tokens"] = R.tokens(cfg).numpy()
    np.savez(path, **out)


# repro's meshed loss and gradients (launch/train.py::build: params placed by
# PARAM_RULES, FSDP over data; the loss under use_rules; jax.grad, jitted) on
# a host mesh, from write_step_inputs's params and tokens
REPRO_STEP_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import transformer as T

arrs = np.load(__INPUTS__)
binding = registry.get(__ARCH__)
cfg = binding.smoke.replace(vocab=__VOCAB__, compute_dtype="float32",
                            capacity_factor=__AMPLE__, **__OVER__)
like, axes = T.init_lm(jax.random.PRNGKey(0), cfg)
leaves = [jnp.asarray(arrs[f"param/{i}"]) for i in range(len(jax.tree.leaves(like)))]
params = jax.tree.unflatten(jax.tree.structure(like), leaves)
mesh = make_mesh(__SHAPE__, ("data", "model"))
pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)
loss0 = registry.train_loss_fn(binding, cfg)


def loss(p, b):
    with SH.use_rules(mesh, SH.DEFAULT_RULES):
        return loss0(p, b)[0]


value, grads = jax.jit(jax.value_and_grad(loss))(jax.device_put(params, pshard),
                                                 {"tokens": jnp.asarray(arrs["tokens"])})
out = {"loss": np.asarray(value)}
for i, leaf in enumerate(jax.tree.leaves(grads)):
    out[f"grad/{i}"] = np.asarray(leaf)
np.savez(__PATH__, **out)
"""


def repro_step_child_code(inputs: str, path: str, shape) -> str:
    arch, over = CASES[STEP_CASE]
    subs = {"__INPUTS__": repr(str(inputs)), "__PATH__": repr(str(path)),
            "__ARCH__": repr(arch), "__OVER__": repr(over), "__VOCAB__": str(R.VOCAB),
            "__AMPLE__": repr(AMPLE), "__SHAPE__": repr(tuple(shape))}
    code = REPRO_STEP_CHILD
    for k, v in subs.items():
        code = code.replace(k, v)
    return code


def repro_step_rank(mesh, inputs: str) -> dict:
    """``STEP_CASE``'s step-1 loss and gradients on this rank from
    ``write_step_inputs``'s params and tokens, its blocks in the training
    layout (FSDP over ``data``), gathered; the specs of the leaves."""
    arrs = np.load(inputs)
    cfg = config(STEP_CASE)
    like, axes = T.init_lm(cfg, seed=0, device="meta")
    n = len(tree.leaves(like))
    params = tree.unflatten(like, [torch.from_numpy(np.array(arrs[f"param/{i}"]))
                                   for i in range(n)])
    local, specs = R.place(params, axes, cfg, mesh)
    b = synthetic.data_block({"tokens": torch.from_numpy(np.array(arrs["tokens"]))}, mesh)
    loss, _m, grads = ts.meshed_grads(R.loss_fn(cfg), local, b, mesh, specs)
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    return {"loss": float(loss), "grads": R.gathered(grads, specs, mesh),
            "specs": {p: tuple(s) for p, s in zip(paths, specs)}}
