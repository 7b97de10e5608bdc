"""Rank bodies of the meshed-LM tests.  No jax and no tests: every rank of
``repro_torch.launch.mesh.spawn`` imports this module, not the test files
that spawn it.

Each body runs on one rank of a gloo mesh on the CPU: it places the LM's
params by ``sharding.lm_param_rules``, takes its ``data`` block of the global
tokens, runs the port's meshed step, and returns the full logical leaves
(gathered from the ranks' blocks) as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)
BATCH, SEQ = 4, 16
# the smoke configs' vocabulary cut to 498 tokens: neither the padded dense
# table (512 rows) nor the last Q row (collision 4: 125 rows, 2 tokens in
# the last) is full, so the padding columns are on the path
VOCAB = 498
# name -> (arch, overrides): the vocabularies, an untied head, and a block
# whose heads (6) and d_ff (250) divide no model axis of 4 (replicated)
CASES = {
    "dense": ("qwen2-1.5b", dict(embedding_kind="dense")),
    "qr-twolevel": ("qwen2-1.5b", dict(embedding_kind="qr", qr_collision=4,
                                       embedding_exec="twolevel")),
    "qr-gspmd": ("qwen2-1.5b", dict(embedding_kind="qr", qr_collision=64)),
    "untied-qr": ("chatglm3-6b", dict(embedding_kind="qr", qr_collision=4)),
    "mqa-dense": ("granite-34b", dict(embedding_kind="dense")),
    "replicated-blocks": ("qwen2-1.5b", dict(embedding_kind="qr", qr_collision=4, num_heads=6,
                                             kv_heads=6, d_ff=250)),
}


def config(name: str, compute: str = "float32", **kw):
    arch, over = CASES[name]
    return registry.get(arch).smoke.replace(vocab=VOCAB, compute_dtype=compute,
                                            **{**over, **kw})


def tokens(cfg, batch: int = BATCH, seq: int = SEQ, seed: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def gathered(local, specs, mesh) -> list:
    return [_np(SH.gather(x, s, mesh)) for x, s in zip(tree.leaves(local), specs)]


def loss_fn(cfg):
    return registry.train_loss_fn(registry.get(cfg.name.removesuffix("-smoke")), cfg)


def single_step(cfg, params, toks: torch.Tensor, microbatches: int = 1) -> dict:
    """The single-rank reference: the batch's gradients, then one step."""
    fn = loss_fn(cfg)
    loss, _m, grads = ts.value_and_grad(fn, params, {"tokens": toks})
    step = ts.make_train_step(fn, opt.OptConfig(**OPT), microbatches=microbatches)
    new, _state, m = step(params, opt.init(params), {"tokens": toks})
    return {"grads": [_np(g) for g in tree.leaves(grads)], "loss": float(loss),
            "step_loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": [_np(p) for p in tree.leaves(new)]}


def place(params, axes, cfg, mesh):
    specs = SH.tree_specs(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
    return SH.shard_tree(params, specs, mesh), specs


def meshed_step(mesh, name: str, microbatches: int = 1, params_np=None, toks=None,
                compute: str = "float32") -> dict:
    """The batch's data-averaged gradients, the loss, then one step of
    ``make_train_step(mesh=)``: the norm and the new params, all gathered
    to their logical shapes; the collectives of the step by site, and the
    embedding's output (this rank's batch block) in fp32."""
    cfg = config(name, compute)
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    if params_np is not None:
        params = tree.unflatten(params, [torch.from_numpy(np.array(a)) for a in params_np])
    local, specs = place(params, axes, cfg, mesh)
    toks = tokens(cfg) if toks is None else toks
    b = synthetic.data_block({"tokens": toks}, mesh)
    fn = loss_fn(cfg)

    loss, _m, grads = ts.meshed_grads(fn, local, b, mesh, specs)
    with torch.no_grad(), SH.use_rules(mesh, SH.DEFAULT_RULES), SH.use_fsdp(mesh, local, specs):
        embedded = T.embed_tokens(local, b["tokens"], cfg)
    step = ts.make_train_step(fn, opt.OptConfig(**OPT), microbatches=microbatches, mesh=mesh,
                              specs=specs)
    collectives.reset_counts()
    new, _state, m = step(local, opt.init(local), b)
    sites = {f"{s}/{a}": v[0] for (s, a), v in collectives.SITES.items()}
    return {"grads": gathered(grads, specs, mesh), "loss": float(loss),
            "step_loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": gathered(new, specs, mesh), "sites": sites,
            "embedded": embedded.detach().clone(), "coords": dict(mesh.coords),
            "specs": [tuple(s) for s in specs]}


def meshed_steps(mesh, cases) -> dict:
    """``meshed_step`` for each (name, microbatches)."""
    return {i: meshed_step(mesh, *case) for i, case in enumerate(cases)}


def vocab_loss(mesh, logits: torch.Tensor, toks: torch.Tensor, lo: int, hi: int) -> dict:
    """The vocab-parallel loss on this rank's slice ``[lo, hi)`` of the full
    ``logits`` and its gradient there; the collectives it issued."""
    part = logits[..., lo:hi].clone().requires_grad_(True)
    collectives.reset_counts()
    loss = ts.next_token_loss(part, toks, vocab_start=lo, mesh=mesh)
    sites = {f"{s}/{a}": v[0] for (s, a), v in collectives.SITES.items()}
    (grad,) = torch.autograd.grad(loss, part)
    return {"loss": float(loss), "grad": grad.numpy(), "sites": sites}


# ---------------------------------------------------------------------------
# repro's side, in a child with four host devices (the tests' mesh_runner)
# ---------------------------------------------------------------------------

REPRO_STEPS = 3
# repro's meshed LM step (launch/train.py::build: PARAM_RULES placement, the
# loss under use_rules, jit) on a host mesh, fp32 compute; its params, tokens
# and results written to an .npz for the port
REPRO_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint import checkpointer as ckpt
from repro.configs import registry
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.models import transformer as T
from repro.train import optimizer as opt
from repro.train.train_step import make_train_step

SHAPE, PATH, MODE, CKPT, OVER = __SHAPE__, __PATH__, __MODE__, __CKPT__, __OVER__
binding = registry.get("qwen2-1.5b")
cfg = binding.smoke.replace(vocab=__VOCAB__, compute_dtype="float32", **OVER)
OPT = opt.OptConfig(**__OPT__)
params, axes = T.init_lm(jax.random.PRNGKey(0), cfg)
rng = np.random.default_rng(1)
batches = [{"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (__BATCH__, __SEQ__))
                                  .astype(np.int32))} for _ in range(__STEPS__)]
loss0 = registry.train_loss_fn(binding, cfg)


def meshed(shape):
    mesh = make_mesh(shape, ("data", "model"))
    pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)

    def loss_fn(p, b):
        with SH.use_rules(mesh, SH.DEFAULT_RULES):
            return loss0(p, b)

    return pshard, loss_fn


def place(state, pshard):
    return {"params": jax.device_put(state["params"], pshard),
            "opt": {"mu": jax.device_put(state["opt"]["mu"], pshard),
                    "nu": jax.device_put(state["opt"]["nu"], pshard),
                    "step": state["opt"]["step"]}}


out = {f"tokens{s}": np.asarray(b["tokens"]) for s, b in enumerate(batches)}
for i, leaf in enumerate(jax.tree.leaves(params)):
    out[f"param/{i}"] = np.asarray(leaf)
pshard, loss_fn = meshed(SHAPE)
step = jax.jit(make_train_step(loss_fn, OPT))
if MODE == "steps":
    state = place({"params": params, "opt": opt.init(params)}, pshard)
    p, o = state["params"], state["opt"]
    for s, b in enumerate(batches):
        p, o, m = step(p, o, b)
        out[f"loss{s}"] = np.asarray(m["loss"])
        out[f"gnorm{s}"] = np.asarray(m["grad_norm"])
    g = jax.jit(jax.grad(lambda q, b: loss_fn(q, b)[0]))(jax.device_put(params, pshard),
                                                         batches[0])
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"grad/{i}"] = np.asarray(leaf)
elif MODE == "write":
    # two meshed steps, a checkpoint of the full arrays, the next loss
    state = place({"params": params, "opt": opt.init(params)}, pshard)
    p, o = state["params"], state["opt"]
    for b in batches[:2]:
        p, o, m = step(p, o, b)
    ckpt.save(CKPT, 2, {"params": p, "opt": o}, extra={"pipeline": {"seed": 0, "step": 2}})
    _, _, m = step(p, o, batches[2])
    out["next_loss"] = np.asarray(m["loss"])
else:
    # the port's checkpoint restored and the next step
    like = {"params": params, "opt": opt.init(params)}
    state, extra = ckpt.restore(CKPT, ckpt.latest_step(CKPT), like)
    out["q_shape"] = np.asarray(state["opt"]["mu"]["embed"]["q"].shape)
    state = place(state, pshard)
    _, o, m = step(state["params"], state["opt"], batches[2])
    out["next_loss"] = np.asarray(m["loss"])
    out["next_step"] = np.asarray(o["step"])
np.savez(PATH, **out)
"""


def repro_child(mesh_runner, tmp_path, name: str, mode: str, shape=(2, 2), ckpt_dir=""):
    """``REPRO_CHILD`` for case ``name`` on a ``shape`` host mesh in a child
    with four host devices: ``mode`` "steps", "write" or "read"; its .npz."""
    path = str(tmp_path / f"{mode}_{name}_{shape[0]}x{shape[1]}.npz")
    subs = {"__SHAPE__": repr(tuple(shape)), "__PATH__": repr(path), "__MODE__": repr(mode),
            "__CKPT__": repr(str(ckpt_dir)), "__OVER__": repr(CASES[name][1]),
            "__VOCAB__": str(VOCAB), "__OPT__": repr(OPT), "__BATCH__": str(BATCH),
            "__SEQ__": str(SEQ), "__STEPS__": str(REPRO_STEPS)}
    code = REPRO_CHILD
    for k, v in subs.items():
        code = code.replace(k, v)
    mesh_runner(code, n_devices=4, timeout=300)
    return np.load(path), path


def _from_npz(arrs, cfg) -> tuple:
    like, axes = T.init_lm(cfg, seed=0, device="cpu")
    n = len(tree.leaves(like))
    params = tree.unflatten(like, [torch.from_numpy(np.array(arrs[f"param/{i}"]))
                                   for i in range(n)])
    toks = [torch.from_numpy(np.array(arrs[f"tokens{s}"])) for s in range(REPRO_STEPS)]
    return params, axes, toks


def repro_steps(mesh, path: str, name: str) -> dict:
    """``REPRO_STEPS`` meshed steps from ``repro``'s params on its tokens (the
    child's ``.npz``): losses and norms; the step-1 gradients, gathered."""
    arrs = np.load(path)
    cfg = config(name)
    params, axes, toks = _from_npz(arrs, cfg)
    local, specs = place(params, axes, cfg, mesh)
    fn = loss_fn(cfg)
    blocks = [synthetic.data_block({"tokens": t}, mesh) for t in toks]

    _loss, _m, grads = ts.meshed_grads(fn, local, blocks[0], mesh, specs)
    res = {"grads": gathered(grads, specs, mesh), "losses": [], "norms": []}
    step = ts.make_train_step(fn, opt.OptConfig(**OPT), mesh=mesh, specs=specs)
    state = opt.init(local)
    for b in blocks:
        local, state, m = step(local, state, b)
        res["losses"].append(float(m["loss"]))
        res["norms"].append(float(m["grad_norm"]))
    return res


def twolevel_vs_gspmd(mesh) -> dict:
    """The QR case's step-1 loss and gradients with ``embedding_exec``
    ``twolevel`` and ``gspmd`` on this rank (``repro``'s
    ``test_twolevel_embedding_matches_gspmd``), gathered."""
    out = {}
    for exec_ in ("twolevel", "gspmd"):
        cfg = config("qr-twolevel", embedding_exec=exec_)
        params, axes = T.init_lm(cfg, seed=0, device="cpu")
        local, specs = place(params, axes, cfg, mesh)
        b = synthetic.data_block({"tokens": tokens(cfg)}, mesh)
        loss, _m, grads = ts.meshed_grads(loss_fn(cfg), local, b, mesh, specs)
        out[exec_] = {"loss": float(loss), "grads": gathered(grads, specs, mesh)}
    return out


def restore_and_step(mesh, directory: str, path: str, name: str,
                     train_steps: int | None) -> dict:
    """With ``train_steps``: that many meshed steps from ``repro``'s params
    on its tokens (``path``), saved to ``directory`` (the full logical
    arrays); without: this rank's blocks restored from the newest checkpoint
    there.  Then the next step on the tokens of step 2: its loss."""
    from repro_torch.checkpoint import checkpointer as ckpt

    arrs = np.load(path)
    cfg = config(name)
    params, axes, toks = _from_npz(arrs, cfg)
    local, specs = place(params, axes, cfg, mesh)
    state = {"params": local, "opt": opt.init(local)}
    state_specs = SH.tree_specs({"params": params, "opt": opt.init(params)},
                                {"params": axes, "opt": opt.opt_axes(axes)}, mesh,
                                SH.lm_param_rules(cfg, mesh))
    step = ts.make_train_step(loss_fn(cfg), opt.OptConfig(**OPT), mesh=mesh, specs=specs)
    block = lambda s: synthetic.data_block({"tokens": toks[s]}, mesh)
    res = {}
    if train_steps is None:
        res["restored_step"] = ckpt.latest_step(directory)
        state, _extra = ckpt.restore(directory, res["restored_step"], state, mesh=mesh,
                                     specs=state_specs)
    else:
        for s in range(train_steps):
            p, o, _m = step(state["params"], state["opt"], block(s))
            state = {"params": p, "opt": o}
        ckpt.save(directory, train_steps, state,
                  extra={"pipeline": {"seed": 0, "step": train_steps}}, mesh=mesh,
                  specs=state_specs)
    _p, o, m = step(state["params"], state["opt"], block(2))
    res["next_loss"], res["opt_step"] = float(m["loss"]), int(o["step"])
    return res


def world1_step(mesh, name: str) -> dict:
    """The meshed step on this rank's device (world 1: the whole state,
    every collective over a group of one): the step-1 gradients, the loss,
    the step's loss and norm, and the launches of K9 and K8."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import qr_gather as qg

    dev = mesh.device
    cfg = config(name)
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    local, specs = place(tree.tree_map(lambda a: a.to(dev), params), axes, cfg, mesh)
    b = {"tokens": tokens(cfg).to(dev)}
    fn = loss_fn(cfg)
    before = fa.LAUNCHES["flash_fwd"] + qg.LAUNCHES["qr_gather"]

    loss, _m, grads = ts.meshed_grads(fn, local, b, mesh, specs)
    step = ts.make_train_step(fn, opt.OptConfig(**OPT), mesh=mesh, specs=specs)
    new, _state, m = step(local, opt.init(local), b)
    return {"grads": gathered(grads, specs, mesh), "loss": float(loss),
            "step_loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
            "params": gathered(new, specs, mesh),
            "launches": fa.LAUNCHES["flash_fwd"] + qg.LAUNCHES["qr_gather"] - before}
