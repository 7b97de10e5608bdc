"""AdamW with fp32 state, schedules and global-norm clipping (port of
``repro.train.optimizer``).

Plain tensor operations on the params' nesting (``repro_torch.tree``), not
``torch.optim``: the defaults and the arithmetic are ``repro``'s — beta2
0.95, weight decay on every leaf, fp32 moments and step count, and low
precision params updated through an fp32 round trip.  ``update`` is
functional, as ``repro``'s: it returns new params and state and leaves its
arguments as they were.

On a mesh (one process a rank) each rank updates its own blocks of the
params, and the state mirrors them leaf for leaf (``opt_axes``); the global
norm, on which clipping acts, counts every block once: a leaf sharded over
mesh axes has its squared sum summed over those axes (one all-reduce an
axis, carrying every set of axes that names it), a replicated leaf counts
as it is.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"          # cosine | linear | constant


def init(params) -> dict:
    """Zero fp32 moments shaped like the params, and step 0 (int32)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree.leaves(params)[0]
    return {
        "mu": tree.tree_map(zeros, params),
        "nu": tree.tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def opt_axes(param_axes: dict) -> dict:
    """Logical axes for the optimizer state tree (mirrors params)."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


def learning_rate(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine, linear or constant decay, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = torch.ones_like(step)
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        if cfg.schedule == "linear":
            decay = 1.0 - (1.0 - cfg.min_lr_ratio) * t
        else:  # cosine
            decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * t))
    return cfg.lr * warm * decay


def global_norm(grads, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squared fp32 entries, leaves summed
    in ``repro``'s order.  On a ``mesh``, ``grads`` are this rank's blocks
    under ``specs`` (one per leaf, ``sharding.tree_specs``): the squared
    sums of the leaves split over a set of axes are psummed over those
    axes, so every block counts once, and the replicated leaves (and the
    whole parts of a fused leaf, ``sharding.spec_pieces``) count as they
    are; every rank gets the same norm."""
    leaves = tree.leaves(grads)
    if mesh is None:
        sq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
        return torch.sqrt(sq)
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH

    if specs is None or len(specs) != len(leaves):
        raise ValueError("global_norm on a mesh needs one spec per leaf")
    groups: dict = {}
    for g, spec in zip(leaves, specs):
        for piece, key in SH.spec_pieces(g, spec, mesh):
            part = torch.sum(torch.square(piece.to(torch.float32)))
            groups[key] = part if key not in groups else groups[key] + part
    total = groups.pop((), None)
    if groups:
        # one psum an axis: the squared sums of every set of axes that
        # names it, stacked (an FSDP layout has leaves split over data,
        # over model and over both)
        keys = list(groups)
        vec = torch.stack([groups[k] for k in keys])
        for ax in mesh.shape:
            idx = [i for i, k in enumerate(keys) if ax in k]
            if idx:
                at = torch.tensor(idx, device=vec.device)
                vec = vec.index_copy(0, at, collectives.psum(vec[at], mesh, ax, site="norm"))
        for part in vec:
            total = part if total is None else total + part
    if total is None:
        total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return torch.sqrt(total)


def clip_by_global_norm(grads, clip: float, *, mesh=None, specs=None):
    """Scale every leaf by min(1, clip / max(norm, 1e-12)); returns (grads,
    norm)."""
    norm = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return tree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def update(params, grads, state: dict, cfg: OptConfig, *, mesh=None, specs=None):
    """One AdamW step.  Returns (new_params, new_state, {"lr", "grad_norm"}).
    On a ``mesh``: this rank's blocks of the params, gradients and state,
    laid out by ``specs`` (the global norm's)."""
    grads = tree.tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, mesh=mesh, specs=specs)
    else:
        gnorm = global_norm(grads, mesh=mesh, specs=specs)

    step = state["step"] + 1
    lr = learning_rate(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.full_like(stepf, b1), stepf)
    c2 = 1.0 - torch.pow(torch.full_like(stepf, b2), stepf)
    new_mu = tree.tree_map(lambda g, m: b1 * m + (1 - b1) * g, grads, state["mu"])
    new_nu = tree.tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g), grads,
                           state["nu"])

    def leaf(p, m2, v2):
        upd = (m2 / c1) / (torch.sqrt(v2 / c2) + cfg.eps)
        pf = p.to(torch.float32)
        pf = pf - lr * (upd + cfg.weight_decay * pf)
        return pf.to(p.dtype)

    new_params = tree.tree_map(leaf, params, new_mu, new_nu)
    return new_params, {"mu": new_mu, "nu": new_nu, "step": step}, {"lr": lr,
                                                                     "grad_norm": gnorm}
