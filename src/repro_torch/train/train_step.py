"""The training step: loss -> grads -> AdamW, with microbatch gradient
accumulation (port of ``repro.train.train_step``, DLRM part).

A model plugs in through ``loss_fn(params, batch) -> (loss, metrics)``;
``make_train_step`` differentiates it with ``torch.autograd`` in every leaf
of the params' nesting, accumulates fp32 gradients over microbatches (the
batch split along its first dim, each slice's gradient and loss divided by
the count, as ``repro``'s scan does), then runs ``optimizer.update``.  PyTorch
runs eagerly: there is no jit to wrap it in.  The LM losses wait for the LM
side of the port.

On a mesh the step is one rank's (``repro``'s jitted step under
``use_rules``, written out): the loss runs under ``sharding.use_rules`` on
the rank's block of the batch along the ``batch`` rule's axes (``data``)
and its blocks of the params, so the DLRM forward takes the two-level GnR;
the gradients and the loss are then averaged over the ranks that hold
other batch blocks (one all-reduce of all of them together), never summed
over the row axis (the GnR's own collectives carry that); and the update
runs on the rank's blocks with the mesh's global norm.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig


def make_dlrm_loss(cfg) -> Callable:
    """batch = {"dense", "idx", "labels"} -> (BCE loss, {"loss"})."""
    from repro_torch.models import dlrm

    def loss_fn(params, batch):
        logits = dlrm.forward_dlrm(params, batch["dense"], batch["idx"], cfg)
        loss = dlrm.bce_loss(logits, batch["labels"])
        return loss, {"loss": loss}

    return loss_fn


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads): ``loss_fn`` on ``params`` and its gradient in
    every leaf (zeros for a leaf the loss does not reach)."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    live = tree.unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
    return loss.detach(), metrics, tree.unflatten(params, grads)


def _split(batch: dict, m: int) -> list[dict]:
    n = next(iter(batch.values())).shape[0]
    if n % m:
        raise ValueError(f"batch {n} does not split into {m} microbatches")
    return [{k: v[i * (n // m):(i + 1) * (n // m)] for k, v in batch.items()}
            for i in range(m)]


def data_mean(grads, loss: torch.Tensor, mesh):
    """(grads, loss) averaged over the ranks holding other batch blocks:
    every fp32 gradient and the loss in one flat buffer, one all-reduce a
    batch axis.  Unchanged where the batch is not split."""
    axes = SH.batch_axes(mesh)
    if not axes:
        return grads, loss
    leaves = tree.leaves(grads)
    flat = torch.cat([g.to(torch.float32).reshape(-1) for g in leaves]
                     + [loss.to(torch.float32).reshape(1)])
    n = 1
    for ax in axes:
        flat = collectives.psum(flat, mesh, ax, site="grad_mean")
        n *= mesh.shape[ax]
    flat.div_(n)
    out, at = [], 0
    for g in leaves:
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return tree.unflatten(grads, out), flat[at]


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig, *,
                    microbatches: int = 1, mesh=None, specs=None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    With a ``mesh``: ``params`` and ``opt_state`` are this rank's blocks
    under ``specs`` (``sharding.tree_specs`` of the params), ``batch`` its
    block of the global batch; the loss runs under ``DEFAULT_RULES``, and
    ``metrics["loss"]`` is the global batch's.
    """
    if mesh is not None:
        inner = loss_fn

        def loss_fn(p, b):
            with SH.use_rules(mesh, SH.DEFAULT_RULES):
                return inner(p, b)

    def step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            grads = tree.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            loss = None
            for mb in _split(batch, microbatches):
                loss_i, _, g_i = value_and_grad(loss_fn, params, mb)
                grads = tree.tree_map(lambda a, g: a + g.to(torch.float32) / microbatches,
                                      grads, g_i)
                part = loss_i / microbatches
                loss = part if loss is None else loss + part
            metrics = {"loss": loss}
        if mesh is not None:
            grads, loss = data_mean(grads, loss, mesh)
            metrics = {**metrics, "loss": loss}
        params, opt_state, opt_metrics = opt_mod.update(params, grads, opt_state, opt_cfg,
                                                        mesh=mesh, specs=specs)
        return params, opt_state, {**metrics, **opt_metrics}

    return step


def make_eval_step(loss_fn: Callable) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _loss, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
