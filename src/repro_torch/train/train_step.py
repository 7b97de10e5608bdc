"""The training step: loss -> grads -> AdamW, with microbatch gradient
accumulation (port of ``repro.train.train_step``).

A model plugs in through ``loss_fn(params, batch) -> (loss, metrics)``:
``make_lm_loss`` (a causal LM's ``next_token_loss``),
``make_prefixed_lm_loss`` (a prefix model's) and ``make_dlrm_loss``.
``make_train_step`` differentiates it with ``torch.autograd`` in every leaf
of the params' nesting, accumulates fp32 gradients over microbatches (the
batch split along its first dim, each slice's gradient and loss divided by
the count, as ``repro``'s scan does; the sum is taken in place, one fp32
accumulator for the whole step), then runs ``optimizer.update``.  PyTorch
runs eagerly: there is no jit to wrap it in.

``next_token_loss`` is ``repro``'s fp32 math (``logsumexp`` minus the
target logit over ``logits[:, :-1]``, averaged) taken over row chunks of
at most ``LOSS_CHUNK_BYTES`` of fp32: it keeps the logits in their own
dtype and widens one chunk at a time, forward and backward, where plain
autograd of the fp32 cast would keep two fp32 copies of the (B, S, V)
logits for the backward (at qwen2-1.5b's vocabulary and S 4,096, 2.5 GB a
sequence each).  Every row's value is the plain one's; the backward
writes ``(softmax - onehot) / N`` for each chunk, rounded once to the
logits' dtype, as the plain cast's backward rounds it.

On a mesh the step is one rank's (``repro``'s jitted step under
``use_rules``, written out): the loss runs under ``sharding.use_rules`` on
the rank's block of the batch along the ``batch`` rule's axes (``data``)
and its blocks of the params, so the DLRM forward takes the two-level GnR
and the LM's runs tensor-parallel with the vocab-parallel loss
(``next_token_loss(mesh=)``: one ``pmax`` and one ``psum`` over ``model`` a
microbatch); the gradients and the loss are then averaged over the ranks
that hold other batch blocks (one all-reduce of all of them together),
never summed over the row axis (the model's own collectives carry that);
and the update runs on the rank's blocks with the mesh's global norm.
Under an LM's FSDP layout (``sharding.lm_param_rules``: ``embed`` stored
split over ``data``) the loss runs under ``sharding.use_fsdp``: the model
gathers those leaves at their use, and their gradients arrive
reduce-scattered, summed over ``data`` already (``collectives.fsdp_gather``);
``data_mean`` divides them by the data ranks and all-reduces only the
leaves left whole over ``data`` (the MoE router, a dim ``data`` does not
divide) and the loss, and the fp32 microbatch accumulator is the rank's
block.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptConfig

LOSS_CHUNK_BYTES = 1 << 28      # fp32 logits one chunk of the loss widens


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_chunks(logits: torch.Tensor):
    """(b, row slice) pairs over ``logits[:, :-1]``, each at most
    ``LOSS_CHUNK_BYTES`` of fp32 rows."""
    b, s, v = logits.shape
    rows = max(1, LOSS_CHUNK_BYTES // (4 * max(v, 1)))
    for i in range(b):
        for lo in range(0, s - 1, rows):
            yield i, slice(lo, min(lo + rows, s - 1))


class _NextTokenLoss(torch.autograd.Function):
    """Mean over (B, S - 1) of ``logsumexp(lg) - lg[target]`` in fp32, the
    logits widened one chunk at a time; saves the logits and each row's
    logsumexp (fp32, (B, S - 1)) for the backward."""

    @staticmethod
    def forward(ctx, logits, targets):
        b, s, _ = logits.shape
        lse = torch.empty((b, s - 1), dtype=torch.float32, device=logits.device)
        nll = torch.empty_like(lse)
        for i, rows in _loss_chunks(logits):
            lg = logits[i, rows].float()
            lse[i, rows] = torch.logsumexp(lg, dim=-1)
            ll = torch.take_along_dim(lg, targets[i, rows, None], dim=-1)[:, 0]
            nll[i, rows] = lse[i, rows] - ll
        ctx.save_for_backward(logits, targets, lse)
        return torch.mean(nll)

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        grad = torch.zeros_like(logits)          # the last position has no target
        scale = g.float() / lse.numel()
        for i, rows in _loss_chunks(logits):
            p = torch.exp(logits[i, rows].float() - lse[i, rows, None])
            p.scatter_add_(-1, targets[i, rows, None],
                           torch.full_like(p[:, :1], -1.0))
            grad[i, rows] = (p * scale).to(grad.dtype)
        return grad, None


class _VocabParallelLoss(torch.autograd.Function):
    """``_NextTokenLoss`` from this rank's vocabulary slice ``[start, start
    + V_local)`` of the logits (Megatron's vocab-parallel cross-entropy):
    each row's max and the sum of its exponentials below it are taken on
    the slice, chunk by chunk in fp32, and so is the target logit where the
    slice holds the target; then one ``pmax`` of the maxes and one ``psum``
    of the rescaled sums and the target logits over ``axis`` give every
    rank the whole rows' logsumexp and the loss.  The backward needs no
    collective: the slice's gradient is ``(softmax - onehot) / N`` on its
    own columns.  A rank with an empty slice takes part with zeros."""

    @staticmethod
    def forward(ctx, logits, targets, start, mesh, axis):
        b, s, v = logits.shape
        mx = torch.full((b, s - 1), -torch.inf, dtype=torch.float32, device=logits.device)
        se, ll = torch.zeros_like(mx), torch.zeros_like(mx)
        local = targets - start
        own = (local >= 0) & (local < v)
        local = local.clamp(0, max(v - 1, 0))
        if v:
            for i, rows in _loss_chunks(logits):
                lg = logits[i, rows].float()
                m = lg.amax(dim=-1)
                mx[i, rows] = m
                se[i, rows] = torch.exp(lg - m[:, None]).sum(dim=-1)
                ll[i, rows] = torch.take_along_dim(lg, local[i, rows, None], dim=-1)[:, 0]
        m = collectives.pmax(mx, mesh, axis)
        both = collectives.psum(torch.stack([se * torch.exp(mx - m), ll * own]), mesh, axis,
                                site="loss")
        lse = m + torch.log(both[0])
        ctx.save_for_backward(logits, local, own, lse)
        return torch.mean(lse - both[1])

    @staticmethod
    def backward(ctx, g):
        logits, local, own, lse = ctx.saved_tensors
        grad = torch.zeros_like(logits)          # the last position has no target
        scale = g.float() / lse.numel()
        if logits.shape[-1]:
            for i, rows in _loss_chunks(logits):
                p = torch.exp(logits[i, rows].float() - lse[i, rows, None])
                p.scatter_add_(-1, local[i, rows, None], -own[i, rows, None].float())
                grad[i, rows] = (p * scale).to(grad.dtype)
        return grad, None, None, None, None


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *, vocab_start: int = 0,
                    mesh=None, axis: str = "model") -> torch.Tensor:
    """Causal LM loss: logits (B, S, V) vs shifted tokens (B, S); fp32 math.
    With a ``mesh``, ``logits`` are this rank's vocabulary slice from
    ``vocab_start`` (``transformer.lm_logits`` on a mesh) and the loss is
    reduced over ``axis`` (``_VocabParallelLoss``): the same value on every
    rank, the single card's to fp32 rounding."""
    if mesh is None:
        return _NextTokenLoss.apply(logits, tokens[:, 1:].long())
    return _VocabParallelLoss.apply(logits, tokens[:, 1:].long(), vocab_start, mesh, axis)


def _lm_loss(logits, tokens, cfg, vocab_range: Callable | None):
    """``next_token_loss`` of ``logits``: under a mesh with a ``model`` axis
    (``sharding.model_mesh``) the logits are this rank's vocabulary slice
    ``vocab_range(cfg, mesh) -> [lo, hi)`` (``transformer.vocab_range``)
    and the loss is the vocab-parallel one."""
    mesh = SH.model_mesh()
    if mesh is not None and vocab_range is None:
        raise ValueError("an LM loss on a mesh needs the forward's vocab_range")
    kw = {} if mesh is None else {"mesh": mesh, "vocab_start": vocab_range(cfg, mesh)[0]}
    return next_token_loss(logits, tokens, **kw)


def make_lm_loss(forward_fn: Callable, cfg, *, vocab_range: Callable | None = None
                 ) -> Callable:
    """forward_fn(params, tokens, cfg) -> logits. batch = {"tokens": (B, S)};
    vocab-parallel on a mesh (``_lm_loss``)."""

    def loss_fn(params, batch):
        logits = forward_fn(params, batch["tokens"], cfg)
        loss = _lm_loss(logits, batch["tokens"], cfg, vocab_range)
        return loss, {"loss": loss}

    return loss_fn


def make_prefixed_lm_loss(forward_fn: Callable, cfg, prefix_key: str, *,
                          vocab_range: Callable | None = None) -> Callable:
    """forward_fn(params, prefix, tokens, cfg) -> logits, the prefix (whisper's
    frames, pixtral's patches) under ``batch[prefix_key]``; vocab-parallel
    on a mesh, as ``make_lm_loss``."""

    def loss_fn(params, batch):
        logits = forward_fn(params, batch[prefix_key], batch["tokens"], cfg)
        loss = _lm_loss(logits, batch["tokens"], cfg, vocab_range)
        return loss, {"loss": loss}

    return loss_fn


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


def data_mean(grads, loss: torch.Tensor, mesh, specs):
    """(grads, loss) averaged over the ranks holding other batch blocks:
    every fp32 gradient and the loss in one flat buffer, one all-reduce a
    batch axis.  A leaf whose spec (``specs``, one a leaf) splits it over
    ``data`` (FSDP, ``sharding.fsdp_dim``) came reduce-scattered, summed
    over ``data`` already: it is divided by the data ranks and left out of
    the all-reduce.  Unchanged where the batch is not split."""
    axes = SH.batch_axes(mesh)
    if not axes:
        return grads, loss
    leaves = tree.leaves(grads)
    if specs is None or len(specs) != len(leaves):
        raise ValueError("data_mean needs one spec a gradient leaf: it reads from them which "
                         "gradients came reduce-scattered over data")
    summed = [SH.fsdp_dim(s, mesh) is not None for s in specs]
    flat = torch.cat([g.to(torch.float32).reshape(-1) for g, s in zip(leaves, summed) if not s]
                     + [loss.to(torch.float32).reshape(1)])
    n = 1
    for ax in axes:
        flat = collectives.psum(flat, mesh, ax, site="grad_mean")
        n *= mesh.shape[ax]
    flat.div_(n)
    out, at = [], 0
    for g, s in zip(leaves, summed):
        if s:
            out.append(g.to(torch.float32) / n)
            continue
        out.append(flat[at:at + g.numel()].view(g.shape))
        at += g.numel()
    return tree.unflatten(grads, out), flat[at]


def meshed_loss(loss_fn: Callable, mesh, specs) -> Callable:
    """``loss_fn`` as one rank of ``mesh`` runs it: under ``DEFAULT_RULES``
    and ``sharding.use_fsdp`` of its params' ``specs`` (the leaves they
    split over ``data`` gathered at their use)."""

    def fn(p, b):
        with SH.use_rules(mesh, SH.DEFAULT_RULES), SH.use_fsdp(mesh, p, specs):
            return loss_fn(p, b)

    return fn


def accumulated_grads(loss_fn: Callable, params, batch, microbatches: int = 1):
    """(loss, metrics, grads) of ``batch``: ``value_and_grad`` of the whole
    batch, or over ``microbatches`` slices with the fp32 gradients and the
    loss averaged in place."""
    if microbatches <= 1:
        return value_and_grad(loss_fn, params, batch)
    grads = tree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    loss = None
    for mb in _split(batch, microbatches):
        loss_i, _, g_i = value_and_grad(loss_fn, params, mb)
        for a, g in zip(tree.leaves(grads), tree.leaves(g_i)):
            a.add_(g.to(torch.float32) / microbatches)
        del g_i
        part = loss_i / microbatches
        loss = part if loss is None else loss + part
    return loss, {"loss": loss}, grads


def meshed_grads(loss_fn: Callable, params, batch, mesh, specs, *, microbatches: int = 1):
    """(loss, metrics, grads) of one rank of ``mesh``: ``loss_fn`` on its
    blocks ``params`` (one spec a leaf in ``specs``) and its ``batch``
    block under ``meshed_loss``, accumulated over ``microbatches``, then
    averaged over the data ranks (``data_mean``): the global batch's loss
    and this rank's blocks of the averaged gradients.  Every meshed
    gradient of the port comes from here."""
    loss, metrics, grads = accumulated_grads(meshed_loss(loss_fn, mesh, specs), params, batch,
                                             microbatches)
    grads, loss = data_mean(grads, loss, mesh, specs)
    return loss, {**metrics, "loss": loss}, grads


def make_train_step(loss_fn: Callable, opt_cfg: OptConfig, *,
                    microbatches: int = 1, mesh=None, specs=None) -> Callable:
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    With a ``mesh``: ``params`` and ``opt_state`` are this rank's blocks
    under ``specs`` (``sharding.tree_specs`` of the params), ``batch`` its
    block of the global batch, and the gradients ``meshed_grads``'
    (``metrics["loss"]`` the global batch's).
    """

    def step(params, opt_state, batch):
        if mesh is None:
            loss, metrics, grads = accumulated_grads(loss_fn, params, batch, microbatches)
        else:
            loss, metrics, grads = meshed_grads(loss_fn, params, batch, mesh, specs,
                                                microbatches=microbatches)
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
