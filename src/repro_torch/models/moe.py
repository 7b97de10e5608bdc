"""Capacity-based top-k MoE with expert parallelism over ``model`` (port of
``repro.models.moe``).

``repro``'s scheme, kept: tokens stay split over ``data``, the expert
stacks are split over ``model``; each rank routes its local tokens over all
experts (the router is whole on every rank), dispatches the assignments
that fall on its local experts into capacity-bounded queues, runs their
FFNs and contributes a partial output, and one combine over ``model``
(``repro``'s psum) adds the partials.  No all-to-all.

Drops are ``repro``'s (GShard / Switch): an assignment's position in its
expert's queue counts the earlier assignments to that expert in token-major
``(T * k)`` order, and one at or past the capacity contributes nothing.
``repro`` takes the position from a one-hot cumsum over ``(T * k, E_loc)``;
here a stable sort by expert gives the same positions in ``O(T * k)``
memory (the one-hot would be ~0.4 GB a layer at a full-width prefill).
Router probabilities are renormalized over the top-k (Qwen3's
``norm_topk_prob``); the router runs in fp32, the FFNs in the compute dtype.

No atomics, so two runs give the same bits: a dropped assignment is routed
to a trash row instead of multiplied by zero (the same values), each kept
slot holds exactly one assignment, and every sum over a token's k
assignments (the combine, and the dispatch's backward) is a loop over k in
token-major order in the tensors' dtype, as ``repro``'s scatter-add adds
them.  The two ``moe_dispatch`` modes are ``repro``'s: ``scatter`` expands
every routed token to a ``(T * k, d)`` copy and scatters it into the
capacity buffer; ``gather`` scatters token ids into a slot map and gathers
the rows.  Both fill the buffer with the same values.

On a mesh (``sharding.model_mesh``) the layer's input and the router enter
through ``collectives.enter`` (each rank's partial differentiates them; the
backward sums the ranks' gradients over ``model``) and the output leaves
through one ``collectives.combine``.  Each rank's capacity comes from its
own tokens and the experts padded to a multiple of ``model``, as
``repro``'s ``shard_map`` sizes it.  Where ``model`` does not divide
``num_experts`` the stacks stay whole on every rank (``lm_param_rules``),
enter too, and each rank takes its block of the zero-padded stack in the
call, as ``head_split`` treats kv heads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import _normal

STACKS = ("w_up", "w_gate", "w_down")


def padded_experts(cfg, num_shards: int) -> int:
    return -(-cfg.num_experts // num_shards) * num_shards


def init_moe(cfg, *, generator: torch.Generator, device):
    """The router (d, E) and the three expert stacks, ``repro``'s shapes,
    scales and logical axes, drawn from ``generator`` in that order."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale_in = 1.0 / math.sqrt(d)
    scale_out = 1.0 / math.sqrt(f * 2 * max(cfg.num_layers, 1))
    kw = dict(generator=generator, device=device)
    params = {
        "router": _normal((d, e), cfg.pdtype, scale=scale_in, **kw),
        "w_up": _normal((e, d, f), cfg.pdtype, scale=scale_in, **kw),
        "w_gate": _normal((e, d, f), cfg.pdtype, scale=scale_in, **kw),
        "w_down": _normal((e, f, d), cfg.pdtype, scale=scale_out, **kw),
    }
    axes = {
        "router": ("embed", "experts"),
        "w_up": ("experts", "embed", "expert_ffn"),
        "w_gate": ("experts", "embed", "expert_ffn"),
        "w_down": ("experts", "expert_ffn", "embed"),
    }
    return params, axes


def _capacity(tokens: int, cfg, num_shards: int) -> int:
    e = padded_experts(cfg, num_shards)
    c = int(math.ceil(tokens * cfg.top_k / e * cfg.capacity_factor))
    return max(c, 4)


def route(router: torch.Tensor, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """x (..., d) -> (ids (T, k) int32, wts (T, k) fp32): the fp32 router's
    softmax, its top-k, renormalized.  The top-k is a stable descending
    sort's first k, so of equal probabilities the lower expert comes first,
    as ``jax.lax.top_k`` orders them (``torch.topk`` does not say)."""
    logits = x.float().reshape(-1, x.shape[-1]) @ router.float()
    probs = torch.softmax(logits, dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[:, :cfg.top_k], ids[:, :cfg.top_k]
    wts = wts / torch.clamp(wts.sum(dim=-1, keepdim=True), min=1e-9)
    return ids.to(torch.int32), wts


def slots(ids: torch.Tensor, e_start: int, e_loc: int, capacity: int) -> torch.Tensor:
    """(T, k) global expert ids -> each assignment's slot in the local
    ``(e_loc * capacity)`` buffer, or ``e_loc * capacity`` (the trash row)
    where it is dropped or its expert is not local; int64, (T * k,)."""
    local = ids.reshape(-1).long() - e_start
    mine = (local >= 0) & (local < e_loc)
    key = torch.where(mine, local, e_loc)
    skey, order = torch.sort(key, stable=True)
    # each expert's first place in the sorted order (no count on the host:
    # bincount would wait for the card)
    starts = torch.searchsorted(skey, torch.arange(e_loc + 1, device=key.device))
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.numel(), device=key.device) - starts[skey]
    keep = mine & (pos < capacity)
    return torch.where(keep, local * capacity + pos, e_loc * capacity)


def _with_trash(t: torch.Tensor) -> torch.Tensor:
    """``t`` (N, d) with a zero row appended at index N."""
    return torch.cat([t, t.new_zeros((1, t.shape[1]))])


def _ordered_sum(k: int, rows_of) -> torch.Tensor:
    """``rows_of(0) + rows_of(1) + ... + rows_of(k - 1)``, added in order."""
    out = rows_of(0)
    for j in range(1, k):
        out = out + rows_of(j)
    return out


class _GatherDispatch(torch.autograd.Function):
    """``gather`` dispatch: ``buf[s] = x[src[s] - 1]`` where ``src[s] > 0``,
    else 0.  Backward: each token's gradient is the sum of its kept slots'
    gradients over its k assignments in order (no index-add)."""

    @staticmethod
    def forward(ctx, x, src, slot):
        ctx.save_for_backward(slot)
        valid = (src > 0).to(x.dtype)[:, None]
        return x[torch.clamp(src - 1, min=0)] * valid

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors                 # (T, k)
        g = _with_trash(g)
        return _ordered_sum(slot.shape[1], lambda j: g[slot[:, j]]), None, None


class _Combine(torch.autograd.Function):
    """``out[t] = sum_j w[t, j] y[slot[t, j]]`` over the kept assignments,
    added over j in order in y's dtype (``repro``'s scatter-add).  Backward:
    each kept slot's gradient is its one assignment's ``w * g[t]``; the
    weights' gradient is ``<y[slot], g[t]>``."""

    @staticmethod
    def forward(ctx, y, w, slot, inv):
        ctx.save_for_backward(y, w, slot, inv)
        yt = _with_trash(y)
        return _ordered_sum(slot.shape[1], lambda j: yt[slot[:, j]] * w[:, j, None])

    @staticmethod
    def backward(ctx, g):
        y, w, slot, inv = ctx.saved_tensors
        k = slot.shape[1]
        a = torch.clamp(inv - 1, min=0)              # each slot's assignment
        gy = g[a // k] * (w.reshape(-1)[a] * (inv > 0).to(w.dtype))[:, None]
        yt = _with_trash(y)
        gw = torch.stack([(yt[slot[:, j]] * g).sum(dim=-1) for j in range(k)], dim=1)
        return gy, gw.to(w.dtype), None, None


def local_expert_ffn(w_up, w_gate, w_down, buf: torch.Tensor, cfg) -> torch.Tensor:
    """buf: (E_loc, C, d) -> (E_loc, C, d), SwiGLU in the compute dtype."""
    cd = cfg.cdtype
    up = torch.bmm(buf, w_up.to(cd))
    gate = torch.bmm(buf, w_gate.to(cd))
    return torch.bmm(F.silu(gate) * up, w_down.to(cd))


def dispatch_compute(x, ids, wts, w_up, w_gate, w_down, e_start: int, capacity: int,
                     cfg) -> torch.Tensor:
    """x (T, d) local tokens, ids / wts (T, k), the local expert stacks
    (E_loc, ...) -> this rank's partial output (T, d) in the compute dtype."""
    t, k = ids.shape
    e_loc, d = w_up.shape[0], x.shape[1]
    cd = cfg.cdtype
    trash = e_loc * capacity
    slot = slots(ids, e_start, e_loc, capacity)
    # each slot's assignment + 1 (0: an empty slot); kept slots are unique
    inv = torch.zeros(trash + 1, dtype=torch.long, device=x.device).index_put_(
        (slot,), torch.arange(1, t * k + 1, device=x.device))[:trash]
    if cfg.moe_dispatch == "gather":
        src = torch.where(inv > 0, torch.div(inv - 1, k, rounding_mode="floor") + 1, 0)
        buf = _GatherDispatch.apply(x.to(cd), src, slot.view(t, k))
    else:  # "scatter": the GShard-style expansion, a (T * k, d) copy
        contrib = x.to(cd).unsqueeze(1).expand(t, k, d).reshape(t * k, d)
        buf = torch.zeros((trash + 1, d), dtype=cd, device=x.device).index_put(
            (slot,), contrib)[:trash]
    y = local_expert_ffn(w_up, w_gate, w_down, buf.view(e_loc, capacity, d), cfg)
    return _Combine.apply(y.reshape(trash, d), wts.to(cd), slot.view(t, k), inv)


def _block(w: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Experts ``[lo, lo + n)`` of the stack ``w`` zero-padded past its end."""
    part = w[lo:min(lo + n, w.shape[0])]
    if part.shape[0] == n:
        return part
    return torch.cat([part, part.new_zeros((n - part.shape[0], *w.shape[1:]))])


def apply_moe(p: dict, x: torch.Tensor, cfg, *, mesh=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) in the compute dtype.  On a ``mesh`` with a
    ``model`` axis, this rank's batch block through its local experts, the
    partials combined over ``model`` (the module's docstring)."""
    b, s, d = x.shape
    cd = cfg.cdtype
    mesh = SH.model_mesh(mesh)
    if mesh is None:
        ids, wts = route(p["router"], x, cfg)
        cap = _capacity(b * s, cfg, 1)
        stacks = (p[n].to(cd) for n in STACKS)
        return dispatch_compute(x.reshape(-1, d), ids, wts, *stacks, 0, cap, cfg).reshape(
            b, s, d)
    m, shard = mesh.shape["model"], mesh.axis_index("model")
    e_loc = padded_experts(cfg, m) // m
    stacks = [p[n] for n in STACKS]
    if SH.expert_split(cfg, mesh):
        x, router = collectives.enter([x, p["router"]], mesh, "model")
    else:
        x, router, *stacks = collectives.enter([x, p["router"], *stacks], mesh, "model")
        stacks = [_block(w, shard * e_loc, e_loc) for w in stacks]
    ids, wts = route(router, x, cfg)
    cap = _capacity(b * s, cfg, m)
    out = dispatch_compute(x.reshape(-1, d), ids, wts, *(w.to(cd) for w in stacks),
                           shard * e_loc, cap, cfg)
    return collectives.combine(out.reshape(b, s, d), mesh, "model")


def dropped(ids: torch.Tensor, cfg) -> int:
    """How many assignments of ``ids`` (T, k) one card drops: those past
    their expert's capacity in a layer call of T tokens."""
    cap = _capacity(ids.shape[0], cfg, 1)
    return int((slots(ids, 0, cfg.num_experts, cap) == cfg.num_experts * cap).sum())
