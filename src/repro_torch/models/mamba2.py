"""Mamba2 (SSD) blocks (port of ``repro.models.mamba2``): the chunked
parallel scan for train / prefill and the O(1)-state recurrence for decode.
Sub-quadratic: the cost is O(S · chunk), not O(S²), which is what puts the
hybrid and ssm archs in the ``long_500k`` cell.

The structure is the SSD "minimal" algorithm (Dao & Gu 2024): a quadratic
attention-like term within each chunk, and the states passed across chunks
by a recurrence.  Neither package has a kernel for it: every step is plain
torch (``repro``'s is ``jnp`` and ``lax.scan``), so on the card these are
the library's own elementwise and matrix-product kernels.

Numerics follow ``repro`` cast for cast: ``mamba2_fwd`` hands the decays to
``ssd_chunked`` in the compute dtype, so in bf16 compute their cumulative
sums (each partial sum rounded, ``_cumsum``), ``_segsum`` and the ``exp``
run in bf16 as there.  ``repro``'s
four-operand einsum of the diagonal blocks is contracted in an explicit
order: the C·Bᵀ scores of each group (B, C, G, L, S), times each head's
decay, then the product with x.  The cross-chunk scan is a loop over the
chunks.  A length the chunk does not divide is refused with a
``ValueError`` (``repro`` asserts); nothing is padded.

On a mesh (``mamba2_fwd(mesh=)``) the layer is tensor-parallel over
``model`` by SSM heads; B and C, which every head of a group reads, stay
whole on every rank (``layout``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models.layers import _normal

CONV_WIDTH = 4
CHUNK = 256


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def num_ssm_heads(cfg: ModelConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def ssm_split(cfg: ModelConfig, mesh, axis: str = "model") -> SH.BlockSplit | None:
    """This rank's SSM heads ``[lo, lo + n)`` of a layer of ``cfg``, or None
    where the layer runs replicated (``sharding.block_split``).  B and C,
    which every head of a group reads, stay whole on every rank
    (``layout``)."""
    return SH.block_split(num_ssm_heads(cfg), mesh, axis)


def layout(cfg: ModelConfig, mesh, axis: str = "model") -> dict:
    """The spec of each leaf of one layer on ``mesh`` (no layer dim): by the
    rank's SSM heads (``ssm_split``) where they split, whole where they do
    not.  ``in_proj``'s columns are the rank's block of z, then of x, then
    B and C whole, then its block of dt; ``conv_w`` / ``conv_b`` its block
    of x, then B and C whole; ``A_log``, ``D``, ``dt_bias`` its heads;
    ``norm_scale`` and ``out_proj``'s rows, ordered by head already, its
    contiguous block."""
    names = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale", "out_proj")
    if ssm_split(cfg, mesh, axis) is None:
        return {k: SH.P() for k in names}
    di, h = d_inner(cfg), num_ssm_heads(cfg)
    gn = cfg.ssm_groups * cfg.ssm_state
    conv = SH.Parts(axis, ((di, True), (gn, False), (gn, False)))
    return {"in_proj": SH.P(None, SH.Parts(axis, ((di, True), (di, True), (gn, False),
                                                  (gn, False), (h, True)))),
            "conv_w": SH.P(None, conv), "conv_b": SH.P(conv), "A_log": SH.P(axis),
            "D": SH.P(axis), "dt_bias": SH.P(axis), "norm_scale": SH.P(axis),
            "out_proj": SH.P(axis, None)}


def init_mamba2(cfg: ModelConfig, *, generator: torch.Generator, device):
    """One Mamba2 layer's params and logical axes, ``repro``'s shapes and
    scales, drawn from ``generator`` on ``device``."""
    d = cfg.d_model
    di = d_inner(cfg)
    g, n, h = cfg.ssm_groups, cfg.ssm_state, num_ssm_heads(cfg)
    conv_dim = di + 2 * g * n
    proj_out = 2 * di + 2 * g * n + h
    pd = cfg.pdtype
    kw = dict(generator=generator, device=device)
    params = {
        "in_proj": _normal((d, proj_out), pd, scale=1.0 / math.sqrt(d), **kw),
        "conv_w": _normal((CONV_WIDTH, conv_dim), pd, scale=0.5, **kw),
        "conv_b": torch.zeros((conv_dim,), dtype=pd, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=device)).to(pd),
        "D": torch.ones((h,), dtype=pd, device=device),
        "dt_bias": torch.zeros((h,), dtype=pd, device=device),
        "norm_scale": torch.ones((di,), dtype=pd, device=device),
        "out_proj": _normal((di, d), pd, scale=1.0 / math.sqrt(di * 2 * max(cfg.num_layers, 1)),
                            **kw),
    }
    axes = {
        "in_proj": ("embed", "ffn"),
        "conv_w": (None, "ffn"),
        "conv_b": ("ffn",),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_scale": ("ffn",),
        "out_proj": ("ffn", "embed"),
    }
    return params, axes


def _cumsum(a: torch.Tensor) -> torch.Tensor:
    """The cumulative sum over the last dim in a's dtype, as ``jnp.cumsum``
    takes it: below fp32 each partial sum is rounded to that dtype in turn
    (a loop over the dim: ``torch.cumsum`` would carry the sums in fp32 and
    round each output once, which moves every decay of a bf16 chunk)."""
    if a.dtype in (torch.float32, torch.float64):
        return torch.cumsum(a, dim=-1)
    steps = a.movedim(-1, 0).contiguous()          # each step's operand contiguous
    parts = [steps[0]]
    for i in range(1, steps.shape[0]):
        parts.append(parts[-1] + steps[i])
    return torch.stack(parts, dim=-1)


def _segsum_of(cum: torch.Tensor) -> torch.Tensor:
    """``_segsum`` from the cumulative sums ``cum`` (..., l)."""
    l = cum.shape[-1]
    diff = cum[..., :, None] - cum[..., None, :]
    upper = torch.ones((l, l), dtype=torch.bool, device=cum.device).triu(1)
    return diff.masked_fill_(upper, -math.inf)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., l) -> (..., l, l) with out[i, j] = sum_{k=j+1..i} a[k], -inf
    for j > i (the difference of the cumulative sums, in a's dtype)."""
    return _segsum_of(_cumsum(a))


def _chunk_len(s: int, chunk: int) -> int:
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk} "
                         f"(chunk = min({CHUNK}, S) must divide S)")
    return chunk


def ssd_chunked(x, a, b, c, *, chunk: int = CHUNK, initial_state=None):
    """SSD scan.

    x: (B, S, H, P); a: (B, S, H) (= dt·A, negative); b, c: (B, S, G, N).
    Returns (y: (B, S, H, P), final_state: (B, H, P, N)).
    """
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    chunk = _chunk_len(s, chunk)
    nc = s // chunk
    hpg = h // g

    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = a.reshape(bsz, nc, chunk, h).transpose(2, 3)               # (B,C,H,L)
    bc = b.reshape(bsz, nc, chunk, g, n)
    cc = c.reshape(bsz, nc, chunk, g, n)

    a_cum = _cumsum(ac)                                             # (B,C,H,L)
    decay = _segsum_of(a_cum).exp_()                                # (B,C,H,L,L)

    # 1) within-chunk (diagonal blocks): C·Bᵀ per group, times each head's
    #    decay (head hh reads group hh // hpg), then x
    scores = torch.matmul(cc.permute(0, 1, 3, 2, 4), bc.permute(0, 1, 3, 4, 2))  # (B,C,G,L,S)
    gated = decay.reshape(bsz, nc, g, hpg, chunk, chunk) * scores[:, :, :, None]
    del decay, scores                  # (B,C,H,L,L) tensors: one at a time
    xh = xc.permute(0, 1, 3, 2, 4)                                  # (B,C,H,L,P)
    y_diag = torch.matmul(gated.reshape(bsz, nc, h, chunk, chunk), xh)  # (B,C,H,L,P)
    del gated

    # 2) per-chunk final states: sum_l decay_to_end[l] x[l] ⊗ b[l]
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)               # (B,C,H,L)
    xs = (xh * decay_states[..., None]).reshape(bsz, nc, g, hpg, chunk, p)
    states = torch.matmul(xs.transpose(-1, -2), bc.permute(0, 1, 3, 2, 4)[:, :, :, None])
    states = states.reshape(bsz, nc, h, p, n)                       # (B,C,H,P,N)

    # 3) cross-chunk recurrence, chunk-major so each step reads contiguous rows
    chunk_decay = torch.exp(a_cum[..., -1])                         # (B,C,H)
    decays = chunk_decay.transpose(0, 1).to(states.dtype)[..., None, None].contiguous()
    states_c = states.transpose(0, 1).contiguous()                  # (C,B,H,P,N)
    prev = (torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
            if initial_state is None else initial_state)
    prevs = []
    for i in range(nc):
        prevs.append(prev)
        prev = states_c[i] + decays[i] * prev
    prev_states = torch.stack(prevs, dim=1)                         # (B,C,H,P,N)

    # 4) cross-chunk contribution: c · prev_state, times the decay from the
    #    chunk's start
    ch = cc.permute(0, 1, 3, 2, 4)[:, :, :, None]                   # (B,C,G,1,L,N)
    y_off = torch.matmul(ch, prev_states.reshape(bsz, nc, g, hpg, p, n).transpose(-1, -2))
    y_off = y_off.reshape(bsz, nc, h, chunk, p) * torch.exp(a_cum)[..., None]

    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p)
    return y, prev


def ssd_step(state, x, a, b, c):
    """One-token recurrence. state: (B,H,P,N); x: (B,H,P); a: (B,H); b,c: (B,G,N)."""
    h = x.shape[1]
    hpg = h // b.shape[1]
    bh = torch.repeat_interleave(b, hpg, dim=1)                     # (B,H,N)
    ch = torch.repeat_interleave(c, hpg, dim=1)
    decay = torch.exp(a)[..., None, None].to(state.dtype)
    new_state = state * decay + x[..., :, None] * bh[..., None, :]
    y = torch.matmul(new_state, ch[..., None])[..., 0]
    return y, new_state


def _split_proj(z: torch.Tensor, cfg: ModelConfig, heads: int | None = None):
    """z, x, B, C and dt of ``in_proj``'s output, for ``heads`` heads (all
    of them by default; a rank's on a mesh: its z, x and dt, B and C
    whole)."""
    h = num_ssm_heads(cfg) if heads is None else heads
    di, gn = h * cfg.ssm_head_dim, cfg.ssm_groups * cfg.ssm_state
    return torch.split(z, [di, di, gn, gn, h], dim=-1)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, *, mesh=None,
                width: int | None = None) -> torch.Tensor:
    """The gated RMS norm over the last dim; on a ``mesh`` ``y`` and ``z``
    are this rank's columns of a dim ``width`` wide, whose mean square is
    the ranks' sums of squares summed over ``model``
    (``collectives.norm_stat``) over ``width``."""
    yf = (y * F.silu(z.float()).to(y.dtype)).float()
    if mesh is None:
        var = (yf ** 2).mean(-1, keepdim=True)
    else:
        var = collectives.norm_stat((yf ** 2).sum(-1, keepdim=True), mesh, "model") / width
    return (yf * torch.rsqrt(var + 1e-6) * scale.float()).to(y.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def rank_groups(t: torch.Tensor, split, cfg: ModelConfig) -> torch.Tensor:
    """B or C, ``(..., G, N)`` with every group (whole on every rank), cut
    to the groups the rank's heads ``split`` read, in an order the SSD's
    ``h // G`` heads a group reads right: whole groups where the rank's
    heads are whole groups, the one group they share where they lie in one,
    else one group a head."""
    hpg = num_ssm_heads(cfg) // cfg.ssm_groups
    lo, n, dim = split.lo, split.n, t.dim() - 2
    if n % hpg == 0:
        return t.narrow(dim, lo // hpg, n // hpg)
    if hpg % n == 0:
        return t.narrow(dim, lo // hpg, 1)
    return t.index_select(dim, torch.arange(lo, lo + n, device=t.device) // hpg)


def mamba2_fwd(p: dict, u: torch.Tensor, cfg: ModelConfig, *, state=None, conv_state=None,
               decode: bool = False, mesh=None):
    """u: (B, S, d_model). With ``decode``, S == 1 and (state, conv_state)
    are required.  Returns (out, (state, conv_state)).

    On a ``mesh`` whose ``model`` axis splits the SSM heads
    (``ssm_split``), ``p`` holds this rank's columns
    (``layout``: its z, x and dt, B and C whole) and the layer
    is tensor-parallel: ``u`` enters through ``collectives.enter`` with
    the B and C columns of ``in_proj``, ``conv_w`` and ``conv_b`` (their
    gradients are the ranks' heads' partials, summed over ``model``), the
    SSD runs on the rank's heads against the groups they read
    (``rank_groups``), the gated norm's statistic is summed over ``model``
    and ``out_proj`` is row-parallel, its partials summed by one
    ``collectives.combine``.  The states are the rank's heads' and its conv
    columns."""
    cd = cfg.cdtype
    bsz, s, _ = u.shape
    split = ssm_split(cfg, mesh)
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = num_ssm_heads(cfg) if split is None else split.n
    pdim = cfg.ssm_head_dim
    di, gn = h * pdim, g * n
    w_in, w_conv, b_conv = p["in_proj"], p["conv_w"], p["conv_b"]
    if split is not None:
        bc_in, bc_conv = ((2 * di, 2 * di + 2 * gn),), ((di, di + 2 * gn),)
        u, w_in, w_conv, b_conv = collectives.enter(
            [u, w_in, w_conv, b_conv], mesh, "model", cols=(None, bc_in, bc_conv, bc_conv))

    z = u.to(cd) @ w_in.to(cd)
    zs, xs, bs, cs, dts = _split_proj(z, cfg, h)
    conv_in = torch.cat([xs, bs, cs], dim=-1)                       # (B,S,conv_dim)

    w = w_conv.to(cd)                                               # (W, conv_dim)
    if decode:
        # conv_state: (B, W-1, conv_dim) holding the last W-1 inputs
        window = torch.cat([conv_state.to(cd), conv_in], dim=1)     # (B,W,conv)
        conv_out = torch.einsum("bwc,wc->bc", window, w)[:, None, :]
        new_conv_state = window[:, 1:, :]
    else:
        pad = F.pad(conv_in, (0, 0, CONV_WIDTH - 1, 0))
        conv_out = sum(pad[:, i:i + s, :] * w[i][None, None, :] for i in range(CONV_WIDTH))
        new_conv_state = pad[:, pad.shape[1] - (CONV_WIDTH - 1):, :]
    conv_out = F.silu(conv_out + b_conv.to(cd))

    xs, bs, cs = torch.split(conv_out, [di, gn, gn], dim=-1)
    x4 = xs.reshape(bsz, s, h, pdim)
    b4 = bs.reshape(bsz, s, g, n)
    c4 = cs.reshape(bsz, s, g, n)
    if split is not None:
        b4, c4 = rank_groups(b4, split, cfg), rank_groups(c4, split, cfg)

    dt = _softplus(dts.float() + p["dt_bias"].float())
    a = (-torch.exp(p["A_log"].float()))[None, None, :] * dt        # (B,S,H)

    xdt = x4 * dt.to(cd)[..., None]
    if decode:
        y, new_state = ssd_step(state, xdt[:, 0], a[:, 0].to(cd), b4[:, 0], c4[:, 0])
        y = y[:, None]
    else:
        y, new_state = ssd_chunked(xdt, a.to(cd), b4, c4, initial_state=state)

    y = y + x4 * p["D"].to(cd)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = _gated_norm(y, zs, p["norm_scale"], mesh=None if split is None else mesh,
                    width=d_inner(cfg))
    out = y @ p["out_proj"].to(cd)
    if split is not None:
        out = collectives.combine(out, mesh, "model")
    return out, (new_state, new_conv_state)


def ssm_state_shapes(cfg: ModelConfig, batch: int, mesh=None) -> tuple[tuple, tuple]:
    """The shapes of (state, conv_state) for ``batch`` rows: (B, H, P, N)
    and (B, W-1, conv_dim); on a ``mesh`` the rank's heads
    (``ssm_split``) and its conv columns (its x, B and C whole)."""
    split = ssm_split(cfg, mesh)
    h = num_ssm_heads(cfg) if split is None else split.n
    pdim, n = cfg.ssm_head_dim, cfg.ssm_state
    return ((batch, h, pdim, n), (batch, CONV_WIDTH - 1, h * pdim + 2 * cfg.ssm_groups * n))


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=None, *, device=None, mesh=None):
    """Zero (state, conv_state) of ``ssm_state_shapes``."""
    from repro_torch import device as device_mod

    dtype = dtype or cfg.cdtype
    dev = device_mod.resolve(device)
    return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                 for shape in ssm_state_shapes(cfg, batch, mesh))
