"""xLSTM blocks (port of ``repro.models.xlstm``): mLSTM (matrix memory,
chunkwise-parallel) and sLSTM (scalar memory, strictly recurrent with a
block-diagonal recurrence).

mLSTM is the stabilized exponential-gating form (Beck et al. 2024):
    C_t = f_t C_{t-1} + i_t k_t ⊗ v_t,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (q_t C_t) / max(|n_t · q_t|, exp(-m_t)),
computed chunkwise: parallel within a chunk (the decay matrix D), the state
carried across chunks by a loop over them.  C is laid out (d_k, d_v) in
both the chunked form and the one-token step.  A training forward starts
the stabilizer ``m`` at -inf, ``init_xlstm_state`` at -1e30; both give
finite outputs.

sLSTM is sequential: its gates mix the previous hidden state through
recurrent weights, so it is a loop over time, one step a token.  Each step
is one batched product for the four gates' recurrent part (the input part
added in the same call) and the elementwise gate update; neither package
has a kernel for it.  Everything here is plain torch; on a card without
autograd the loop's blocks of ``GRAPH_STEPS`` steps are replayed as CUDA
graphs of the same operations.

The 12 layers are unrolled (``params["blocks"]`` is a list of
heterogeneous dicts, as ``repro``'s); every ``slstm_every``-th block is an
sLSTM block.  The tokens go through ``transformer.embed_tokens`` (K8 for a
QR vocabulary on the card) and the tied head through
``transformer.lm_logits``.

On a mesh the mLSTM blocks run tensor-parallel by head and the sLSTM
blocks' gated FFN by hidden unit (``block_layout``); the sLSTM's
recurrence, and its CUDA graphs, run whole on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import qr_embedding
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import bounds
from repro_torch.models import transformer as T
from repro_torch.models.layers import _normal, apply_norm, init_norm

MLSTM_CHUNK = 128
MLSTM_PF = 2          # mLSTM block projection factor
SLSTM_PF = 4 / 3      # sLSTM block FFN projection factor
# sLSTM steps one CUDA graph replays when serving on a card: an eager step is
# 16 launches whose host cost, not the device, sets the pace of the loop
GRAPH_STEPS = 64


# ---------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel with a stabilizer
# ---------------------------------------------------------------------------

def mlstm_chunked(q, k, v, i_pre, f_pre, *, state=None, chunk: int = MLSTM_CHUNK):
    """q, k, v: (B, H, S, D); i_pre, f_pre: (B, H, S).  Returns (h, state).

    state = (C, n, m): (B, H, D, D), (B, H, D), (B, H), the stabilized
    matrix memory, normalizer and max-log-scale, in fp32.
    """
    bsz, h, s, d = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk} "
                         f"(chunk = min({MLSTM_CHUNK}, S) must divide S)")
    nc = s // chunk
    scale = d ** -0.5
    dev = q.device

    logf = F.logsigmoid(f_pre.float())                               # (B,H,S)
    logi = i_pre.float()

    if state is None:
        C = torch.zeros((bsz, h, d, d), dtype=torch.float32, device=dev)
        n = torch.zeros((bsz, h, d), dtype=torch.float32, device=dev)
        m = torch.full((bsz, h), -math.inf, dtype=torch.float32, device=dev)
    else:
        C, n, m = state

    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()

    def one(ci, C, n, m):
        part = slice(ci * chunk, (ci + 1) * chunk)
        qt, kt, vt = q[:, :, part], k[:, :, part], v[:, :, part]
        lft, lit = logf[..., part], logi[..., part]
        b = torch.cumsum(lft, dim=-1)                                # (B,H,L) inclusive
        # decay matrix: D[t, s] = b_t - b_s + logi_s (s <= t)
        D = (b[..., :, None] - b[..., None, :] + lit[..., None, :]).masked_fill(~tri, -math.inf)
        m_intra = D.amax(-1)                                         # (B,H,L)
        m_inter = b + m[..., None]                                   # (B,H,L)
        m_t = torch.clamp(torch.maximum(m_intra, m_inter), min=-1e30)

        W = torch.exp(D - m_t[..., None])                            # (B,H,L,L)
        scores = torch.matmul(qt, kt.transpose(-1, -2)).float() * scale
        gated = W * scores
        num = torch.matmul(gated, vt.float())
        den = gated.sum(-1)                                          # (B,H,L)

        inter_scale = torch.exp(m_inter - m_t)                       # (B,H,L)
        qf = qt.float() * scale
        num = num + inter_scale[..., None] * torch.matmul(qf, C)
        den = den + inter_scale * torch.matmul(qf, n[..., None])[..., 0]
        out = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

        # the state to the end of the chunk
        bL = b[..., -1]                                              # (B,H)
        g = bL[..., None] - b + lit                                  # (B,H,L) decay to end
        m_new = torch.clamp(torch.maximum(bL + m, g.amax(-1)), min=-1e30)
        carry = torch.exp(bL + m - m_new)                            # (B,H)
        gw = torch.exp(g - m_new[..., None])                         # (B,H,L)
        kw = kt.float() * gw[..., None]
        C = C * carry[..., None, None] + torch.matmul(kw.transpose(-1, -2), vt.float())
        n = n * carry[..., None] + kw.sum(-2)
        return out, C, n, m_new

    if dev.type == "meta" and nc > 1 and not torch.is_grad_enabled():
        # the dry run without autograd: the first chunk alone, the others'
        # outputs allocated before it (the loop's peak is its last chunk's,
        # over all the outputs before it) and their products counted as the
        # first's.  Under autograd every chunk runs: each keeps its saved
        # tensors for the backward
        outs = [q.new_empty((bsz, h, chunk, d), dtype=torch.float32) for _ in range(nc - 1)]
        out, C, n, m = bounds.meta_repeats("mlstm_chunks", nc - 1, lambda: one(0, C, n, m))
        outs.append(out)
    else:
        outs = []
        for ci in range(nc):
            out, C, n, m = one(ci, C, n, m)
            outs.append(out)
    h_out = torch.cat(outs, dim=2)
    return h_out.to(v.dtype), (C, n, m)


def mlstm_step(state, q, k, v, i_pre, f_pre):
    """One-token recurrence. q, k, v: (B, H, D); i_pre, f_pre: (B, H)."""
    C, n, m = state
    d = q.shape[-1]
    scale = d ** -0.5
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.clamp(torch.maximum(logf + m, logi), min=-1e30)
    fs = torch.exp(logf + m - m_new)[..., None]
    is_ = torch.exp(logi - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C_new = C * fs[..., None] + is_[..., None] * kf[..., :, None] * vf[..., None, :]
    n_new = n * fs + is_ * kf
    qf = q.float() * scale
    num = torch.matmul(qf[..., None, :], C_new)[..., 0, :]
    den = (qf * n_new).sum(-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(v.dtype), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# sLSTM cell: a loop over time with a block-diagonal recurrence
# ---------------------------------------------------------------------------

def _slstm_step(xt, c, n, hh, m, rw, zero):
    """One sLSTM step on head-major (H, B, D) states: xt (H, B, 4D) the
    input gates, rw (H, D, 4D) the recurrent weights, ``zero`` zeros like
    the state.  The three exponentials of a step are one ``exp`` of the
    stacked (i, log f + m, 0) less the new stabilizer, and the two
    multiply-adds ``addcmul``: 16 launches a step.  -> (the gates'
    pre-activations, c, n, h, m)."""
    pre = torch.baddbmm(xt, hh, rw)                                  # (H,B,4D)
    i_pre, f_pre, z_pre, o_pre = pre.split(rw.shape[1], dim=-1)
    logf_m = F.logsigmoid(f_pre) + m
    m_new = torch.maximum(logf_m, i_pre)
    i_, f_, floor = torch.exp(torch.stack((i_pre, logf_m, zero)) - m_new)
    c = torch.addcmul(f_ * c, i_, torch.tanh(z_pre))
    n = torch.maximum(torch.addcmul(i_, f_, n), floor)
    hh = torch.sigmoid(o_pre) * c / n
    return pre, c, n, hh, m_new


def _max_weight(x, y):
    """The share of ``maximum(x, y)``'s gradient that goes to x: 1 where
    x > y, 1/2 at a tie (autograd's and ``jax.numpy.maximum``'s rule)."""
    return (x > y).to(x.dtype) + 0.5 * (x == y).to(x.dtype)


def _slstm_step_grad(pre, c0, n0, m0, c, n, m, hh, g, dc, dn, dm, rw_t, zero):
    """The step's backward: ``pre`` its gates' pre-activations, (c0, n0,
    m0) the state it read, (c, n, m, hh) the one it wrote, ``g`` the
    gradient of its h (its output's and the next step's), (dc, dn, dm)
    those of the state it wrote; ``rw_t`` (H, 4D, D).  The gates are
    recomputed from ``pre`` by ``_slstm_step``'s operations.  -> (the
    gradient of ``pre`` (H, B, 4D), those of h, c, n and m it read)."""
    d = rw_t.shape[-1]
    i_pre, f_pre, z_pre, o_pre = pre.split(d, dim=-1)
    a = F.logsigmoid(f_pre) + m0
    i_, f_, floor = torch.exp(torch.stack((i_pre, a, zero)) - m)
    z, o = torch.tanh(z_pre), torch.sigmoid(o_pre)
    q = g / n                                     # h = o c / n
    dc = dc + q * o
    dn = dn - q * hh
    du = dn * _max_weight(torch.addcmul(i_, f_, n0), floor)   # n = max(f n0 + i, exp(-m))
    df = du * n0 + dc * c0
    di_pre = (du + dc * z) * i_
    da = df * f_
    dm = dm - di_pre - da - (dn - du) * floor
    wa = _max_weight(a, i_pre)                    # m = max(log f + m0, i)
    da = da + dm * wa
    dpre = torch.cat((di_pre + dm * (1 - wa), da * torch.sigmoid(-f_pre),
                      dc * i_ * (1 - z * z), q * c * o * (1 - o)), dim=-1)
    return dpre, torch.bmm(dpre, rw_t), dc * f_, du * f_, da


def _blocks(s: int, k: int):
    """The step ranges of a scan of ``s`` steps: whole blocks of ``k``,
    then the rest."""
    full = s - s % k
    return [(lo, lo + k) for lo in range(0, full, k)] + ([(full, s)] if full < s else [])


def _replayed(run_block, static_in: list, static_out: list, pieces, k: int):
    """``run_block()`` over each (inputs, outputs) of ``pieces`` in turn:
    the inputs copied into ``static_in`` and ``static_out`` copied out after
    it.  The first block runs eagerly on a side stream (it warms the
    libraries up), the next ones replay one CUDA graph of ``run_block``; a
    piece shorter than ``k`` runs eagerly on its own buffers."""
    graph = None
    for ins, outs in pieces:
        if ins[0].shape[0] != k:
            run_block(ins, outs)
            continue
        for dst, src in zip(static_in, ins):
            dst.copy_(src)
        if graph is None:
            dev = static_in[0].device
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run_block(static_in, static_out)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run_block(static_in, static_out)
        else:
            graph.replay()
        for dst, src in zip(outs, static_out):
            dst.copy_(src)


def _meta_steps(pieces: list, seq: torch.Tensor, state_shape) -> list:
    """``pieces`` (a scan's (inputs, outputs) blocks over ``seq``'s steps),
    or on meta (the dry run) the first piece cut to one step: every step
    allocates the same temporaries and writes into outputs allocated before
    the loop, so one step gives the scan's peak; the products of the steps
    it leaves out, one (H, B, D) x (D, 4D) a step, are counted under
    ``slstm_steps`` in ``kernels.bounds.META``."""
    if seq.device.type != "meta" or not pieces:
        return pieces
    h, b, d = state_shape
    bounds.meta_call("slstm_steps", (seq.shape[0] - 1) * 2 * h * b * d * 4 * d, 0)
    ins, outs = pieces[0]
    return [([t[:1] for t in ins], [t[:1] for t in outs])]


def _scan_forward(xg, rw, state: tuple, *, save: bool, graphs: bool):
    """The steps of ``xg`` (S, H, B, 4D) from ``state`` (c, n, h, m), each
    (H, B, D), without autograd.  -> (h (S, H, B, D), the final state,
    with ``save`` each step's (pre, c, n, m) for the backward).  With
    ``graphs`` the loop's blocks of ``GRAPH_STEPS`` steps are replayed as
    CUDA graphs (``_replayed``): the same kernels in the same order as the
    eager loop, the same values bit for bit, the host's per-operation cost
    paid once a block instead of once a step."""
    s = xg.shape[0]
    k = GRAPH_STEPS if graphs else max(s, 1)
    zero = torch.zeros_like(state[0])
    carry = [t.clone() for t in state]
    hs = xg.new_empty((s, *state[0].shape))
    kept = [xg.new_empty(xg.shape)] + [xg.new_empty(hs.shape) for _ in range(3)] if save else []

    def run_block(ins, outs):
        st = tuple(carry)
        for t in range(ins[0].shape[0]):
            pre, *st = _slstm_step(ins[0][t], *st, rw, zero)
            outs[0][t].copy_(st[2])
            for buf, v in zip(outs[1:], (pre, st[0], st[1], st[3])):
                buf[t].copy_(v)
        for dst, src in zip(carry, st):
            dst.copy_(src)

    pieces = [([xg[lo:hi]], [hs[lo:hi]] + [b[lo:hi] for b in kept]) for lo, hi in _blocks(s, k)]
    pieces = _meta_steps(pieces, xg, state[0].shape)
    if graphs:
        static_out = [hs[:k].clone()] + [b[:k].clone() for b in kept]
        _replayed(run_block, [xg[:k].clone()], static_out, pieces, k)
    else:
        for ins, outs in pieces:
            run_block(ins, outs)
    return hs, tuple(carry), kept


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM scan with its backward written out (``_slstm_step_grad``, a
    loop over time in reverse) instead of autograd's graph of ~16 nodes a
    step; both loops replayed as CUDA graphs on a card.  Inputs: xg (S, H,
    B, 4D), rw (H, D, 4D), the initial (c, n, h, m); outputs: h (S, H, B,
    D) and the final (c, n, h, m)."""

    @staticmethod
    def forward(ctx, xg, rw, c0, n0, h0, m0, graphs):
        hs, st, kept = _scan_forward(xg, rw, (c0, n0, h0, m0), save=True, graphs=graphs)
        ctx.graphs = graphs
        ctx.save_for_backward(rw, c0, n0, h0, m0, hs, *kept)
        return (hs, *st)

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        rw, c0, n0, h0, m0, hs, pre, c, n, m = ctx.saved_tensors
        s, h, b, d = hs.shape
        rw_t = rw.transpose(1, 2).contiguous()                       # (H, 4D, D)
        zero = torch.zeros_like(c0)
        dhs = torch.zeros_like(hs) if dhs is None else dhs.clone()
        if dh is not None:
            dhs[-1] += dh                        # the final h is the last output
        carry = [torch.zeros_like(c0) if t is None else t.clone()
                 for t in (None, dc, dn, dm)]                         # h, c, n, m
        prev = [torch.cat((t0[None], t[:-1])) for t0, t in ((c0, c), (n0, n), (m0, m))]
        dpre = torch.empty_like(pre)

        def run_block(ins, outs):
            p, c_0, n_0, m_0, c_, n_, m_, h_, g = ins
            dh_, dc_, dn_, dm_ = carry
            for t in reversed(range(p.shape[0])):
                dp, dh_, dc_, dn_, dm_ = _slstm_step_grad(
                    p[t], c_0[t], n_0[t], m_0[t], c_[t], n_[t], m_[t], h_[t], g[t] + dh_,
                    dc_, dn_, dm_, rw_t, zero)
                outs[0][t].copy_(dp)
            for dst, src in zip(carry, (dh_, dc_, dn_, dm_)):
                dst.copy_(src)

        k = GRAPH_STEPS if ctx.graphs else max(s, 1)
        seqs = (pre, *prev, c, n, m, hs, dhs)
        pieces = [([t[lo:hi] for t in seqs], [dpre[lo:hi]]) for lo, hi in reversed(_blocks(s, k))]
        pieces = _meta_steps(pieces, pre, c0.shape)
        if ctx.graphs:
            _replayed(run_block, [t[:k].clone() for t in seqs], [dpre[:k].clone()], pieces, k)
        else:
            for ins, outs in pieces:
                run_block(ins, outs)
        h_prev = torch.cat((h0[None], hs[:-1]))                      # (S, H, B, D)
        drw = torch.bmm(h_prev.permute(1, 3, 0, 2).reshape(h, d, s * b),
                        dpre.permute(1, 0, 2, 3).reshape(h, s * b, 4 * d))
        return dpre, drw, carry[1], carry[2], carry[0], carry[3], None


def slstm_scan(x_gates, r_weights, *, state=None, graphs: bool | None = None):
    """x_gates: (B, S, H, 4, D) input contributions for (i, f, z, o);
    r_weights: (H, 4, D, D) recurrent block-diagonal weights.  Returns
    (h (B, S, H, D) fp32, state (c, n, h, m) each (B, H, D) fp32).

    The state is carried head-major, (H, B, D), so each step's recurrent
    part is one ``baddbmm`` of the step's input gates (H, B, 4D) with
    h (H, B, D) @ R (H, D, 4D).  Under autograd the scan is one
    ``_SLSTMScan`` (its backward a loop written out); ``graphs`` (by
    default: on a card, over more than ``GRAPH_STEPS`` steps) replays the
    loops' blocks as CUDA graphs."""
    bsz, s, h, _, d = x_gates.shape
    dev = x_gates.device
    if state is None:
        c = torch.zeros((h, bsz, d), dtype=torch.float32, device=dev)
        n = torch.ones((h, bsz, d), dtype=torch.float32, device=dev)
        hh = torch.zeros((h, bsz, d), dtype=torch.float32, device=dev)
        m = torch.zeros((h, bsz, d), dtype=torch.float32, device=dev)
        st = (c, n, hh, m)
    else:
        st = tuple(t.float().transpose(0, 1).contiguous() for t in state)
    rw = r_weights.float().permute(0, 2, 1, 3).reshape(h, d, 4 * d)   # (H, D, 4D): [g, e]
    xg = x_gates.float().permute(1, 2, 0, 3, 4).reshape(s, h, bsz, 4 * d)
    if graphs is None:
        graphs = dev.type == "cuda" and s > GRAPH_STEPS
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xg, rw, *st)):
        hs, *st = _SLSTMScan.apply(xg, rw, *st, graphs)
    else:
        hs, st, _ = _scan_forward(xg, rw, st, save=False, graphs=graphs)
    return hs.permute(2, 0, 1, 3), tuple(t.transpose(0, 1) for t in st)     # (B,S,H,D)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def init_mlstm_block(cfg: ModelConfig, *, generator: torch.Generator, device):
    d = cfg.d_model
    di = MLSTM_PF * d
    h = cfg.num_heads
    pd = cfg.pdtype
    kw = dict(generator=generator, device=device)
    s_in, s_i = 1.0 / math.sqrt(d), 1.0 / math.sqrt(di)
    params = {
        "ln": init_norm("rms", d, pd, device=device)[0],
        "up": _normal((d, 2 * di), pd, scale=s_in, **kw),
        "wq": _normal((di, di), pd, scale=s_i, **kw),
        "wk": _normal((di, di), pd, scale=s_i, **kw),
        "wv": _normal((di, di), pd, scale=s_i, **kw),
        "wi": _normal((di, h), pd, scale=s_i, **kw),
        "wf": _normal((di, h), pd, scale=s_i, **kw),
        "f_bias": torch.full((h,), 3.0, dtype=pd, device=device),
        "out_norm": torch.ones((di,), dtype=pd, device=device),
        "down": _normal((di, d), pd, scale=1.0 / math.sqrt(di * 2 * max(cfg.num_layers, 1)),
                        **kw),
    }
    axes = {
        "ln": {"scale": ("embed",)},
        "up": ("embed", "ffn"), "wq": ("ffn", "ffn"), "wk": ("ffn", "ffn"),
        "wv": ("ffn", "ffn"), "wi": ("ffn", None), "wf": ("ffn", None),
        "f_bias": (None,), "out_norm": ("ffn",), "down": ("ffn", "embed"),
    }
    return params, axes


def mlstm_block_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                    decode: bool = False, mesh=None):
    """On a ``mesh`` whose ``model`` axis splits the heads
    (``mlstm_split``) ``p`` holds this rank's columns
    (``block_layout``) and the block is tensor-parallel: the normed
    input enters through ``collectives.enter`` with ``up``'s xm half (whole
    on every rank; its gradient the ranks' heads' partials, summed), the
    cell runs on the rank's heads and state, the output norm's statistic is
    summed over ``model`` and ``down`` is row-parallel (one
    ``collectives.combine``)."""
    cd = cfg.cdtype
    bsz, s, d = x.shape
    di = MLSTM_PF * d
    hd = di // cfg.num_heads
    split = mlstm_split(cfg, mesh)
    h = cfg.num_heads if split is None else split.n
    xin = apply_norm(p["ln"], x)
    w_up = p["up"]
    if split is not None:
        xin, w_up = collectives.enter([xin, w_up], mesh, "model", cols=(None, ((0, di),)))
    up = xin.to(cd) @ w_up.to(cd)
    xm, z = up[..., :di], up[..., di:]

    def heads(w):
        return (xm @ p[w].to(cd)).reshape(bsz, s, h, hd).transpose(1, 2)

    q, k, v = heads("wq"), heads("wk"), heads("wv")
    i_pre = (xm @ p["wi"].to(cd)).transpose(1, 2)                    # (B,H,S)
    f_pre = (xm @ p["wf"].to(cd)).transpose(1, 2) + p["f_bias"].to(cd)[None, :, None]

    if decode:
        hout, new_state = mlstm_step(state, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                     i_pre[:, :, 0], f_pre[:, :, 0])
        hout = hout[:, :, None, :]
    else:
        hout, new_state = mlstm_chunked(q, k, v, i_pre, f_pre, state=state)

    hout = hout.transpose(1, 2).reshape(bsz, s, h * hd)
    # per-block norm, then the output gate
    hf = hout.float()
    if split is None:
        var = (hf ** 2).mean(-1, keepdim=True)
    else:
        var = collectives.norm_stat((hf ** 2).sum(-1, keepdim=True), mesh, "model") / di
    hout = (hf * torch.rsqrt(var + 1e-6) * p["out_norm"].float()).to(cd)
    hout = hout * F.silu(z)
    y = hout @ p["down"].to(cd)
    if split is not None:
        y = collectives.combine(y, mesh, "model")
    return x + y.to(x.dtype), new_state


def init_slstm_block(cfg: ModelConfig, *, generator: torch.Generator, device):
    d = cfg.d_model
    h = cfg.num_heads
    hd = d // h
    f = slstm_ffn_width(cfg)
    pd = cfg.pdtype
    kw = dict(generator=generator, device=device)
    s_in = 1.0 / math.sqrt(d)
    bias = torch.zeros((h, 4, hd), dtype=torch.float32, device=device)
    bias[:, 1] = 3.0
    params = {
        "ln": init_norm("rms", d, pd, device=device)[0],
        "w_gates": _normal((d, h, 4, hd), pd, scale=s_in, **kw),
        "r_gates": _normal((h, 4, hd, hd), pd, scale=1.0 / math.sqrt(hd), **kw),
        "gate_bias": bias.to(pd),
        "ln2": init_norm("rms", d, pd, device=device)[0],
        "ffn_up": _normal((d, 2 * f), pd, scale=s_in, **kw),
        "ffn_down": _normal((f, d), pd, scale=1.0 / math.sqrt(f * 2 * max(cfg.num_layers, 1)),
                            **kw),
    }
    axes = {
        "ln": {"scale": ("embed",)},
        "w_gates": ("embed", None, None, None),
        "r_gates": (None, None, None, None),
        "gate_bias": (None, None, None),
        "ln2": {"scale": ("embed",)},
        "ffn_up": ("embed", "ffn"),
        "ffn_down": ("ffn", "embed"),
    }
    return params, axes


def slstm_block_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                    decode: bool = False, mesh=None):
    """``decode`` changes nothing: a decode step is the scan over one token.
    On a ``mesh`` whose ``model`` axis splits the FFN's hidden units
    (``slstm_ffn_split``) the recurrence runs whole on every rank
    and the gated FFN tensor-parallel: its normed input enters, ``ffn_up``
    holds the rank's block of the gate half and of the up half, and
    ``ffn_down`` is row-parallel (one ``collectives.combine``)."""
    cd = cfg.cdtype
    bsz, s, d = x.shape
    h = cfg.num_heads
    hd = d // h
    xin = apply_norm(p["ln"], x)
    gates = (xin.to(cd) @ p["w_gates"].to(cd).reshape(d, 4 * d)).reshape(bsz, s, h, 4, hd)
    gates = gates + p["gate_bias"].to(cd)[None, None]
    hs, new_state = slstm_scan(gates, p["r_gates"], state=state)
    x = x + hs.reshape(bsz, s, d).to(cd).to(x.dtype)
    # gated FFN
    split = slstm_ffn_split(cfg, mesh)
    xin2 = apply_norm(p["ln2"], x)
    if split is not None:
        [xin2] = collectives.enter([xin2], mesh, "model")
    up = xin2.to(cd) @ p["ffn_up"].to(cd)
    f = up.shape[-1] // 2
    y = F.silu(up[..., :f]) * up[..., f:]
    y = y @ p["ffn_down"].to(cd)
    if split is not None:
        y = collectives.combine(y, mesh, "model")
    return x + y.to(x.dtype), new_state


def is_slstm_layer(cfg: ModelConfig, i: int) -> bool:
    return cfg.slstm_every > 0 and (i % cfg.slstm_every) == (cfg.slstm_every - 1)


def slstm_ffn_width(cfg: ModelConfig) -> int:
    """The hidden units of an sLSTM block's gated FFN."""
    return int(SLSTM_PF * cfg.d_model)


def mlstm_split(cfg: ModelConfig, mesh, axis: str = "model") -> SH.BlockSplit | None:
    """This rank's heads of an mLSTM block (``cfg.num_heads``), or None
    where the block runs replicated (``sharding.block_split``)."""
    return SH.block_split(cfg.num_heads, mesh, axis)


def slstm_ffn_split(cfg: ModelConfig, mesh, axis: str = "model") -> SH.BlockSplit | None:
    """This rank's hidden units of an sLSTM block's gated FFN
    (``slstm_ffn_width``), or None where the FFN runs replicated.  The
    recurrence (``w_gates``, ``r_gates``, ``gate_bias``) is whole on every
    rank, as in ``repro``, where ``embed`` is its only named dim."""
    return SH.block_split(slstm_ffn_width(cfg), mesh, axis)


def block_layout(cfg: ModelConfig, mesh, slstm: bool, axis: str = "model") -> dict:
    """The spec of each split leaf of one block on ``mesh`` (the others
    whole).  mLSTM by the rank's heads (``mlstm_split``): ``up``'s columns
    its xm half whole, then its block of the z half; ``wq`` / ``wk`` /
    ``wv`` / ``wi`` / ``wf``'s columns, ``f_bias`` and ``out_norm`` its
    heads; ``down``'s rows the same block.  sLSTM (``slstm_ffn_split``):
    ``ffn_up``'s columns its block of the gate half, then of the up half;
    ``ffn_down``'s rows that block."""
    if slstm:
        if slstm_ffn_split(cfg, mesh, axis) is None:
            return {"ffn_up": SH.P(), "ffn_down": SH.P()}
        f = slstm_ffn_width(cfg)
        return {"ffn_up": SH.P(None, SH.Parts(axis, ((f, True), (f, True)))),
                "ffn_down": SH.P(axis, None)}
    names = ("up", "wq", "wk", "wv", "wi", "wf", "f_bias", "out_norm", "down")
    if mlstm_split(cfg, mesh, axis) is None:
        return {k: SH.P() for k in names}
    di = 2 * cfg.d_model
    cols = SH.P(None, axis)
    return {"up": SH.P(None, SH.Parts(axis, ((di, False), (di, True)))), "wq": cols,
            "wk": cols, "wv": cols, "wi": cols, "wf": cols, "f_bias": SH.P(axis),
            "out_norm": SH.P(axis), "down": SH.P(axis, None)}


def mesh_axes(cfg: ModelConfig, axes: dict, mesh) -> dict:
    """``init_xlstm``'s axes with each block's split leaves given their
    specs on ``mesh`` outright (``block_layout``: a contiguous block of the
    fused ``up`` or ``ffn_up`` is not the rank's columns), each ``embed``
    dim left to the rules (``sharding.given``: FSDP over ``data`` in
    training)."""
    blocks = []
    for i, a in enumerate(axes["blocks"]):
        lay = block_layout(cfg, mesh, is_slstm_layer(cfg, i))
        blocks.append({k: SH.given(lay[k], a[k]) if k in lay else a[k] for k in a})
    return dict(axes, blocks=blocks)


# ---------------------------------------------------------------------------
# the model (unrolled layers)
# ---------------------------------------------------------------------------

def init_xlstm(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random params and their logical axes, ``(params, axes)``: ``embed``,
    ``blocks`` (a list, an sLSTM block's dict where ``is_slstm_layer``) and
    ``final_norm``; drawn from a ``torch.Generator`` seeded with ``seed`` on
    the target device (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    g = device_mod.generator(dev)
    g.manual_seed(seed)
    kw = dict(generator=g, device=dev)
    params = {"embed": qr_embedding.init(cfg.emb_config, **kw)}
    axes = {"embed": qr_embedding.param_axes(cfg.emb_config)}
    blocks, baxes = [], []
    for i in range(cfg.num_layers):
        init = init_slstm_block if is_slstm_layer(cfg, i) else init_mlstm_block
        p, a = init(cfg, **kw)
        blocks.append(p)
        baxes.append(a)
    params["blocks"], axes["blocks"] = blocks, baxes
    params["final_norm"], axes["final_norm"] = init_norm("rms", cfg.d_model, cfg.pdtype,
                                                         device=dev)
    return params, axes


# what the blocks cast to the compute dtype on every call (r_gates and the
# norms are read in fp32)
_SERVING_CAST = ("up", "wq", "wk", "wv", "wi", "wf", "f_bias", "down", "w_gates", "gate_bias",
                 "ffn_up", "ffn_down")


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with the vocabulary's tables and every block weight the
    forwards cast to the compute dtype cast once: the same logits bit for
    bit.  ``r_gates``, ``out_norm`` and the norms keep their dtype."""
    return T.cast_for_serving(params, cfg, _SERVING_CAST)


def init_xlstm_state(cfg: ModelConfig, batch: int, *, device=None, mesh=None) -> list:
    """Each layer's recurrent state, fp32: an sLSTM block's (c, n, h, m),
    each (B, H, D) with n at 1; an mLSTM block's (C, n, m), m at -1e30.  On
    a ``mesh`` (default the active one) this rank's block of the states of
    ``batch`` (global) sequences: its ``data`` block of them, an mLSTM
    block's heads it runs (``mlstm_split``; ``repro`` keeps the
    states replicated over ``model``), an sLSTM block's whole."""
    dev = device_mod.resolve(device)
    mesh = SH.current_mesh() if mesh is None else mesh
    rows = SH.batch_rows(batch, mesh)
    d, h = cfg.d_model, cfg.num_heads
    split = mlstm_split(cfg, mesh)
    hm = h if split is None else split.n
    kw = dict(dtype=torch.float32, device=dev)
    states = []
    for i in range(cfg.num_layers):
        if is_slstm_layer(cfg, i):
            hd = d // h
            states.append((torch.zeros((rows, h, hd), **kw), torch.ones((rows, h, hd), **kw),
                           torch.zeros((rows, h, hd), **kw), torch.zeros((rows, h, hd), **kw)))
        else:
            hd = MLSTM_PF * d // h
            states.append((torch.zeros((rows, hm, hd, hd), **kw),
                           torch.zeros((rows, hm, hd), **kw),
                           torch.full((rows, hm), -1e30, **kw)))
    return states


def forward_xlstm(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, states=None,
                  decode: bool = False, last: bool = False, mesh=None):
    """tokens: (B, S) -> (logits, states): each block's new state, in a new
    list.  With ``last`` the head runs on the last row only (logits
    (B, 1, vocab)).  On a ``mesh`` (default the active one,
    ``sharding.model_mesh``) ``params`` are this rank's blocks, ``tokens``
    its batch block and ``states`` its block: the tokens through the
    two-level GnR, the mLSTM blocks tensor-parallel by head, the sLSTM
    blocks' FFN by hidden unit; the logits are this rank's vocabulary slice
    in training (no states) and whole when serving."""
    mesh = SH.model_mesh(mesh)
    x = T.embed_tokens(params, tokens, cfg, mesh=mesh).to(cfg.cdtype)
    new_states = []
    for i, bp in enumerate(params["blocks"]):
        st = None if states is None else states[i]
        fwd = slstm_block_fwd if is_slstm_layer(cfg, i) else mlstm_block_fwd
        gather = SH.fsdp_layers("blocks", i)         # whole over ``data`` (FSDP)
        x, ns = fwd(bp if gather is None else gather(bp), x, cfg, state=st, decode=decode,
                    mesh=mesh)
        new_states.append(ns)
    x = apply_norm(SH.fsdp_take(params, "final_norm"), x)
    if last:
        x = x[:, -1:, :]
    head = T.lm_logits if states is None else T.whole_logits
    return head(params, x, cfg, mesh=mesh), new_states
