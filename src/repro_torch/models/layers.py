"""Shared layers (port of ``repro.models.layers``): dense projections,
norms, RoPE, GQA attention, MLPs, and the blockwise (flash-style)
attention in plain PyTorch.

Conventions, as ``repro``'s:

* every ``init_*`` returns ``(params, axes)``, parallel dicts of tensors and
  logical-axis tuples; the draws come from an explicit ``torch.Generator``
  on ``device``, so their numbers differ from ``jax.random``'s (the parity
  tests carry ``repro``'s params across with ``repro_torch.convert``);
* activations flow in ``cfg.cdtype`` (bf16), norms and softmax in fp32;
* ``attention``'s train/prefill branch goes through
  ``kernels.ops.flash_attention_fused``: the attention kernel K9 on CUDA
  tensors, its plain version on CPU tensors.  Its decode branch and
  ``decode_attention`` stay plain torch (plain jnp in ``repro``), and so do
  the matrix products (``torch.matmul``, as ``repro`` left them to XLA).

``flash_attention`` is what K9's backward recomputes through
(``kernels/flash_attention.py::flash_mha``), as ``repro``'s ``flash_mha``
differentiates ``layers.flash_attention``.  It never forms the (Sq, Skv)
score matrix: a Python loop over query blocks runs a loop over key blocks
with the online-softmax update, where ``repro`` scans.  The causal mask is
top-left aligned (query i sees key j iff i >= j), as in the kernel.

``repro``'s sharding constraints (``constrain``) have no counterpart in
the port: on a mesh (one process a rank) ``attention`` and ``mlp`` run
tensor-parallel over ``model`` on this rank's blocks, their input entering
through ``collectives.enter`` and their output combined by
``collectives.combine``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import tree
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normal(shape, dtype, generator: torch.Generator, device, scale: float) -> torch.Tensor:
    out = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return out.mul_(scale).to(dtype)


def init_dense(in_dim: int, out_dim: int, axes: tuple, *, dtype, generator, device,
               bias: bool = False, scale: float | None = None):
    scale = (1.0 / math.sqrt(in_dim)) if scale is None else scale
    p = {"w": _normal((in_dim, out_dim), dtype, generator, device, scale)}
    a = {"w": axes}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
        a["b"] = (axes[-1],)
    return p, a


def dense(p: dict, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype``: each weight is cast on every
    call, as ``repro`` does (a no-op on weights already in that type)."""
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(kind: str, dim: int, dtype, *, device):
    if kind == "rms":
        return {"scale": torch.ones((dim,), dtype=dtype, device=device)}, {"scale": ("embed",)}
    return (
        {"scale": torch.ones((dim,), dtype=dtype, device=device),
         "bias": torch.zeros((dim,), dtype=dtype, device=device)},
        {"scale": ("embed",), "bias": ("embed",)},
    )


def apply_norm(p: dict, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm where ``p`` has a bias, else RMSNorm; in fp32, cast back to
    x's dtype."""
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # RMSNorm
        var = (xf ** 2).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head q/k norm (qwen3)."""
    xf = x.float()
    var = (xf ** 2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
         partial_factor: float = 1.0) -> torch.Tensor:
    """Rotate-half RoPE on the first ``int(D * partial_factor)`` dims (made
    even) of the last dim.  x: (..., S, D); positions: (S,) or (B, S), whose
    angles take leading unit axes until they have x's rank (``repro``'s
    broadcast)."""
    d = x.shape[-1]
    rot = int(d * partial_factor)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs                     # (..., S, half)
    while ang.dim() < x_rot.dim():
        ang = ang[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# flash-style blockwise attention (plain torch; differentiable)
# ---------------------------------------------------------------------------


def _fit_block(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (block-shape fitting)."""
    b = min(target, n)
    while n % b:
        b -= 1
    return b


def _attn_block(q, k, v, m_prev, l_prev, acc_prev, *, bias, p_dtype=None):
    """One online-softmax update. q: (..., Bq, D); k/v: (..., Bk, D).

    ``p_dtype`` (e.g. ``torch.bfloat16``) stores the probability tile in
    that type; the row sum is taken from it widened back to fp32."""
    s = torch.matmul(q, k.transpose(-1, -2)).float()
    if bias is not None:
        s = s + bias
    m = torch.maximum(m_prev, s.amax(dim=-1))
    corr = torch.exp(m_prev - m)
    p = torch.exp(s - m[..., None])
    if p_dtype is not None:
        p = p.to(p_dtype)
        l = l_prev * corr + p.float().sum(dim=-1)
    else:
        l = l_prev * corr + p.sum(dim=-1)
    acc = acc_prev * corr[..., None] + torch.matmul(p.to(v.dtype), v).float()
    return m, l, acc


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                    q_block: int = 1024, kv_block: int = 1024, scale: float | None = None,
                    p_dtype=None) -> torch.Tensor:
    """Blockwise attention. q: (B, H, Sq, D); k/v: (B, KH, Skv, D); GQA via
    KH | H.  Returns (B, H, Sq, D) in v's dtype."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    q = (q * scale).reshape(b, kh, g, sq, d)

    q_block = _fit_block(sq, q_block)
    kv_block = _fit_block(skv, kv_block)
    nq, nk = sq // q_block, skv // kv_block

    outs = []
    for qi in range(nq):
        qtile = q[:, :, :, qi * q_block:(qi + 1) * q_block]          # (b, kh, g, Bq, d)
        m = torch.full((b, kh, g, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, kh, g, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, kh, g, q_block, d), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            ktile = k[:, :, None, ki * kv_block:(ki + 1) * kv_block]   # (b, kh, 1, Bk, d)
            vtile = v[:, :, None, ki * kv_block:(ki + 1) * kv_block]
            bias = None
            if causal:
                qpos = qi * q_block + torch.arange(q_block, device=q.device)
                kpos = ki * kv_block + torch.arange(kv_block, device=q.device)
                bias = torch.where(qpos[:, None] >= kpos[None, :], 0.0, NEG_INF)
            m, l, acc = _attn_block(qtile, ktile, vtile, m, l, acc, bias=bias,
                                    p_dtype=p_dtype)
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(v.dtype))
    return torch.cat(outs, dim=3).reshape(b, h, sq, d)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, *,
                     scale: float | None = None) -> torch.Tensor:
    """Single-token attention against a cache.  q: (B, H, 1, D); k/v: (B, KH,
    S, D), masked past ``pos`` (the current position).  Returns (B, H, 1, D).

    One pair of products per kv head: on a cache view of the (B, S, KH, D)
    layout, each head's (B, S, D) slice is a strided batch the products read
    in place, where one product over all heads would copy the cache."""
    b, h, _, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    g = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = (q * scale).reshape(b, kh, g, d)
    masked = torch.arange(s, device=q.device) > pos
    outs = []
    for j in range(kh):
        logits = torch.matmul(qg[:, j], k[:, j].transpose(-1, -2)).float()   # (b, g, s)
        p = torch.softmax(logits.masked_fill(masked, NEG_INF), dim=-1)
        outs.append(torch.matmul(p.to(v.dtype), v[:, j]))                   # (b, g, d)
    return torch.stack(outs, dim=1).reshape(b, h, 1, d)


# ---------------------------------------------------------------------------
# GQA attention module
# ---------------------------------------------------------------------------

def init_attention(cfg, *, generator: torch.Generator, device, cross: bool = False):
    d, hd = cfg.d_model, cfg.head_dim_
    h, kh = cfg.num_heads, cfg.kv_heads
    kw = dict(dtype=cfg.pdtype, generator=generator, device=device)
    params, axes = {}, {}
    params["wq"], axes["wq"] = init_dense(d, h * hd, ("embed", "heads"), bias=cfg.qkv_bias, **kw)
    params["wk"], axes["wk"] = init_dense(d, kh * hd, ("embed", "kv_heads"), bias=cfg.qkv_bias,
                                          **kw)
    params["wv"], axes["wv"] = init_dense(d, kh * hd, ("embed", "kv_heads"), bias=cfg.qkv_bias,
                                          **kw)
    params["wo"], axes["wo"] = init_dense(
        h * hd, d, ("heads", "embed"),
        scale=1.0 / math.sqrt(h * hd * 2 * max(cfg.num_layers, 1)), **kw)
    if cfg.qk_norm:
        params["q_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
        params["k_norm"] = torch.ones((hd,), dtype=cfg.pdtype, device=device)
        axes["q_norm"] = ("head_dim",)
        axes["k_norm"] = ("head_dim",)
    return params, axes


def _columns(p: dict, lo: int, hi: int) -> dict:
    """A projection's output columns ``[lo, hi)`` (``w`` and ``b``)."""
    return {k: w[..., lo:hi] for k, w in p.items()}


def _enter(mesh, *trees) -> list:
    """``trees`` with every leaf passed through ``collectives.enter`` over
    ``model``, all in one call (one all-reduce of their gradients)."""
    flat = [tree.leaves(t) for t in trees]
    got = iter(collectives.enter([leaf for f in flat for leaf in f], mesh, "model"))
    return [tree.unflatten(t, [next(got) for _ in f]) for t, f in zip(trees, flat)]


def attention(p: dict, x: torch.Tensor, cfg, *, causal: bool = True, use_rope: bool = True,
              positions: torch.Tensor | None = None, kv_src: torch.Tensor | None = None,
              cache: tuple | None = None, pos: int | None = None, mesh=None):
    """GQA attention.

    * train/prefill: ``cache is None`` -- full-sequence attention through
      ``ops.flash_attention_fused`` (K9 on the card); returns (y, (k, v)),
      k and v (B, S, KH, D), so prefill can fill the cache.
    * decode: ``cache = (k_cache, v_cache)``, each (B, S_max, KH, D), and the
      position ``pos``: the token's k and v are written into the caches IN
      PLACE at ``pos`` (``repro`` returns new caches, which XLA updates in
      place by donation); returns (y, (k_cache, v_cache)).
    * cross-attention: ``kv_src`` supplies the encoder output (not causal).

    On a ``mesh`` whose ``model`` axis splits the heads
    (``sharding.head_split``), ``p`` holds this rank's blocks and the block
    is tensor-parallel, Megatron's f/g pair: ``x`` enters through
    ``collectives.enter`` (its cotangent summed over ``model``), the rank
    computes q for its heads and k/v for the kv heads they read (sliced out
    of whole kv projections, which then enter too, where ``kv_heads`` does
    not divide the axis), K9 runs on those local heads, and ``wo`` is
    row-parallel, its partial products summed by one
    ``collectives.combine``.  Every rank issues the same collectives.  The
    prefill's (k, v) are then the rank's local kv heads, and a decode step's
    ``cache`` is the rank's block of it (``sharding.cache_block``): row
    ``pos`` is written there and ``decode_attention`` runs on the local q
    heads against it.  Cross-attention under tensor parallelism projects
    the k / v of the rank's kv heads from ``kv_src`` (whole on every rank)
    and runs K9 non-causal on them; ``kv_src``'s cotangent is then the
    rank's heads' partial, so it must have entered through
    ``collectives.enter`` over ``model``: the caller's, once for every
    layer that reads it (whisper's decoder enters its encoder states ahead
    of the stack, ``whisper._cross_src``).
    """
    b, s, _ = x.shape
    h, kh, hd = cfg.num_heads, cfg.kv_heads, cfg.head_dim_
    cd = cfg.cdtype
    split = SH.head_split(cfg, mesh)
    wk, wv = p["wk"], p["wv"]
    if split is not None:
        norms = {k: p[k] for k in ("q_norm", "k_norm") if k in p}
        kv = {} if split.kv_local else {"wk": wk, "wv": wv}
        x, norms, kv = _enter(mesh, x, norms, kv)
        p = {**p, **norms}
        if kv:
            lo, hi = split.kv0 * hd, (split.kv0 + split.kv) * hd
            wk, wv = _columns(kv["wk"], lo, hi), _columns(kv["wv"], lo, hi)
        h, kh = split.q, split.kv

    q = dense(p["wq"], x, cd).reshape(b, s, h, hd)
    src = x if kv_src is None else kv_src
    k = dense(wk, src, cd).reshape(b, src.shape[1], kh, hd)
    v = dense(wv, src, cd).reshape(b, src.shape[1], kh, hd)

    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])

    if use_rope and kv_src is None:
        if positions is None:
            positions = (torch.arange(s, device=x.device) if pos is None
                         else torch.full((s,), pos, device=x.device))
        q = rope(q.transpose(1, 2), positions, theta=cfg.rope_theta,
                 partial_factor=cfg.partial_rotary).transpose(1, 2)
        k = rope(k.transpose(1, 2), positions, theta=cfg.rope_theta,
                 partial_factor=cfg.partial_rotary).transpose(1, 2)

    if cache is not None:
        k_cache, v_cache = cache
        k_cache[:, pos:pos + s] = k
        v_cache[:, pos:pos + s] = v
        y = decode_attention(q.transpose(1, 2), k_cache.transpose(1, 2),
                             v_cache.transpose(1, 2), pos)
        y = y.transpose(1, 2).reshape(b, s, h * hd)
        out = dense(p["wo"], y, cd)
        if split is not None:
            out = collectives.combine(out, mesh, "model")
        return out, (k_cache, v_cache)

    is_causal = causal and kv_src is None
    if is_causal and k.shape[1] != s:
        raise ValueError(f"causal attention needs as many keys as queries, got {s} "
                         f"queries and {k.shape[1]} keys (the kernel's mask is top-left)")
    y = ops.flash_attention_fused(q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), causal=is_causal,
                                  p_bf16=cfg.flash_block_dtype == "bf16")
    y = y.transpose(1, 2).reshape(b, s, h * hd)
    out = dense(p["wo"], y, cd)
    if split is not None:
        out = collectives.combine(out, mesh, "model")
    return out, (k, v)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg, *, generator: torch.Generator, device, d_ff: int | None = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    kw = dict(dtype=cfg.pdtype, generator=generator, device=device)
    params, axes = {}, {}
    params["w_up"], axes["w_up"] = init_dense(d, f, ("embed", "ffn"), **kw)
    if cfg.activation == "silu":
        params["w_gate"], axes["w_gate"] = init_dense(d, f, ("embed", "ffn"), **kw)
    params["w_down"], axes["w_down"] = init_dense(
        f, d, ("ffn", "embed"), scale=1.0 / math.sqrt(f * 2 * max(cfg.num_layers, 1)), **kw)
    return params, axes


def mlp(p: dict, x: torch.Tensor, cfg, *, mesh=None) -> torch.Tensor:
    """silu-gated (SwiGLU), relu2 (``relu(x)**2``) or gelu (tanh, as
    ``jax.nn.gelu``'s default) MLP in the compute dtype.  On a ``mesh``
    whose ``model`` axis splits ``d_ff`` (``sharding.ffn_split``), ``p``
    holds this rank's columns of ``w_up`` / ``w_gate`` and rows of
    ``w_down``: ``x`` enters through ``collectives.enter`` and the
    row-parallel ``w_down``'s partials are summed by one
    ``collectives.combine``."""
    cd = cfg.cdtype
    split = SH.ffn_split(cfg, mesh)
    if split:
        [x] = collectives.enter([x], mesh, "model")
    up = dense(p["w_up"], x, cd)
    if cfg.activation == "silu":
        hcat = F.silu(dense(p["w_gate"], x, cd)) * up
    elif cfg.activation == "relu2":
        hcat = torch.square(torch.relu(up))
    else:
        hcat = F.gelu(up, approximate="tanh")
    out = dense(p["w_down"], hcat, cd)
    return collectives.combine(out, mesh, "model") if split else out
