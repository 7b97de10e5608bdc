"""Blockwise (flash-style) attention in plain PyTorch (port of the attention
part of ``repro.models.layers``: ``NEG_INF``, ``_fit_block``,
``_attn_block`` and ``flash_attention``).

``flash_attention`` is what the attention kernel's backward recomputes
through (``kernels/flash_attention.py::flash_mha``), as ``repro``'s
``flash_mha`` differentiates ``layers.flash_attention``.  It never forms
the (Sq, Skv) score matrix: a Python loop over query blocks runs a loop over
key blocks with the online-softmax update, where ``repro`` scans.  The
causal mask is top-left aligned (query i sees key j iff i >= j), as in the
kernel.  ``repro``'s sharding constraints have no counterpart here.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
