"""Plain PyTorch versions of the kernels (port of ``repro.kernels.ref``:
the QR gather, the plain, cached and packed bags, the TT rows and bags, and
attention).

They are the kernels' oracles: the CPU path runs them, and ``chip_smoke.py``
and the ``gpu`` tests hold each CUDA kernel against them on the card.  Kept
deliberately naive: gather every row, route by slot, sum over K in fp32.
The TT versions contract in the kernels' order (``(d1,r) @ (r,d2*r)``,
reshaped, ``@ (r,d3)``) and add the K rows one after another, as the Pallas
body revisits its output block.
"""

from __future__ import annotations

import torch


def qr_lookup_ref(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
                  r_idx: torch.Tensor) -> torch.Tensor:
    """Unpooled QR rows: out[n] = Q[q_idx[n]] + R[r_idx[n]], added in the
    table dtype (no fp32 upcast)."""
    return q_table[q_idx.long()] + r_lut[r_idx.long()]


def gnr_bag_ref(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
                r_idx: torch.Tensor) -> torch.Tensor:
    """Pooled QR bag: out[b] = Σ_k ( Q[q_idx[b,k]] + R[r_idx[b,k]] ), fp32
    accumulation, cast to the table dtype."""
    rows = q_table[q_idx.long()].float() + r_lut[r_idx.long()].float()
    return rows.sum(dim=-2).to(q_table.dtype)


def dense_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pooled dense bag: out[b] = Σ_k T[idx[b,k]], fp32 accumulation, cast
    to the table dtype."""
    return table[idx.long()].float().sum(dim=-2).to(table.dtype)


def _rows(table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor,
          slot: torch.Tensor) -> torch.Tensor:
    """(..., K, dim) fp32 rows: the cache row on a hit, the table row else."""
    hit = (slot >= 0)[..., None]
    cached = cache[slot.clamp(min=0).long()].float()
    streamed = table[idx.long()].float()
    return torch.where(hit, cached, streamed)


def cached_bag_ref(
    table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor
) -> torch.Tensor:
    """Cached pooled bag: out[b] = Σ_k (slot[b,k] >= 0 ? C[slot] : T[idx]),
    fp32 accumulation, cast to the table dtype."""
    return _rows(table, cache, idx, slot).sum(dim=-2).to(table.dtype)


def cached_qr_bag_ref(
    q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
    q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor,
) -> torch.Tensor:
    """Cached pooled QR bag:
    out[b] = Σ_k ( (slot >= 0 ? C[slot] : Q[q_idx]) + R[r_idx] )."""
    rows = _rows(q_table, cache, q_idx, slot) + r_lut[r_idx.long()].float()
    return rows.sum(dim=-2).to(q_table.dtype)


def packed_bag_ref(
    table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor
) -> torch.Tensor:
    """Packed dense megabag — the same math as ``cached_bag_ref``; the
    multi-table packing lives entirely in the (already offset) index stream."""
    return cached_bag_ref(table, cache, idx, slot)


def packed_qr_bag_ref(
    q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
    q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor,
) -> torch.Tensor:
    """Packed QR megabag — ``cached_qr_bag_ref`` over packed buffers."""
    return cached_qr_bag_ref(q_table, cache, r_lut, q_idx, slot, r_idx)


def _tt_rows(g1: torch.Tensor, g2_rows: torch.Tensor, g3: torch.Tensor,
             i1: torch.Tensor, i3: torch.Tensor, dims) -> torch.Tensor:
    """(..., K, dim) fp32 rows G1[i1] · M · G3[i3], with the gathered (or
    slot-routed) middle-core rows ``g2_rows`` (..., K, r*d2*r)."""
    d1, d2, d3, rank = dims
    lead = i1.shape
    a = g1[i1.long()].float().reshape(*lead, d1, rank)
    m = g2_rows.float().reshape(*lead, rank, d2 * rank)
    c = g3[i3.long()].float().reshape(*lead, rank, d3)
    t = torch.matmul(a, m).reshape(*lead, d1 * d2, rank)
    return torch.matmul(t, c).reshape(*lead, d1 * d2 * d3)


def _sum_k(rows: torch.Tensor) -> torch.Tensor:
    """Sum (..., K, dim) over K in order k = 0, 1, ..., K-1."""
    out = torch.zeros_like(rows[..., 0, :])
    for k in range(rows.shape[-2]):
        out = out + rows[..., k, :]
    return out


def tt_row_ref(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """Unpooled TT rows (fp32 contraction, ``repro``'s einsum order):
    out[n] = G1[i1[n]] · G2[i2[n]] · G3[i3[n]] reshaped to d1*d2*d3, cast to
    the G2 dtype."""
    d1, d2, d3, rank = dims
    a = g1[i1.long()].float().reshape(*i1.shape, d1, rank)
    b = g2[i2.long()].float().reshape(*i2.shape, rank, d2, rank)
    c = g3[i3.long()].float().reshape(*i3.shape, rank, d3)
    rows = torch.einsum("...ap,...pbq,...qc->...abc", a, b, c)
    return rows.reshape(*i1.shape, d1 * d2 * d3).to(g2.dtype)


def tt_bag_ref(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """Pooled TT bag: out[b] = Σ_k G1[i1[b,k]]·G2[i2[b,k]]·G3[i3[b,k]],
    contraction and sum in fp32, cast to the G2 dtype."""
    rows = _tt_rows(g1, g2[i2.long()], g3, i1, i3, dims)
    return _sum_k(rows).to(g2.dtype)


def packed_tt_bag_ref(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor, cache: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, slot: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """Packed TT megabag with the middle core routed by slot:
    out[g] = Σ_k G1[i1] · (slot >= 0 ? C[slot] : G2[i2]) · G3[i3].

    Outer-core indices are packed rows (t*v1 + i1, t*v3 + i3)."""
    rows = _tt_rows(g1, _rows(g2, cache, i2, slot), g3, i1, i3, dims)
    return _sum_k(rows).to(g2.dtype)


NEG_INF = -1e30


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """The attention kernel K9's plain version: full-matrix fp32 softmax with
    GQA.  q (B, H, Sq, D) widened to fp32 and scaled by D^-1/2, k and v
    (B, KH, Skv, D) widened to fp32; the causal mask is the kernel's, top-left
    aligned (query i sees key j iff i >= j), masked scores NEG_INF.  Returns
    (B, H, Sq, D) in q's dtype."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float() * d ** -0.5, kk.transpose(-1, -2))
    if causal:
        pos_q = torch.arange(sq, device=q.device)[:, None]
        pos_k = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(pos_q < pos_k, NEG_INF)
    return torch.matmul(torch.softmax(s, dim=-1), vv).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """``repro``'s attention oracle, verbatim: scale in q's dtype, fp32
    softmax with GQA, and a causal mask aligned bottom-right
    (``tril(k=skv-sq)``), unlike the kernel's top-left mask; the two agree
    only when Sq == Skv."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    g = h // kh
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q * d ** -0.5, kk.transpose(-1, -2)).float()
    if causal:
        mask = torch.tril(torch.ones((sq, skv), dtype=torch.bool, device=q.device),
                          diagonal=skv - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), vv)
