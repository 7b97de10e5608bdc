"""Plain PyTorch versions of the packed-bag kernels (port of
``repro.kernels.ref``, the cached and packed bags).

They are the kernels' oracles: the CPU path runs them, and ``chip_smoke.py``
and the ``gpu`` tests hold each CUDA kernel against them on the card.  Kept
deliberately naive: gather every row, route by slot, sum over K in fp32.
"""

from __future__ import annotations

import torch


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
