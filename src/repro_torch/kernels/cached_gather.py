"""Cached pooled bags on one table: the wrappers of K4 (port of
``repro.kernels.cached_gather``), the per-table serving unit that
``EmbeddingEngine.cached_lookup`` runs.

* ``cached_bag`` (K4a) replaces ``repro/kernels/cached_gather.py:82
  cached_bag`` (body ``_cached_kernel``);
* ``cached_qr_bag`` (K4b) replaces ``repro/kernels/cached_gather.py:123
  cached_qr_bag`` (body ``_cached_qr_kernel``).

They launch the same entry points of ``csrc/packed_gather.cu`` as K3 and K1
do, on one table's buffers: ``repro``'s packed kernels call these two
functions directly, so the port keeps one kernel per body.  Bound by bytes
(one row read per bag element, one or two adds per value).  Dispatch is by
the tensors' device alone: CUDA tensors launch the kernel, or raise if the
kernel does not take them; CPU tensors take the plain versions in ``ref``;
meta tensors (the dry run) get the output as an empty meta tensor, counted
in ``bounds.META`` (``packed_gather.meta_bag``).  The kernels take float32
or bfloat16 tables and caches, contiguous int32 (B, K) streams and any
dim.  ``LAUNCHES`` counts kernel launches (the plain
versions do not count).
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import packed_gather
from repro_torch.kernels.ref import cached_bag_ref, cached_qr_bag_ref

LAUNCHES = {"cached_bag": 0, "cached_qr_bag": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cached_bag(table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor,
               slot: torch.Tensor) -> torch.Tensor:
    """K4a: out[b] = Σ_k (slot[b,k] >= 0 ? C[slot] : T[idx]).

    table: (rows, dim); cache: (slots, dim), the staged rows, same dtype;
    idx/slot: (B, K) int32.  Returns (B, dim) in the table dtype, summed in
    fp32.
    """
    dev = device_mod.of(table, cache, idx, slot)
    if dev.type == "cpu":
        return cached_bag_ref(table, cache, idx, slot)
    return packed_gather.run_bag(LAUNCHES, "cached_bag", table, cache, idx, slot)


def cached_qr_bag(q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
                  q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor
                  ) -> torch.Tensor:
    """K4b: out[b] = Σ_k ( (slot >= 0 ? C[slot] : Q[q_idx]) + R[r_idx] ).

    q_table: (q_rows, dim); cache: (slots, dim) staged Q rows; r_lut:
    (c, dim); q_idx/slot/r_idx: (B, K) int32.  Returns (B, dim) in the table
    dtype, summed in fp32.
    """
    dev = device_mod.of(q_table, cache, r_lut, q_idx, slot, r_idx)
    if dev.type == "cpu":
        return cached_qr_bag_ref(q_table, cache, r_lut, q_idx, slot, r_idx)
    return packed_gather.run_qr_bag(LAUNCHES, "cached_qr_bag", q_table, cache, r_lut,
                                    q_idx, slot, r_idx)
