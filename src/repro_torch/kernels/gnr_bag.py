"""Pooled bags without a cache: the wrappers of K6 and K7 (port of
``repro.kernels.gnr_bag``).

* ``gnr_bag`` (K6) replaces ``repro/kernels/gnr_bag.py:63 gnr_bag`` (body
  ``_qr_kernel``): ``out[b] = Σ_k (Q[q_idx] + R[r_idx])``;
* ``gnr_bag_dense`` (K7) replaces ``repro/kernels/gnr_bag.py:100
  gnr_bag_dense`` (body ``_dense_kernel``): ``out[b] = Σ_k T[idx]``.

Both run the bag body of ``csrc/packed_gather.cu`` with no slot stream and
no cache.  Bound by bytes (one row read per bag element, one or two adds
per value).  Dispatch is by the tensors' device alone: CUDA tensors launch
the kernel, or raise if the kernel does not take them; CPU tensors take the
plain versions in ``ref``; meta tensors (the dry run) get the output as an
empty meta tensor, counted in ``bounds.META`` (``packed_gather.meta_bag``).
The kernels take float32 or bfloat16 tables,
contiguous int32 (B, K) streams and any dim; the output is in the table
dtype, summed in fp32.  ``LAUNCHES`` counts kernel launches (the plain
versions do not count).
"""

from __future__ import annotations

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build, packed_gather
from repro_torch.kernels.ref import dense_bag_ref, gnr_bag_ref

LAUNCHES = {"gnr_bag": 0, "gnr_bag_dense": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def gnr_bag(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
            r_idx: torch.Tensor) -> torch.Tensor:
    """K6: out[b] = Σ_k (Q[q_idx[b,k]] + R[r_idx[b,k]]).

    q_table: (q_rows, dim); r_lut: (c, dim), same dtype; q_idx/r_idx: (B, K)
    int32.  Returns (B, dim) in the table dtype.
    """
    dev = device_mod.of(q_table, r_lut, q_idx, r_idx)
    if dev.type == "cpu":
        return gnr_bag_ref(q_table, r_lut, q_idx, r_idx)
    (b, k), dim, dtype = packed_gather.check_cuda({"q_table": q_table, "r_lut": r_lut},
                                                  {"q_idx": q_idx, "r_idx": r_idx})
    out = torch.empty((b, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return packed_gather.meta_bag("gnr_bag", out, (q_idx, r_idx), (q_table, r_lut))
    with torch.cuda.device(dev):
        err = packed_gather.entry("gnr_bag", dtype)(
            q_table.data_ptr(), r_lut.data_ptr(), q_idx.data_ptr(), r_idx.data_ptr(),
            out.data_ptr(), b, k, dim, q_table.shape[0], r_lut.shape[0],
            *packed_gather.launch_grid(b, 1, dim, dtype, dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "gnr_bag", err)
    return out


def gnr_bag_dense(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7: out[b] = Σ_k T[idx[b,k]].

    table: (rows, dim); idx: (B, K) int32.  Returns (B, dim) in the table
    dtype.
    """
    dev = device_mod.of(table, idx)
    if dev.type == "cpu":
        return dense_bag_ref(table, idx)
    (b, k), dim, dtype = packed_gather.check_cuda({"table": table}, {"idx": idx})
    out = torch.empty((b, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return packed_gather.meta_bag("gnr_bag_dense", out, (idx,), (table,))
    with torch.cuda.device(dev):
        err = packed_gather.entry("gnr_bag_dense", dtype)(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, k, dim, table.shape[0],
            *packed_gather.launch_grid(b, 1, dim, dtype, dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "gnr_bag_dense", err)
    return out
