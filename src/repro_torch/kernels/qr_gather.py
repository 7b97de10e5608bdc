"""Unpooled quotient-remainder gather: the wrapper of the hand-written CUDA
kernel K8 in ``csrc/qr_gather.cu`` (port of ``repro.kernels.qr_gather``).

* ``qr_gather`` (K8) replaces ``repro/kernels/qr_gather.py:42 qr_gather``
  (body ``_kernel``): ``out[n] = Q[q_idx[n]] + R[r_idx[n]]``, added in the
  table dtype with no fp32 upcast.

Bound by bytes (one Q row and one R row read, one row written per lookup).
Dispatch is by the tensors' device alone: CUDA tensors launch the kernel,
or raise if the kernel does not take it; CPU tensors take the plain version
``ref.qr_lookup_ref``; meta tensors (the dry run) get the output as an
empty meta tensor, the call counted in ``bounds.META``
(``packed_gather.meta_bag``).  The kernel takes float32 or bfloat16 tables,
contiguous int32 (N,) streams and any dim.  ``LAUNCHES`` counts kernel
launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build, packed_gather
from repro_torch.kernels.ref import qr_lookup_ref

SOURCE = "qr_gather"
LAUNCHES = {"qr_gather": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for sfx in packed_gather.SUFFIX.values():
        fn = getattr(lib, f"qr_gather_{sfx}")
        fn.argtypes = [_P] * 5 + [_I64, ctypes.c_int, _I64, _I64, _P]
        fn.restype = ctypes.c_int
    return lib


def qr_gather(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
              r_idx: torch.Tensor) -> torch.Tensor:
    """K8: out[n] = Q[q_idx[n]] + R[r_idx[n]].

    q_table: (q_rows, dim); r_lut: (c, dim), same dtype; q_idx/r_idx: (N,)
    int32.  Returns (N, dim) in the table dtype.
    """
    dev = device_mod.of(q_table, r_lut, q_idx, r_idx)
    if dev.type == "cpu":
        return qr_lookup_ref(q_table, r_lut, q_idx, r_idx)
    (n,), dim, dtype = packed_gather.check_cuda({"q_table": q_table, "r_lut": r_lut},
                                                {"q_idx": q_idx, "r_idx": r_idx}, ndim=1)
    out = torch.empty((n, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return packed_gather.meta_bag("qr_gather", out, (q_idx, r_idx), (q_table, r_lut))
    with torch.cuda.device(dev):
        err = getattr(_lib(), f"qr_gather_{packed_gather.SUFFIX[dtype]}")(
            q_table.data_ptr(), r_lut.data_ptr(), q_idx.data_ptr(), r_idx.data_ptr(),
            out.data_ptr(), n, dim, q_table.shape[0], r_lut.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "qr_gather", err)
    return out
