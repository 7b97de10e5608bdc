"""Packed multi-table pooled bags: the wrappers of the hand-written CUDA
kernels in ``csrc/packed_gather.cu`` and ``csrc/tt_bag.cu`` (port of
``repro.kernels.packed_gather`` and ``repro.kernels.cached_gather``).

* ``packed_qr_bag`` (K1) replaces ``repro/kernels/packed_gather.py:130``
  -> ``cached_gather.py:123 cached_qr_bag`` (body ``_cached_qr_kernel``);
* ``packed_bag`` (K3) replaces ``repro/kernels/packed_gather.py:103``
  -> ``cached_gather.py:82 cached_bag`` (body ``_cached_kernel``);
* ``packed_tt_bag`` (K2) replaces ``repro/kernels/packed_gather.py:158``
  (body ``_packed_tt_kernel``); its source is shared with K5
  (``kernels/tt_gather.py``).

K1 and K3 are bound by bytes (one row read per bag element, one add per
float), K2 by operations (two small products per element).  Dispatch is by
the tensors' device alone: CUDA tensors launch the kernel, or raise if the
kernel does not take them; CPU tensors take the plain versions in ``ref``.
There is no fallback from the card to the plain version.

The kernels take fp32 tables (serving packs in the param dtype) and int32
(G, K) streams; K1 and K3 take ``dim % 4 == 0``; the bf16 variants come with
training.  ``LAUNCHES`` counts kernel launches per kernel (plain versions do
not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build, tt_gather
from repro_torch.kernels.ref import packed_bag_ref, packed_qr_bag_ref, packed_tt_bag_ref

SOURCE = "packed_gather"
LAUNCHES = {"packed_qr_bag": 0, "packed_bag": 0, "packed_tt_bag": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    lib.packed_qr_bag_f32.argtypes = [_P] * 7 + [_I64, ctypes.c_int, ctypes.c_int,
                                                 _I64, _I64, _I64, _P]
    lib.packed_qr_bag_f32.restype = ctypes.c_int
    lib.packed_bag_f32.argtypes = [_P] * 5 + [_I64, ctypes.c_int, ctypes.c_int,
                                             _I64, _I64, _P]
    lib.packed_bag_f32.restype = ctypes.c_int
    return lib


def _check_cuda(buffers: dict, streams: dict) -> tuple[int, int, int]:
    """Validate what the kernel takes; returns (G, K, dim)."""
    shape = None
    for name, s in streams.items():
        if s.dtype != torch.int32 or s.dim() != 2 or not s.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous int32 (G, K) "
                             f"streams, got {s.dtype} {tuple(s.shape)}")
        if shape is not None and s.shape != shape:
            raise ValueError(f"stream shapes differ: {tuple(s.shape)} vs {tuple(shape)}")
        shape = s.shape
    dim = None
    for name, b in buffers.items():
        if b.dtype != torch.float32 or b.dim() != 2 or not b.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous float32 "
                             f"(rows, dim) buffers, got {b.dtype} {tuple(b.shape)}")
        if b.data_ptr() % 16:
            raise ValueError(f"{name}: buffer is not 16-byte aligned")
        if dim is not None and b.shape[1] != dim:
            raise ValueError(f"buffer widths differ: {name} has {b.shape[1]}, not {dim}")
        dim = b.shape[1]
    if dim % 4:
        raise ValueError(f"dim {dim} is not a multiple of 4 (float4 loads)")
    return shape[0], shape[1], dim


def packed_qr_bag(
    q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
    q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor,
) -> torch.Tensor:
    """K1: out[g] = Σ_k ( (slot >= 0 ? C[slot] : Q[q_idx]) + R[r_idx] ).

    q_table: (total_q_rows, dim), every table's Q packed (+ zero row);
    cache: (slots, dim) staged Q rows; r_lut: (total_r_rows, dim), every R
    LUT packed (+ zero row); q_idx/slot/r_idx: (G, K) globally offset.
    Returns (G, dim) in the table dtype, summed in fp32.
    """
    dev = device_mod.of(q_table, cache, r_lut, q_idx, slot, r_idx)
    if dev.type == "cpu":
        return packed_qr_bag_ref(q_table, cache, r_lut, q_idx, slot, r_idx)
    g, k, dim = _check_cuda({"q_table": q_table, "cache": cache, "r_lut": r_lut},
                            {"q_idx": q_idx, "slot": slot, "r_idx": r_idx})
    out = torch.empty((g, dim), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().packed_qr_bag_f32(
            q_table.data_ptr(), cache.data_ptr(), r_lut.data_ptr(),
            q_idx.data_ptr(), slot.data_ptr(), r_idx.data_ptr(), out.data_ptr(),
            g, k, dim, q_table.shape[0], cache.shape[0], r_lut.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "packed_qr_bag", err)
    return out


def packed_bag(
    table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor
) -> torch.Tensor:
    """K3: out[g] = Σ_k (slot[g,k] >= 0 ? C[slot] : T[idx]).

    table: (total_rows, dim), every table packed (+ zero row); cache:
    (slots, dim); idx/slot: (G, K) globally offset.  Returns (G, dim).
    """
    dev = device_mod.of(table, cache, idx, slot)
    if dev.type == "cpu":
        return packed_bag_ref(table, cache, idx, slot)
    g, k, dim = _check_cuda({"table": table, "cache": cache},
                            {"idx": idx, "slot": slot})
    out = torch.empty((g, dim), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().packed_bag_f32(
            table.data_ptr(), cache.data_ptr(), idx.data_ptr(), slot.data_ptr(),
            out.data_ptr(), g, k, dim, table.shape[0], cache.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "packed_bag", err)
    return out


def packed_tt_bag(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor, cache: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, slot: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """K2: out[g] = Σ_k G1[i1] · (slot >= 0 ? C[slot] : G2[i2]) · G3[i3].

    g1: (T*v1, d1*r) / g3: (T*v3, r*d3), every table's outer cores packed;
    g2: (total_v2_rows, r*d2*r), the middle cores packed (+ zero row);
    cache: (slots, r*d2*r) staged G2 rows; i1/i2/i3/slot: (G, K) globally
    offset.  ``dims`` = (d1, d2, d3, rank).  Returns (G, d1*d2*d3) in the G2
    dtype, contracted and summed in fp32.
    """
    dev = device_mod.of(g1, g2, g3, cache, i1, i2, i3, slot)
    if dev.type == "cpu":
        return packed_tt_bag_ref(g1, g2, g3, cache, i1, i2, i3, slot, dims=dims)
    g, k = tt_gather.check_cuda({"g1": g1, "g2": g2, "g3": g3, "cache": cache},
                                {"i1": i1, "i2": i2, "i3": i3, "slot": slot}, dims)
    d1, d2, d3, rank = dims
    out = torch.empty((g, d1 * d2 * d3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = tt_gather.lib().packed_tt_bag_f32(
            g1.data_ptr(), g2.data_ptr(), g3.data_ptr(), cache.data_ptr(),
            i1.data_ptr(), i2.data_ptr(), i3.data_ptr(), slot.data_ptr(),
            out.data_ptr(), g, k, d1, d2, d3, rank,
            g1.shape[0], g2.shape[0], g3.shape[0], cache.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "packed_tt_bag", err)
    return out
