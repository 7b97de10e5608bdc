"""Pooled TT-Rec bag: the wrapper of the hand-written CUDA kernel K5 in
``csrc/tt_bag.cu`` (port of ``repro.kernels.tt_gather``).

* ``tt_bag`` (K5) replaces ``repro/kernels/tt_gather.py:64 tt_bag`` (body
  ``_kernel``): ``out[b] = Σ_k G1[i1] · G2[i2] · G3[i3]`` on one table's
  cores.

The same source holds K2 ``packed_tt_bag`` (wrapped in ``packed_gather``),
so this module also loads the library and checks what both TT kernels take.
Both are bound by operations (two small fp32 products per element).
Dispatch is by the tensors' device alone: CUDA tensors launch the kernel, or
raise if the kernel does not take them; CPU tensors take the plain version
``ref.tt_bag_ref``.  There is no fallback from the card to the plain version.

The kernel takes float32 or bfloat16 cores (one type per call; the output
is in that type, contracted and summed in fp32), contiguous int32 (B, K)
streams, ``d1*d2*d3 <= 1024`` and dims whose block fits 227 KB of shared
memory (the launch is refused otherwise); ``repro``'s ``dim % 8`` fallback
to the oracle is a TPU tiling rule and does not apply.  ``LAUNCHES`` counts kernel launches
(the plain version does not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build
from repro_torch.kernels.ref import tt_bag_ref

SOURCE = "tt_bag"
LAUNCHES = {"tt_bag": 0}

MAX_DIM = 1024                 # 128 threads x 8 outputs each

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# entry point -> ctypes argument types: pointers, sizes, the stream last
_ARGS = {
    "packed_tt_bag": [_P] * 9 + [_I64] + [_INT] * 5 + [_I64] * 4 + [_P],
    "tt_bag": [_P] * 7 + [_I64] + [_INT] * 5 + [_I64] * 3 + [_P],
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/tt_bag.cu``, built at first use, with every entry point typed."""
    out = build.load(SOURCE)
    for name, args in _ARGS.items():
        for sfx in SUFFIX.values():
            fn = getattr(out, f"{name}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return out


def entry(name: str, dtype: torch.dtype):
    """The C entry point of ``csrc/tt_bag.cu`` for a core dtype."""
    return getattr(_lib(), f"{name}_{SUFFIX[dtype]}")


def check_cuda(cores: dict, streams: dict, dims: tuple[int, int, int, int]
               ) -> tuple[int, int, torch.dtype]:
    """Validate what the TT kernels take; returns (G, K, core dtype).

    ``cores``: g1, g2, g3 (and the cache block for K2); ``streams``: the
    (G, K) index streams."""
    d1, d2, d3, rank = (int(x) for x in dims)
    if min(d1, d2, d3, rank) <= 0:
        raise ValueError(f"dims {dims} must be positive")
    if d1 * d2 * d3 > MAX_DIM:
        raise ValueError(f"dim {d1 * d2 * d3} exceeds the kernel's {MAX_DIM}")
    widths = {"g1": d1 * rank, "g2": rank * d2 * rank, "g3": rank * d3,
              "cache": rank * d2 * rank}
    dtype = None
    for name, b in cores.items():
        if b.dtype not in SUFFIX or b.dim() != 2 or not b.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous float32 or bfloat16 "
                             f"(rows, width) cores, got {b.dtype} {tuple(b.shape)}")
        if dtype is not None and b.dtype != dtype:
            raise ValueError(f"core dtypes differ: {name} is {b.dtype}, not {dtype}")
        dtype = b.dtype
        if b.shape[1] != widths[name]:
            raise ValueError(f"{name}: width {b.shape[1]} differs from "
                             f"{widths[name]} for dims {dims}")
        if name in ("g2", "cache") and b.data_ptr() % 16:     # vector rows
            raise ValueError(f"{name}: buffer is not 16-byte aligned")
    shape = None
    for name, s in streams.items():
        if s.dtype != torch.int32 or s.dim() != 2 or not s.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous int32 (G, K) "
                             f"streams, got {s.dtype} {tuple(s.shape)}")
        if shape is not None and s.shape != shape:
            raise ValueError(f"stream shapes differ: {tuple(s.shape)} vs {tuple(shape)}")
        shape = s.shape
    if shape[0] >= 2**31:
        raise ValueError(f"{shape[0]} bags exceed one launch's grid")
    return shape[0], shape[1], dtype


def tt_bag(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """K5: out[b] = Σ_k G1[i1[b,k]] · G2[i2[b,k]] · G3[i3[b,k]].

    g1: (v1, d1*r); g2: (v2, r*d2*r); g3: (v3, r*d3); i1/i2/i3: (B, K);
    ``dims`` = (d1, d2, d3, rank).  Returns (B, d1*d2*d3) in the core dtype,
    contracted and summed in fp32.
    """
    dev = device_mod.of(g1, g2, g3, i1, i2, i3)
    if dev.type == "cpu":
        return tt_bag_ref(g1, g2, g3, i1, i2, i3, dims=dims)
    b, k, dtype = check_cuda({"g1": g1, "g2": g2, "g3": g3},
                             {"i1": i1, "i2": i2, "i3": i3}, dims)
    d1, d2, d3, rank = dims
    out = torch.empty((b, d1 * d2 * d3), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = entry("tt_bag", dtype)(
            g1.data_ptr(), g2.data_ptr(), g3.data_ptr(),
            i1.data_ptr(), i2.data_ptr(), i3.data_ptr(), out.data_ptr(),
            b, k, d1, d2, d3, rank, g1.shape[0], g2.shape[0], g3.shape[0],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "tt_bag", err)
    return out
