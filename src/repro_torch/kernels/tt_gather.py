"""Pooled TT-Rec bag: the wrapper of the hand-written CUDA kernel K5 in
``csrc/tt_bag.cu`` (port of ``repro.kernels.tt_gather``).

* ``tt_bag`` (K5) replaces ``repro/kernels/tt_gather.py:64 tt_bag`` (body
  ``_kernel``): ``out[b] = Σ_k G1[i1] · G2[i2] · G3[i3]`` on one table's
  cores.

The same source holds K2 ``packed_tt_bag`` (wrapped in ``packed_gather``),
so this module also loads the library, checks what both TT kernels take and
does their launch math (``run``): the elements are ordered by their
middle-core source (``element_order``, ``torch.sort`` on the card), an fp32
scratch of one row per element is allocated, and one C call launches the
contraction pass (each middle row staged once per run of elements that
share it, whole or in d2 slices; fp32 FMAs in depth order on the CUDA cores for both core types,
so the output is bitwise the plain version's) and the in-order K sum.
Both are bound by operations (two small products per element).
Dispatch is by the tensors' device alone: CUDA tensors launch the kernel, or
raise if the kernel does not take them; CPU tensors take the plain version
``ref.tt_bag_ref``; meta tensors (the dry run) run the launch math (the
element order's sort, the scratch) and get the output as an empty meta
tensor, the call counted in ``bounds.META`` with its flops and bytes (the
stage width, a shared-memory choice that needs the built library, is not
taken there).  There is no fallback from the card to the plain version.

The kernel takes float32 or bfloat16 cores (one type per call; the output
is in that type, contracted and summed in fp32), contiguous int32 (B, K)
streams, ``d1*d2*d3 <= 1024`` (``tt_bag`` takes a wider row, such as a
qwen2-1.5b vocabulary's 1,536, in ``d1_slices``: one launch per slice of
G1's d1 rows, each on the slice's G1 columns and the whole G2 and G3, the
outputs side by side in the row's d1-major layout; every output is the
same fmaf chain as in one launch), ``d1 <= 32`` and dims whose block fits 227 KB
of shared memory when it stages the middle core one d2 column group at a
time (``stage_width``: wider stages where they fit; at rank 16 the whole
row, at rank 64 slices of it); ``repro``'s ``dim % 8`` fallback to the
oracle is a TPU tiling rule and does not apply.  ``LAUNCHES`` counts kernel launches (the
plain version does not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import bounds, build
from repro_torch.kernels.ref import tt_bag_ref

SOURCE = "tt_bag"
LAUNCHES = {"tt_bag": 0}

MAX_DIM = 1024
MAX_D1 = 32                    # G1 rows of one element within a 32-row slice of t
MAX_SMEM = 232448              # 227 KB a block
# the body each core type runs (one source, csrc/tt_bag.cu)
BODY = {torch.float32: "sorted runs, fp32 FMA on the CUDA cores",
        torch.bfloat16: "sorted runs, bf16 widened, fp32 FMA on the CUDA cores"}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# entry point -> ctypes argument types: pointers, sizes, the stream last
_ARGS = {
    "packed_tt_bag": [_P] * 11 + [_I64] + [_INT] * 6 + [_I64] * 4 + [_P],
    "tt_bag": [_P] * 9 + [_I64] + [_INT] * 6 + [_I64] * 3 + [_P],
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
    out.tt_bag_smem_bytes.argtypes = [_INT] * 5
    out.tt_bag_smem_bytes.restype = ctypes.c_longlong
    return out


def entry(name: str, dtype: torch.dtype):
    """The C entry point of ``csrc/tt_bag.cu`` for a core dtype."""
    return getattr(_lib(), f"{name}_{SUFFIX[dtype]}")


def stage_width(d2: int, fits) -> int | None:
    """The TT kernels' staging choice: how many of the middle core's d2
    column groups (``rank`` columns each) a block stages at once — the
    largest divisor of d2 for which ``fits(d2s)`` holds (the whole row,
    d2s = d2, is the one-stage layout), or None if not even one fits."""
    for d2s in range(d2, 0, -1):
        if d2 % d2s == 0 and fits(d2s):
            return d2s
    return None


def check_cuda(cores: dict, streams: dict, dims: tuple[int, int, int, int]
               ) -> tuple[int, int, torch.dtype, int]:
    """Validate what the TT kernels take; returns (G, K, core dtype, the
    stage width ``stage_width`` picks).

    ``cores``: g1, g2, g3 (and the cache block for K2); ``streams``: the
    (G, K) index streams."""
    d1, d2, d3, rank = (int(x) for x in dims)
    if min(d1, d2, d3, rank) <= 0:
        raise ValueError(f"dims {dims} must be positive")
    if d1 * d2 * d3 > MAX_DIM:
        raise ValueError(f"dim {d1 * d2 * d3} exceeds the kernel's {MAX_DIM}")
    if d1 > MAX_D1:
        raise ValueError(f"d1 {d1} exceeds the kernel's {MAX_D1}")
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
    if shape[0] * shape[1] >= 2**36:
        raise ValueError(f"{shape[0]} x {shape[1]} elements exceed one launch's grid")
    meta = next(iter(cores.values())).device.type == "meta"
    return shape[0], shape[1], dtype, 0 if meta else staging(dims, dtype)


def staging(dims: tuple[int, int, int, int], dtype: torch.dtype) -> int:
    """The stage width ``stage_width`` picks for these dims and core type by
    the kernel's own shared-memory layout (``tt_bag_smem_bytes``); raises
    where not even one d2 column group a stage fits ``MAX_SMEM``."""
    d1, d2, d3, rank = (int(x) for x in dims)
    smem = lambda d2s: _lib().tt_bag_smem_bytes(d1, d2s, d3, rank, int(dtype == torch.bfloat16))
    d2s = stage_width(d2, lambda w: smem(w) <= MAX_SMEM)
    if d2s is None:
        raise ValueError(f"dims {dims} need {smem(1)} B of shared memory a block even "
                         f"staging one d2 column group of the middle core at a time, "
                         f"more than the {MAX_SMEM} B the kernel may take")
    return d2s


def element_order(i2: torch.Tensor, slot: torch.Tensor | None = None,
                  cache_rows: int = 0, g2_rows: int = 0) -> torch.Tensor:
    """The TT kernels' launch math: the flat element positions of (G, K)
    streams ordered by middle-core source — the cache slot of a hit, else
    ``cache_rows`` + the G2 row — so that the elements sharing a middle row
    sit next to each other (stable: equal sources keep their stream order).
    Keys are int32 while ``cache_rows + g2_rows`` fits.  Returns int64
    positions."""
    key = i2.reshape(-1)
    if slot is not None:
        s = slot.reshape(-1)
        if cache_rows + g2_rows >= 2**31:
            s, key = s.long(), key.long()
        key = torch.where(s >= 0, s, key + cache_rows)
    return torch.sort(key, stable=True).indices


def run(name: str, counts: dict, cores: tuple, cache, streams: tuple, slot,
        dims: tuple[int, int, int, int], g: int, k: int, dtype, d2s: int) -> torch.Tensor:
    """Launch K2 (``name`` "packed_tt_bag", with ``cache`` and ``slot``) or
    K5 ("tt_bag") on checked CUDA tensors: order the elements, allocate the
    scratch, one C call for both passes; count it under ``counts[name]``."""
    d1, d2, d3, rank = dims
    dev = cores[0].device
    cache_rows = 0 if cache is None else cache.shape[0]
    order = element_order(streams[1], slot, cache_rows, cores[1].shape[0])
    scratch = torch.empty((g * k, d1 * d2 * d3), dtype=torch.float32, device=dev)
    out = torch.empty((g, d1 * d2 * d3), dtype=dtype, device=dev)
    ptrs = [c.data_ptr() for c in cores]
    if cache is not None:
        ptrs.append(cache.data_ptr())
    ptrs += [s.data_ptr() for s in streams]
    if slot is not None:
        ptrs.append(slot.data_ptr())
    rows = [c.shape[0] for c in cores] + ([] if cache is None else [cache_rows])
    if dev.type == "meta":
        # the streams and the order read, the scratch written and read, the
        # output written, and every element's G1, G2 and G3 rows
        rows_read = g * k * sum(c.shape[1] for c in cores) * cores[0].element_size()
        ins = [*streams] + ([] if slot is None else [slot])
        bounds.meta_call(name, bounds.tt_flops(g * k, dims),
                         bounds.nbytes(*ins, order, out) + 2 * bounds.nbytes(scratch)
                         + rows_read)
        return out
    with torch.cuda.device(dev):
        err = entry(name, dtype)(
            *ptrs, order.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            g, k, d1, d2, d3, rank, d2s, *rows, torch.cuda.current_stream(dev).cuda_stream)
    build.launched(counts, name, err)
    return out


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
    d1, d2, d3, rank = (int(x) for x in dims)
    slices = d1_slices(dims)
    if len(slices) > 1:
        if g1.dim() != 2 or g1.shape[1] != d1 * rank:
            raise ValueError(f"g1: width {tuple(g1.shape)} differs from {d1 * rank} for "
                             f"dims {dims}")
        rows = g1.reshape(g1.shape[0], d1, rank)
        return torch.cat([
            tt_bag(rows[:, lo:hi].reshape(g1.shape[0], (hi - lo) * rank).contiguous(), g2, g3,
                   i1, i2, i3, dims=(hi - lo, d2, d3, rank))
            for lo, hi in slices], dim=-1)
    b, k, dtype, d2s = check_cuda({"g1": g1, "g2": g2, "g3": g3},
                                  {"i1": i1, "i2": i2, "i3": i3}, dims)
    return run("tt_bag", LAUNCHES, (g1, g2, g3), None, (i1, i2, i3), None, dims, b, k, dtype,
               d2s)


def d1_slices(dims: tuple[int, int, int, int]) -> list[tuple[int, int]]:
    """The (lo, hi) ranges of G1's d1 rows ``tt_bag`` launches K5 on: one
    range where the row fits ``MAX_DIM``, else the fewest ranges of as equal
    a size as can be whose rows each fit."""
    d1, d2, d3, _rank = (int(x) for x in dims)
    per = MAX_DIM // max(d2 * d3, 1)
    if d1 * d2 * d3 <= MAX_DIM or per == 0:
        return [(0, d1)]                  # check_cuda takes it or names the limit
    n = -(-d1 // per)
    cuts = [d1 * i // n for i in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))
