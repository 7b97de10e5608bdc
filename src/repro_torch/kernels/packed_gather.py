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

``csrc/packed_gather.cu`` holds one body for the whole bag family: this
module also loads it and checks what it takes for ``cached_gather`` (K4)
and ``gnr_bag`` (K6, K7).  K1 and K3 are bound by bytes (one row read per
bag element, one add per value), K2 by operations (two small products per
element; its launch math is ``tt_gather.run``).  Dispatch is by the
tensors' device alone: CUDA tensors launch the kernel, or raise if the
kernel does not take them; CPU tensors take the plain versions in ``ref``;
meta tensors (the dry run) pass the kernel's checks and get its output as
an empty meta tensor, the call counted in ``bounds.META`` with its adds and
bytes (``meta_bag``).  There is no fallback from the card to the plain
version.

The bag kernels and K2 take float32 or bfloat16 tables (one type per call;
the output is in that type, summed in fp32), int32 (G, K) streams, any dim
(K2: dims up to 1,024), and buffers that start on 16 bytes.  ``LAUNCHES``
counts kernel launches per kernel (plain versions do not count).

The bag body's launch math lives here, in plain Python the CPU tests reach:
``bag_grid`` tiles the grid as (table, run of bags) for streams whose bag g
belongs to table ``g % tables`` (``tables`` is optional: 1 is the per-table
kernels' case), ``bag_vec`` the values a lane loads at once and
``bag_lanes`` the lanes a bag takes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import bounds, build, tt_gather
from repro_torch.kernels.ref import packed_bag_ref, packed_qr_bag_ref, packed_tt_bag_ref

SOURCE = "packed_gather"
LAUNCHES = {"packed_qr_bag": 0, "packed_bag": 0, "packed_tt_bag": 0}
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
# entry point -> ctypes argument types: pointers, sizes, the stream last
_ARGS = {
    "packed_qr_bag": [_P] * 7 + [_I64, _INT, _INT, _I64, _I64, _I64] + [_INT] * 3 + [_P],
    "packed_bag": [_P] * 5 + [_I64, _INT, _INT, _I64, _I64] + [_INT] * 3 + [_P],
    "gnr_bag": [_P] * 5 + [_I64, _INT, _INT, _I64, _I64] + [_INT] * 2 + [_P],
    "gnr_bag_dense": [_P] * 3 + [_I64, _INT, _INT, _I64] + [_INT] * 2 + [_P],
}
WARPS = 4                          # warps of a bag-body block (kWarpsPerBlock)
WIDE_WARPS = 32                    # warps an SM (a warp a bag) from which bf16 rows take 16-byte loads


def bag_vec(g: int, dim: int, dtype: torch.dtype, sms: int) -> int:
    """Values a lane loads at once in the bag body: 8 bf16 values (16 bytes)
    where dim is a multiple of 8 and a warp a bag would give the card
    ``WIDE_WARPS`` warps an SM; else 4 where dim is a multiple of 4 (a float4
    in fp32, 8 bytes in bf16); else 1.  A small bf16 grid (one table's 2,048
    bags) is latency-bound, and its warps hide more of the latency with a
    bag each than with two side by side."""
    if dtype == torch.bfloat16 and dim % 8 == 0 and g >= WIDE_WARPS * sms:
        return 8
    return 4 if dim % 4 == 0 else 1


def bag_lanes(dim: int, vec: int) -> int:
    """Lanes one bag takes: its dim in chunks of ``vec`` values, rounded up
    to a power of two, at most the 32 of a warp; a warp sums 32 / lanes bags
    side by side."""
    lanes = 1
    while lanes < dim // vec and lanes < 32:
        lanes *= 2
    return lanes


def bag_grid(g: int, tables: int, dim: int, dtype: torch.dtype, sms: int = 132
             ) -> tuple[int, int, int]:
    """The bag body's grid for G bags of ``tables`` tables (bag g of table
    ``g % tables``) on a card of ``sms`` SMs: (bags per block, blocks, values
    a lane loads, ``bag_vec``).  Blocks are (table, run of bags),
    table-major; a run is one pass of the block's warps, each summing
    ``32 / bag_lanes`` bags side by side."""
    if tables < 1 or g % tables:
        raise ValueError(f"{g} bags are not a whole number of bags of {tables} tables")
    vec = bag_vec(g, dim, dtype, sms)
    nb = WARPS * 32 // bag_lanes(dim, vec)
    return nb, tables * -(-(g // tables) // nb), vec


@functools.lru_cache(maxsize=None)
def _launch_grid(g: int, tables: int, dim: int, dtype: torch.dtype, index: int
                 ) -> tuple[int, int]:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    nb, _blocks, vec = bag_grid(g, tables, dim, dtype, sms)
    return nb, vec


def launch_grid(g: int, tables: int, dim: int, dtype: torch.dtype, dev: torch.device
                ) -> tuple[int, int]:
    """The bag body's launch arguments on the card ``dev``: (bags per block,
    values a lane loads) of ``bag_grid``, worked out once per shape."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _launch_grid(g, tables, dim, dtype, index)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for name, args in _ARGS.items():
        for sfx in SUFFIX.values():
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    return lib


def entry(name: str, dtype: torch.dtype):
    """The C entry point of ``csrc/packed_gather.cu`` for a table dtype."""
    return getattr(_lib(), f"{name}_{SUFFIX[dtype]}")


def check_cuda(buffers: dict, streams: dict, *, ndim: int = 2
               ) -> tuple[tuple[int, ...], int, torch.dtype]:
    """Validate what the bag kernels take; returns (stream shape, dim,
    table dtype)."""
    shape = None
    for name, s in streams.items():
        if s.dtype != torch.int32 or s.dim() != ndim or not s.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous int32 {ndim}-d "
                             f"streams, got {s.dtype} {tuple(s.shape)}")
        if shape is not None and s.shape != shape:
            raise ValueError(f"stream shapes differ: {tuple(s.shape)} vs {tuple(shape)}")
        shape = s.shape
    dim = dtype = None
    for name, b in buffers.items():
        if b.dtype not in SUFFIX or b.dim() != 2 or not b.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous float32 or bfloat16 "
                             f"(rows, dim) buffers, got {b.dtype} {tuple(b.shape)}")
        if b.data_ptr() % 16:
            raise ValueError(f"{name}: buffer is not 16-byte aligned")
        if dtype is not None and b.dtype != dtype:
            raise ValueError(f"buffer dtypes differ: {name} is {b.dtype}, not {dtype}")
        if dim is not None and b.shape[1] != dim:
            raise ValueError(f"buffer widths differ: {name} has {b.shape[1]}, not {dim}")
        dim, dtype = b.shape[1], b.dtype
    return tuple(shape), dim, dtype


def meta_bag(name: str, out: torch.Tensor, streams: tuple, tables: tuple) -> torch.Tensor:
    """A bag or gather kernel's call on meta tensors: ``out`` (allocated as
    the kernel's) returned as it is, the call counted in ``bounds.META``:
    one row of each of ``tables`` read and added per stream element, the
    streams read and the output written once."""
    elements = streams[0].numel()
    dim = out.shape[-1]
    bounds.meta_call(name, bounds.row_gather_flops(elements, dim, len(tables)),
                     bounds.nbytes(*streams, out)
                     + elements * dim * sum(t.element_size() for t in tables))
    return out


def run_qr_bag(counts: dict, name: str, q_table, cache, r_lut, q_idx, slot, r_idx,
               tables: int = 1) -> torch.Tensor:
    """Launch the cached QR bag (K1 on packed buffers, K4b on one table's)
    on CUDA tensors and count it under ``counts[name]``."""
    (g, k), dim, dtype = check_cuda({"q_table": q_table, "cache": cache, "r_lut": r_lut},
                                    {"q_idx": q_idx, "slot": slot, "r_idx": r_idx})
    dev = q_table.device
    out = torch.empty((g, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return meta_bag(name, out, (q_idx, slot, r_idx), (q_table, r_lut))
    with torch.cuda.device(dev):
        err = entry("packed_qr_bag", dtype)(
            q_table.data_ptr(), cache.data_ptr(), r_lut.data_ptr(),
            q_idx.data_ptr(), slot.data_ptr(), r_idx.data_ptr(), out.data_ptr(),
            g, k, dim, q_table.shape[0], cache.shape[0], r_lut.shape[0], tables,
            *launch_grid(g, tables, dim, dtype, dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(counts, name, err)
    return out


def run_bag(counts: dict, name: str, table, cache, idx, slot, tables: int = 1
            ) -> torch.Tensor:
    """Launch the cached dense bag (K3 on packed buffers, K4a on one
    table's) on CUDA tensors and count it under ``counts[name]``."""
    (g, k), dim, dtype = check_cuda({"table": table, "cache": cache},
                                    {"idx": idx, "slot": slot})
    dev = table.device
    out = torch.empty((g, dim), dtype=dtype, device=dev)
    if dev.type == "meta":
        return meta_bag(name, out, (idx, slot), (table,))
    with torch.cuda.device(dev):
        err = entry("packed_bag", dtype)(
            table.data_ptr(), cache.data_ptr(), idx.data_ptr(), slot.data_ptr(),
            out.data_ptr(), g, k, dim, table.shape[0], cache.shape[0], tables,
            *launch_grid(g, tables, dim, dtype, dev),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(counts, name, err)
    return out


def packed_qr_bag(
    q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
    q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor, *, tables: int = 1,
) -> torch.Tensor:
    """K1: out[g] = Σ_k ( (slot >= 0 ? C[slot] : Q[q_idx]) + R[r_idx] ).

    q_table: (total_q_rows, dim), every table's Q packed (+ zero row);
    cache: (slots, dim) staged Q rows; r_lut: (total_r_rows, dim), every R
    LUT packed (+ zero row); q_idx/slot/r_idx: (G, K) globally offset.
    ``tables``: the streams' table count T, bag g of table g % T (the
    kernel's grid; any value that divides G gives the same output).
    Returns (G, dim) in the table dtype, summed in fp32.
    """
    dev = device_mod.of(q_table, cache, r_lut, q_idx, slot, r_idx)
    if dev.type == "cpu":
        return packed_qr_bag_ref(q_table, cache, r_lut, q_idx, slot, r_idx)
    return run_qr_bag(LAUNCHES, "packed_qr_bag", q_table, cache, r_lut, q_idx, slot, r_idx,
                      tables)


def packed_bag(
    table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor, slot: torch.Tensor, *,
    tables: int = 1,
) -> torch.Tensor:
    """K3: out[g] = Σ_k (slot[g,k] >= 0 ? C[slot] : T[idx]).

    table: (total_rows, dim), every table packed (+ zero row); cache:
    (slots, dim); idx/slot: (G, K) globally offset; ``tables`` as in
    ``packed_qr_bag``.  Returns (G, dim) in the table dtype, summed in fp32.
    """
    dev = device_mod.of(table, cache, idx, slot)
    if dev.type == "cpu":
        return packed_bag_ref(table, cache, idx, slot)
    return run_bag(LAUNCHES, "packed_bag", table, cache, idx, slot, tables)


def packed_tt_bag(
    g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor, cache: torch.Tensor,
    i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, slot: torch.Tensor,
    *, dims: tuple[int, int, int, int],
) -> torch.Tensor:
    """K2: out[g] = Σ_k G1[i1] · (slot >= 0 ? C[slot] : G2[i2]) · G3[i3].

    g1: (T*v1, d1*r) / g3: (T*v3, r*d3), every table's outer cores packed;
    g2: (total_v2_rows, r*d2*r), the middle cores packed (+ zero row);
    cache: (slots, r*d2*r) staged G2 rows; i1/i2/i3/slot: (G, K) globally
    offset.  ``dims`` = (d1, d2, d3, rank).  Returns (G, d1*d2*d3) in the
    core dtype, contracted and summed in fp32.
    """
    dev = device_mod.of(g1, g2, g3, cache, i1, i2, i3, slot)
    if dev.type == "cpu":
        return packed_tt_bag_ref(g1, g2, g3, cache, i1, i2, i3, slot, dims=dims)
    g, k, dtype, d2s = tt_gather.check_cuda(
        {"g1": g1, "g2": g2, "g3": g3, "cache": cache},
        {"i1": i1, "i2": i2, "i3": i3, "slot": slot}, dims)
    return tt_gather.run("packed_tt_bag", LAUNCHES, (g1, g2, g3), cache, (i1, i2, i3), slot,
                         dims, g, k, dtype, d2s)
