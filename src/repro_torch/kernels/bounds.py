"""The work each kernel does, in operations and bytes, and the count of the
kernels' calls on the ``meta`` device.

The formulas are the bound column's (``chip_smoke.py``, ``PERF.md`` §6):
K9 does 4·D flops for each visible (query, key) pair and moves q, k, v and
the output once; the gathers (K8) and the bags (K1, K3, K4, K6, K7) read
their index streams, one row per element and write their output once, one
add per value; the TT bags (K2, K5) do two small products per element
(``tt_flops``).  Where the bytes depend on the data (rows that a batch
repeats are read once on the card), the formulas here read every element's
row: a trace on meta has no indices to count unique rows of, so its bytes
are the most the call can read.

``META`` counts the kernel wrappers' calls on meta tensors, by kernel:
``[calls, flops, bytes]``.  They are not launches, and ``LAUNCHES`` (which
``chip_smoke.py`` reads) never counts them.  It also holds the products of
the steps a meta trace leaves out of a loop (``models/xlstm.py``: the
sLSTM scan runs one step on meta, ``slstm_steps``; the mLSTM one chunk
without autograd, ``mlstm_chunks``).  ``launch.dryrun`` resets
and reads it around each traced step.
"""

from __future__ import annotations

import torch

# kernel -> [calls, flops, bytes] of its wrappers' calls on meta tensors
META: dict[str, list] = {}


def reset_meta() -> None:
    META.clear()


def meta_call(name: str, flops: int, nbytes: int) -> None:
    """Count one call of kernel ``name`` on meta tensors, with its work."""
    rec = META.setdefault(name, [0, 0, 0])
    rec[0] += 1
    rec[1] += int(flops)
    rec[2] += int(nbytes)


def meta_repeats(name: str, repeats: int, run):
    """``run()`` once, its products counted (``FlopCounterMode``'s formulas)
    and recorded ``repeats`` more times under ``name``: a loop's iteration
    that a meta trace runs in place of ``repeats`` + 1 like ones."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = run()
    meta_call(name, repeats * counter.get_total_flops(), 0)
    return out


def nbytes(*tensors: torch.Tensor) -> int:
    """The bytes of ``tensors``, each read or written once."""
    return sum(t.numel() * t.element_size() for t in tensors)


def visible_pairs(sq: int, skv: int, causal: bool = True) -> int:
    """(query, key) pairs attention computes: causal top-left, query i sees
    keys 0..i, which is S(S+1)/2 pairs for Sq == Skv; else all Sq·Skv."""
    if not causal:
        return sq * skv
    if sq <= skv:
        return sq * (sq + 1) // 2
    return skv * (skv + 1) // 2 + (sq - skv) * skv


def flash_flops(b, h, sq, skv, d, causal=True) -> int:
    """K9: 4·D flops for each visible (query, key) pair and query head."""
    return 4 * b * h * d * visible_pairs(sq, skv, causal)


def row_gather_flops(elements: int, dim: int, rows_per_element: int = 1) -> int:
    """The adds of a gather or bag: one per value of every row it sums."""
    return elements * dim * rows_per_element


def tt_flops(lookups: int, dims: tuple[int, int, int, int]) -> int:
    """A TT bag's two chained products a lookup: G1 (d1, r) · G2 (r, d2·r)
    then (d1·d2, r) · G3 (r, d3), two flops a multiply-add."""
    d1, d2, d3, r = dims
    return 2 * lookups * (d1 * r * d2 * r + d1 * d2 * r * d3)
