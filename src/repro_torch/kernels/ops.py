"""The kernels' public entry points (port of ``repro.kernels.ops``): one
launch for every table's pooled bag (``packed_multi_pooled``, kinds ``qr``,
``dense`` and ``tt``), the per-table bags (``gnr_pooled`` K6,
``gnr_pooled_dense`` K7, ``cached_pooled`` K4a, ``cached_qr_pooled`` K4b),
the unpooled QR gather ``qr_lookup`` (K8), and the TT bag entry points
``tt_pooled_auto`` and ``tt_lookup`` (K5).

The streams may carry any leading shape (..., K) (``qr_lookup``: any shape
(...,)); they are flattened to the kernels' (G, K) / (N,) layout and the
output restored to (..., dim).  The device of the tensors picks the kernel
(CUDA) or its plain version (CPU).  ``dim_block`` is ``repro``'s TPU lane
tile: an explicit one is checked against ``repro``'s ladder and raises
``ValueError`` where ``repro`` does; the CUDA kernels take every dim and do
not read it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import cached_gather, gnr_bag, packed_gather, qr_gather, ref
from repro_torch.kernels import tt_gather
from repro_torch.tune import knobs


def _flat(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1, s.shape[-1])


def _check_dim_block(dim: int, dim_block: int | None) -> None:
    """An explicit ``dim_block`` must be legal for ``dim`` (``repro``'s
    ``_resolve_dim_block``)."""
    if dim_block is None:
        return
    valid = knobs.valid_dim_blocks(dim)
    if dim_block not in valid:
        raise ValueError(
            f"dim_block={dim_block} is not valid for dim {dim}; "
            f"valid blocks: {list(valid) or '(none: jnp reference only)'}"
        )


def qr_lookup(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
              r_idx: torch.Tensor, *, dim_block: int | None = None) -> torch.Tensor:
    """Unpooled QR rows for any index shape (...,) -> (..., dim): K8."""
    _check_dim_block(q_table.shape[1], dim_block)
    out = qr_gather.qr_gather(q_table, r_lut, q_idx.reshape(-1), r_idx.reshape(-1))
    return out.reshape(*q_idx.shape, out.shape[-1])


def gnr_pooled(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
               r_idx: torch.Tensor, *, dim_block: int | None = None) -> torch.Tensor:
    """Pooled QR bag for index shape (..., K) -> (..., dim): K6."""
    _check_dim_block(q_table.shape[1], dim_block)
    out = gnr_bag.gnr_bag(q_table, r_lut, _flat(q_idx), _flat(r_idx))
    return out.reshape(*q_idx.shape[:-1], out.shape[-1])


def gnr_pooled_dense(table: torch.Tensor, idx: torch.Tensor, *,
                     dim_block: int | None = None) -> torch.Tensor:
    """Pooled dense bag for index shape (..., K) -> (..., dim): K7."""
    _check_dim_block(table.shape[1], dim_block)
    out = gnr_bag.gnr_bag_dense(table, _flat(idx))
    return out.reshape(*idx.shape[:-1], out.shape[-1])


def cached_pooled(table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor,
                  slot: torch.Tensor, *, dim_block: int | None = None) -> torch.Tensor:
    """Cached pooled bag for index shape (..., K) -> (..., dim): K4a.

    ``cache`` is the prefetch scheduler's staged block; ``slot`` its
    per-access routing (-1 = miss -> the table row)."""
    _check_dim_block(table.shape[1], dim_block)
    out = cached_gather.cached_bag(table, cache, _flat(idx), _flat(slot))
    return out.reshape(*idx.shape[:-1], out.shape[-1])


def cached_qr_pooled(q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
                     q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor, *,
                     dim_block: int | None = None) -> torch.Tensor:
    """Cached pooled QR bag for index shape (..., K) -> (..., dim): K4b."""
    _check_dim_block(q_table.shape[1], dim_block)
    out = cached_gather.cached_qr_bag(q_table, cache, r_lut, _flat(q_idx), _flat(slot),
                                      _flat(r_idx))
    return out.reshape(*q_idx.shape[:-1], out.shape[-1])


def packed_multi_pooled(params: dict, streams: dict, *, kind: str,
                        dims: tuple[int, int, int, int] | None = None) -> torch.Tensor:
    """``params``: packed buffers — dense {"table", "cache"}, qr {"q", "cache",
    "r"}, tt {"g1", "g2", "g3", "cache"}; ``streams``: globally offset int32
    (..., K) streams — dense {"idx", "slot"}, qr {"q_idx", "slot", "r_idx"},
    tt {"i1", "i2", "i3", "slot"}; ``dims`` = (d1, d2, d3, rank) for tt.
    Returns (..., dim)."""
    if kind == "qr":
        lead = streams["q_idx"].shape[:-1]
        out = packed_gather.packed_qr_bag(
            params["q"], params["cache"], params["r"],
            _flat(streams["q_idx"]), _flat(streams["slot"]), _flat(streams["r_idx"]),
        )
    elif kind == "dense":
        lead = streams["idx"].shape[:-1]
        out = packed_gather.packed_bag(
            params["table"], params["cache"],
            _flat(streams["idx"]), _flat(streams["slot"]),
        )
    elif kind == "tt":
        lead = streams["i1"].shape[:-1]
        out = packed_gather.packed_tt_bag(
            params["g1"], params["g2"], params["g3"], params["cache"],
            _flat(streams["i1"]), _flat(streams["i2"]), _flat(streams["i3"]),
            _flat(streams["slot"]), dims=dims,
        )
    else:
        raise ValueError(f"packed_multi_pooled: unsupported kind {kind!r}")
    return out.reshape(*lead, out.shape[-1])


def tt_pooled_auto(g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
                   i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, *,
                   dims: tuple[int, int, int, int], exec_mode: str = "jnp"
                   ) -> torch.Tensor:
    """Pooled TT bag for index shape (..., K) -> (..., dim), dispatched by
    the config's ``tt_exec``: ``"pallas"`` is the TT-bag kernel K5 (its plain
    version on CPU tensors), ``"jnp"`` always the plain version (the names
    are ``repro``'s)."""
    if exec_mode == "jnp":
        return ref.tt_bag_ref(g1, g2, g3, i1, i2, i3, dims=dims)
    if exec_mode != "pallas":
        raise ValueError(f"tt_pooled_auto: unknown exec_mode {exec_mode!r}")
    lead = i1.shape[:-1]
    out = tt_gather.tt_bag(g1, g2, g3, _flat(i1), _flat(i2), _flat(i3), dims=dims)
    return out.reshape(*lead, out.shape[-1])


def tt_lookup(g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
              i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, *,
              dims: tuple[int, int, int, int]) -> torch.Tensor:
    """Unpooled TT rows for any index shape (...,) -> (..., dim): K5 with
    K = 1 per lookup."""
    shape = i1.shape
    out = tt_gather.tt_bag(g1, g2, g3, i1.reshape(-1, 1), i2.reshape(-1, 1),
                           i3.reshape(-1, 1), dims=dims)
    return out.reshape(*shape, out.shape[-1])
