"""One launch for every table's pooled bag (port of
``repro.kernels.ops.packed_multi_pooled``, kinds ``qr``, ``dense`` and
``tt``), and the TT bag entry points ``tt_pooled_auto`` and ``tt_lookup``.

The streams may carry any leading shape (..., K); they are flattened to the
kernels' (G, K) layout and the output restored to (..., dim).  The device
of the tensors picks the kernel (CUDA) or its plain version (CPU).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import packed_gather, ref, tt_gather


def _flat(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1, s.shape[-1])


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
