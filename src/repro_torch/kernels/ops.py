"""One launch for every table's pooled bag (port of
``repro.kernels.ops.packed_multi_pooled``, kinds ``qr`` and ``dense``).

The streams may carry any leading shape (..., K); they are flattened to the
kernels' (G, K) layout and the output restored to (..., dim).  The device
of the tensors picks the kernel (CUDA) or its plain version (CPU).
"""

from __future__ import annotations

import torch

from repro_torch import TT_NEXT
from repro_torch.kernels import packed_gather


def _flat(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1, s.shape[-1])


def packed_multi_pooled(params: dict, streams: dict, *, kind: str) -> torch.Tensor:
    """``params``: packed buffers — dense {"table", "cache"}, qr {"q", "cache",
    "r"}; ``streams``: globally offset int32 (..., K) streams — dense {"idx",
    "slot"}, qr {"q_idx", "slot", "r_idx"}.  Returns (..., dim)."""
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
        raise NotImplementedError(TT_NEXT)
    else:
        raise ValueError(f"packed_multi_pooled: unsupported kind {kind!r}")
    return out.reshape(*lead, out.shape[-1])
