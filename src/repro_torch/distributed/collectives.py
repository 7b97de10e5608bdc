"""Collectives over a mesh axis, and gradient compression (port of
``repro.distributed.collectives``).

``psum`` / ``pmax`` are ``jax.lax.psum`` / ``pmax`` over one axis of a
``launch.mesh.Mesh``: an ``all_reduce`` over the process group of this
rank's line along that axis.  Every call counts in ``CALLS`` (collectives)
and ``BYTES`` (the payload each rank puts in, bytes of the reduced tensor),
so a caller can tell how many combines a path made and what they carried.

``compressed_psum`` agrees a shared scale first (a MAX of the local amax),
then sums int8 payloads in int32 and dequantizes by the shared scale.
``ef_step`` adds error feedback: the quantization residual is carried to
the next step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = {"all_reduce": 0}
BYTES = {"all_reduce": 0}


def reset_counts() -> None:
    CALLS["all_reduce"] = 0
    BYTES["all_reduce"] = 0


def _all_reduce(x: torch.Tensor, mesh, axis: str, op) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    CALLS["all_reduce"] += 1
    BYTES["all_reduce"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``), in
    ``x``'s dtype; returns a new tensor."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``axis`` (``jax.lax.pmax``)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    amax = x.abs().max() + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def _shared_scale(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    amax = (x.abs().max() + 1e-12).reshape(1)
    return pmax(amax, mesh, axis)[0] / 127.0


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """int8-compressed all-reduce over ``axis``: the shared scale (MAX of the
    local amax, one value), then the int8 payloads summed in int32 and
    dequantized by the shared scale.  Wire bytes: ~x.numel() (int8 values,
    carried as int32 by the sum) instead of 4 * x.numel()."""
    scale = _shared_scale(x, mesh, axis)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    acc = psum(q.to(torch.int32), mesh, axis)
    return acc.to(x.dtype) * scale.to(x.dtype)


def ef_step(grad: torch.Tensor, residual: torch.Tensor, mesh,
            axis: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compressed all-reduce step: returns (reduced grad, new
    residual), the residual being what the shared-scale int8 format could
    not represent locally."""
    g = grad + residual
    scale = _shared_scale(g, mesh, axis)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    local_deq = q.to(g.dtype) * scale.to(g.dtype)
    new_residual = g - local_deq
    acc = psum(q.to(torch.int32), mesh, axis)
    return acc.to(g.dtype) * scale.to(g.dtype), new_residual
