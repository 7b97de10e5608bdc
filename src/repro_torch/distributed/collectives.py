"""Collectives over a mesh axis, and gradient compression (port of
``repro.distributed.collectives``).

``psum`` / ``pmax`` are ``jax.lax.psum`` / ``pmax`` over one axis of a
``launch.mesh.Mesh``: an ``all_reduce`` over the process group of this
rank's line along that axis.  Every call counts in ``CALLS`` (collectives)
and ``BYTES`` (the payload each rank puts in, bytes of the reduced tensor),
and in ``SITES`` under its site and axis, so a caller can tell how many
combines a path made, what they carried and over which axis.

Two collectives carry gradients, as ``shard_map`` transposes its boundary
in ``repro`` (``check_vma=False``):

* ``combine`` — the psum of the ranks' partials over the row axis: a psum
  in the forward, the identity in the backward, so each rank's partial gets
  the whole cotangent of its batch block (the pooled output is replicated
  over the row axis, and every rank holds the same cotangent of it);
* ``enter`` — a replicated operand entering a rank's partial (the R LUTs,
  the TT outer cores): the identity in the forward, a psum of the ranks'
  gradients over the axis in the backward, the transpose of the implicit
  broadcast.  Every operand goes in one all-reduce.

``norm_stat`` sums a norm's statistic over an axis whose ranks each hold a
slice of the normed dim: a sum in the forward and in the backward.

``all_gather`` rebuilds a tensor split along one dim over an axis (a
checkpoint's full logical leaf); ``reduce_scatter`` sums the ranks' tensors
over an axis and leaves each rank its block along one dim.  ``fsdp_gather``
is FSDP's parameter gather (``repro``'s params stored split along ``embed``
over ``data``, XLA gathering them before use): an ``all_gather`` of the
rank's block in the forward (site ``fsdp_gather``), a sum-``reduce_scatter``
of the whole cotangent back to the block in the backward (site
``fsdp_scatter``), so each rank's gradient of its block is the sum over the
axis already; ``gather_slices`` one split unevenly (the
vocab-parallel head's logits, whole on every rank for the serving loop's
``argmax``).  ``any_rank`` agrees a flag across every rank (the trainer's
stop flag).

On meta tensors (the dry run on ``launch.mesh.abstract_mesh``) every
collective counts its call and bytes in ``CALLS``, ``BYTES`` and ``SITES``
exactly as on a process group and returns a tensor of the right shape; it
calls nothing in ``torch.distributed``, and its mesh has no groups.

``compressed_psum`` agrees a shared scale first (a MAX of the local amax),
then sums int8 payloads in int32 and dequantizes by the shared scale.
``ef_step`` adds error feedback: the quantization residual is carried to
the next step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

CALLS = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
BYTES = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0}
# (site, axis) -> [calls, bytes]; sites: psum, pmax, combine, entry,
# grad_mean, norm, norm_stat, all_gather, logits, any_rank, fsdp_gather,
# fsdp_scatter
SITES: dict = {}


def reset_counts() -> None:
    for d in (CALLS, BYTES):
        for k in d:
            d[k] = 0
    SITES.clear()


def _count(op: str, site: str, axis, nbytes: int) -> None:
    CALLS[op] += 1
    BYTES[op] += nbytes
    rec = SITES.setdefault((site, axis), [0, 0])
    rec[0] += 1
    rec[1] += nbytes


def _all_reduce(x: torch.Tensor, mesh, axis: str, op, site: str = "psum") -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _count("all_reduce", site, axis, out.numel() * out.element_size())
    if out.device.type != "meta":
        dist.all_reduce(out, op=op, group=mesh.group(axis))
    return out


def psum(x: torch.Tensor, mesh, axis: str, *, site: str = "psum") -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``jax.lax.psum``), in
    ``x``'s dtype; returns a new tensor.  ``site`` names the call in
    ``SITES``."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, site)


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise max of ``x`` over the ranks of ``axis`` (``jax.lax.pmax``)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM, "combine")

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def combine(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks' partials summed over ``axis`` (``psum``); its backward is
    the identity: the sum is replicated over ``axis``, so each rank's
    partial takes the cotangent of its own copy whole, not the sum of the
    copies' (which would count it ``mesh.shape[axis]`` times)."""
    return _Combine.apply(x, mesh, axis)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, cols, *xs):
        ctx.mesh, ctx.axis, ctx.cols = mesh, axis, cols
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *cts):
        dtype = torch.promote_types(cts[0].dtype, torch.float32)
        pieces = [c if ranges is None else c[..., lo:hi]
                  for c, ranges in zip(cts, ctx.cols) for lo, hi in (ranges or ((0, 0),))]
        flat = torch.cat([p.reshape(-1).to(dtype) for p in pieces])
        flat = _all_reduce(flat, ctx.mesh, ctx.axis, dist.ReduceOp.SUM, "entry")
        out, at = [], 0
        for c, ranges in zip(cts, ctx.cols):
            if ranges is None:
                out.append(flat[at:at + c.numel()].view_as(c).to(c.dtype))
                at += c.numel()
                continue
            got = c.clone()
            for lo, hi in ranges:
                view = got[..., lo:hi]
                view.copy_(flat[at:at + view.numel()].view(view.shape))
                at += view.numel()
            out.append(got)
        return (None, None, None, *out)


def enter(xs, mesh, axis: str, cols=None) -> list:
    """Replicated operands ``xs`` entering this rank's partial: the same
    tensors in the forward; in the backward the ranks' gradients of them are
    summed over ``axis`` (one all-reduce for all of them, in fp32 or
    wider), since each rank's partial uses its own share of every replica
    (the R rows of its bag positions, the outer cores of its G2 rows).
    ``cols`` (one entry per operand) sums only the given column ranges of
    an operand's gradient, ``((lo, hi), ...)`` of its last dim, and leaves
    the rest as the rank's own (None: all of it): a fused weight whose
    other columns are the rank's own block (the Mamba2 ``in_proj``'s B and
    C, which every rank holds whole)."""
    cols = tuple(None for _ in xs) if cols is None else tuple(cols)
    if len(cols) != len(xs):
        raise ValueError(f"{len(cols)} column ranges for {len(xs)} operands")
    return list(_Enter.apply(mesh, axis, cols, *xs))


class _NormStat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x.float(), mesh, axis, dist.ReduceOp.SUM, "norm_stat")

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct, ctx.mesh, ctx.axis, dist.ReduceOp.SUM, "norm_stat"), None, None


def norm_stat(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """A norm's statistic summed over ``axis`` in fp32 (each rank's ``x``
    its partial sum over its slice of the normed dim: a gated RMS norm over
    the whole ``d_inner`` whose columns the ranks split by head).  Every
    rank scales its own slice by the summed statistic, so each rank's
    cotangent of it differs: the backward is a sum over ``axis`` too
    (``combine``'s identity would drop the other ranks' slices).  Counted
    under the site ``norm_stat``, forward and backward."""
    return _NormStat.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
               site: str = "all_gather") -> torch.Tensor:
    """The blocks of ``x`` that the ranks along ``axis`` hold, concatenated
    along ``dim`` in the order of their coordinates, on ``x``'s device (gloo
    gathers a card's tensor through host memory).  ``site`` names the call
    in ``SITES``."""
    home = x.device
    if mesh.backend == "gloo":
        x = x.cpu()
    x = x.contiguous()
    _count("all_gather", site, axis, x.numel() * x.element_size())
    parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
    if x.device.type != "meta":
        dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim).to(home)


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0, *,
                   site: str = "reduce_scatter") -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis``, of which this rank
    keeps its block along ``dim`` (``x.shape[dim]`` split in equal
    contiguous blocks, in the order of the ranks' coordinates), on ``x``'s
    device (gloo sums a card's tensor through host memory).  Counted under
    ``site`` with the bytes each rank puts in (the whole ``x``)."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis} ({n})")
    home = x.device
    flat = x.movedim(dim, 0)
    if mesh.backend == "gloo":
        flat = flat.cpu()
    flat = flat.contiguous()
    _count("reduce_scatter", site, axis, flat.numel() * flat.element_size())
    out = torch.empty((flat.shape[0] // n, *flat.shape[1:]), dtype=flat.dtype,
                      device=flat.device)
    if flat.device.type != "meta":
        dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out.movedim(0, dim).to(home)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return all_gather(x, mesh, axis, dim, site="fsdp_gather")

    @staticmethod
    def backward(ctx, ct):
        return (reduce_scatter(ct, ctx.mesh, ctx.axis, ctx.dim, site="fsdp_scatter"),
                None, None, None)


def fsdp_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The whole of a parameter whose rank's block along ``dim`` is ``x``
    (split over ``axis``): ``all_gather`` in the forward, site
    ``fsdp_gather``; in the backward the sum over ``axis`` of the ranks'
    whole cotangents, this rank's block of it (``reduce_scatter``, site
    ``fsdp_scatter``): each rank's gradient of its block is then summed
    over the ranks already, as the all-reduce of a replicated leaf's would
    be.  In ``x``'s dtype (the param's, as stored)."""
    return _FsdpGather.apply(x, mesh, axis, dim)


def gather_slices(x: torch.Tensor, mesh, axis: str, widths, *, site: str) -> torch.Tensor:
    """The whole tensor on every rank of ``axis`` from the ranks' slices of
    its last dim, rank i's ``widths[i]`` wide (uneven, in coordinate
    order; ``x`` this rank's): each slice padded to the widest, one
    ``all_gather`` (counted under ``site``), each trimmed back and the
    slices concatenated.  An axis of one rank returns ``x``."""
    if mesh.shape[axis] == 1:
        return x
    if x.shape[-1] != widths[mesh.axis_index(axis)]:
        raise ValueError(f"a slice of {x.shape[-1]} where rank "
                         f"{mesh.axis_index(axis)} of {list(widths)} holds "
                         f"{widths[mesh.axis_index(axis)]}")
    wide = max(widths)
    got = all_gather(torch.nn.functional.pad(x, (0, wide - x.shape[-1])), mesh, axis,
                     dim=-1, site=site)
    return torch.cat([got[..., i * wide:i * wide + w] for i, w in enumerate(widths)], dim=-1)


def any_rank(flag: bool, device) -> bool:
    """Whether any rank of the default process group passes a true
    ``flag`` (a MAX all-reduce over every rank)."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=device)
    _count("all_reduce", "any_rank", None, t.numel() * t.element_size())
    if t.device.type == "meta":
        return bool(flag)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


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
