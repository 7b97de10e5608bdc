"""The kernels' public entry points (port of ``repro.kernels.ops``): one
launch for every table's pooled bag (``packed_multi_pooled``, kinds ``qr``,
``dense`` and ``tt``), the per-table bags (``gnr_pooled`` K6,
``gnr_pooled_dense`` K7, ``cached_pooled`` K4a, ``cached_qr_pooled`` K4b),
the unpooled QR gather ``qr_lookup`` (K8), the TT bag entry points
``tt_pooled``, ``tt_pooled_auto`` and ``tt_lookup`` (K5), and attention,
``flash_attention_fused`` (K9).

The streams may carry any leading shape (..., K) (``qr_lookup``: any shape
(...,)); they are flattened to the kernels' (G, K) / (N,) layout and the
output restored to (..., dim).  The device of the tensors picks the kernel
(CUDA) or its plain version (CPU).  ``dim_block`` is ``repro``'s TPU lane
tile: an explicit one is checked against ``repro``'s ladder and raises
``ValueError`` where ``repro`` does; the CUDA kernels take every dim and do
not read it.

Every entry is differentiable in its tables, as ``repro``'s kernel paths are
through their reference-recompute vjps (``repro/kernels/ops.py:135-159,
359-442``): the forward is the kernel, the backward recomputes the plain
version in ``ref`` and differentiates it (no kernel has a backward kernel,
in ``repro`` either).  The index streams get no gradient.  The recompute
runs over chunks of bags whose gathered rows stay near ``RECOMPUTE_BYTES``
of fp32, on fp32 copies of the buffers (widened once per backward) with the
cotangent widened to fp32: every chunk's gradient is built in fp32, the
chunks are summed into one fp32 gradient, and that is rounded once to the
buffer's dtype.  The gradient is linear in the bags, so the chunking changes
only the order of fp32 summation: a bf16 gradient lies within one bf16
rounding (2^-8 of its value, plus the fp32 sums' order) of the exact fp32
gradient of the plain version, whatever ``RECOMPUTE_BYTES`` is.  This is
tighter than ``repro``'s own bf16 vjp, whose index scatter accumulates in
bf16.  Without the chunks the TT recompute at dlrm-tt's training batch
(8,192 x 26 bags of 32) would gather one 8 KiB G2 row per element: ~56 GB.

On meta tensors (the dry run) each entry's forward is its kernel's meta
call (``bounds.META``), never the plain version, and the backward runs the
chunked recompute as the card does, on meta; a recompute with sinks raises
``ValueError``: which accesses it keeps depends on the index values.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import cached_gather, gnr_bag, packed_gather, qr_gather, ref
from repro_torch.kernels import flash_attention, tt_gather
from repro_torch.tune import knobs

RECOMPUTE_BYTES = 1 << 30      # fp32 rows a recompute chunk may gather


class _KernelRecompute(torch.autograd.Function):
    """Kernel forward; the backward recomputes the plain version over
    chunks of the streams' leading dim and sums the buffers' gradients.

    ``sinks`` lists ``(stream, row, buffers)`` groups: every access whose
    ``stream`` entry is ``row`` (a sink, whose gradient the caller
    discards) is left out of the recompute that gives ``buffers``'
    gradients.  The kept accesses of each chunk are taken in order as bags
    of one (the cotangent of their bag beside each), so every kept row sums
    the same terms in the same order as without the groups.  A group may
    name a buffer the stream does not index only where the sink row zeroes
    the access's whole contribution (a TT middle core's zero row)."""

    @staticmethod
    def forward(ctx, kernel, plain, streams, row_width, sinks, *buffers):
        ctx.plain, ctx.streams, ctx.row_width, ctx.sinks = plain, streams, row_width, sinks
        ctx.save_for_backward(*buffers)
        out = kernel(*buffers, *streams)
        ctx.out_dtype = out.dtype                  # the table dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        buffers = ctx.saved_tensors
        need = [i for i, b in enumerate(buffers) if ctx.needs_input_grad[5 + i]]
        grads = [None] * len(buffers)
        if not need:
            return (None,) * 5 + tuple(grads)
        # repro casts the cotangent to the table dtype; the recompute is fp32
        ct = ct.to(ctx.out_dtype).float()
        wide = [b.detach().float() for b in buffers]           # widened once
        per_bag = ctx.streams[0][:1].numel() * ctx.row_width * 4
        chunk = max(1, RECOMPUTE_BYTES // max(per_bag, 1))
        sums = {}
        grouped = set()
        for stream, row, bufs in ctx.sinks:
            want = [i for i in bufs if i in need]
            grouped.update(want)
            sums.update(_recompute(ctx.plain, wide, ctx.streams, ct, want, chunk,
                                   keep=(stream, row)))
        rest = [i for i in need if i not in grouped]
        sums.update(_recompute(ctx.plain, wide, ctx.streams, ct, rest, chunk))
        for i in need:
            grads[i] = sums[i].to(buffers[i].dtype)             # rounded once
        return (None,) * 5 + tuple(grads)


def _recompute(plain, wide: list, streams: tuple, ct: torch.Tensor, need: list,
               chunk: int, keep: tuple | None = None) -> dict:
    """fp32 gradients of the buffers ``need`` (indices into ``wide``): the
    plain version differentiated chunk by chunk over ``chunk`` bags, the
    chunks summed in order.  ``keep = (stream, row)`` recomputes only the
    accesses whose ``stream`` entry is not ``row``, each a bag of one."""
    sums = {}
    if not need:
        return sums
    for lo in range(0, streams[0].shape[0], chunk):
        part = [s[lo:lo + chunk] for s in streams]
        cot = ct[lo:lo + chunk]
        if keep is not None:
            stream, row = keep
            if part[stream].device.type == "meta":
                raise ValueError("ops._recompute with sinks on meta tensors: the accesses "
                                 "it keeps (those not routed to a sink row) depend on the "
                                 "index values, which a meta trace does not have")
            kept = (part[stream] != row).reshape(-1).nonzero().squeeze(1)
            if kept.numel() == 0:
                continue
            if part[stream].dim() == 1:             # unpooled lookups: one row each
                part = [s[kept] for s in part]
                cot = cot[kept]
            else:
                k = part[stream].shape[-1]
                part = [s.reshape(-1)[kept][:, None] for s in part]
                cot = cot[kept // k]
        leaves = [w.detach().requires_grad_(i in need) for i, w in enumerate(wide)]
        with torch.enable_grad():
            out = plain(*leaves, *part)
            got = torch.autograd.grad(out, [leaves[i] for i in need], cot)
        for i, g in zip(need, got):
            if i in sums:
                sums[i] += g
            else:
                sums[i] = g
    return {i: sums[i] if i in sums else torch.zeros_like(wide[i]) for i in need}


def _diff(kernel, plain, buffers: tuple, streams: tuple, row_width: int, *,
          sinks: tuple = (), **kw) -> torch.Tensor:
    """``kernel(*buffers, *streams, **kw)`` with the plain version's
    chunked-recompute gradient in the buffers; ``row_width`` is the widest
    row one stream element gathers (it sizes the chunks); ``sinks`` the
    recompute's ``(stream, row, buffers)`` groups (``_KernelRecompute``)."""
    if kw:
        kernel = functools.partial(kernel, **kw)
        plain = functools.partial(plain, **kw)
    return _KernelRecompute.apply(kernel, plain, streams, row_width, tuple(sinks), *buffers)


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
              r_idx: torch.Tensor, *, dim_block: int | None = None,
              sinks: dict | None = None) -> torch.Tensor:
    """Unpooled QR rows for any index shape (...,) -> (..., dim): K8.

    ``sinks`` maps ``q_idx`` / ``r_idx`` to an all-zero row of its table
    whose gradient the caller discards (a rank's zero rows,
    ``sharded_embedding.token_embed_inline``): the backward leaves the
    lookups routed there out of that table's recompute."""
    _check_dim_block(q_table.shape[1], dim_block)
    groups = tuple((i, int(sinks[name]), (i,)) for i, name in enumerate(("q_idx", "r_idx"))
                   if name in (sinks or {}))
    out = _diff(qr_gather.qr_gather, ref.qr_lookup_ref, (q_table, r_lut),
                (q_idx.reshape(-1), r_idx.reshape(-1)), q_table.shape[1], sinks=groups)
    return out.reshape(*q_idx.shape, out.shape[-1])


def gnr_pooled(q_table: torch.Tensor, r_lut: torch.Tensor, q_idx: torch.Tensor,
               r_idx: torch.Tensor, *, dim_block: int | None = None) -> torch.Tensor:
    """Pooled QR bag for index shape (..., K) -> (..., dim): K6."""
    _check_dim_block(q_table.shape[1], dim_block)
    out = _diff(gnr_bag.gnr_bag, ref.gnr_bag_ref, (q_table, r_lut),
                (_flat(q_idx), _flat(r_idx)), q_table.shape[1])
    return out.reshape(*q_idx.shape[:-1], out.shape[-1])


def gnr_pooled_dense(table: torch.Tensor, idx: torch.Tensor, *,
                     dim_block: int | None = None) -> torch.Tensor:
    """Pooled dense bag for index shape (..., K) -> (..., dim): K7."""
    _check_dim_block(table.shape[1], dim_block)
    out = _diff(gnr_bag.gnr_bag_dense, ref.dense_bag_ref, (table,), (_flat(idx),),
                table.shape[1])
    return out.reshape(*idx.shape[:-1], out.shape[-1])


def cached_pooled(table: torch.Tensor, cache: torch.Tensor, idx: torch.Tensor,
                  slot: torch.Tensor, *, dim_block: int | None = None) -> torch.Tensor:
    """Cached pooled bag for index shape (..., K) -> (..., dim): K4a.

    ``cache`` is the prefetch scheduler's staged block; ``slot`` its
    per-access routing (-1 = miss -> the table row)."""
    _check_dim_block(table.shape[1], dim_block)
    out = _diff(cached_gather.cached_bag, ref.cached_bag_ref, (table, cache),
                (_flat(idx), _flat(slot)), table.shape[1])
    return out.reshape(*idx.shape[:-1], out.shape[-1])


def cached_qr_pooled(q_table: torch.Tensor, cache: torch.Tensor, r_lut: torch.Tensor,
                     q_idx: torch.Tensor, slot: torch.Tensor, r_idx: torch.Tensor, *,
                     dim_block: int | None = None) -> torch.Tensor:
    """Cached pooled QR bag for index shape (..., K) -> (..., dim): K4b."""
    _check_dim_block(q_table.shape[1], dim_block)
    out = _diff(cached_gather.cached_qr_bag, ref.cached_qr_bag_ref, (q_table, cache, r_lut),
                (_flat(q_idx), _flat(slot), _flat(r_idx)), q_table.shape[1])
    return out.reshape(*q_idx.shape[:-1], out.shape[-1])


# each kind's streams and buffers, in the kernels' argument order
PACKED_STREAMS = {"qr": ("q_idx", "slot", "r_idx"), "dense": ("idx", "slot"),
                  "tt": ("i1", "i2", "i3", "slot")}
PACKED_BUFFERS = {"qr": ("q", "cache", "r"), "dense": ("table", "cache"),
                  "tt": ("g1", "g2", "g3", "cache")}
# the buffers whose gradient a stream's sink row decides: its own table, and
# for the TT middle core the outer cores too (a zero G2 row zeroes the row)
SINK_BUFFERS = {("qr", "q_idx"): ("q",), ("qr", "r_idx"): ("r",), ("dense", "idx"): ("table",),
                ("tt", "i2"): ("g1", "g2", "g3")}


def packed_multi_pooled(params: dict, streams: dict, *, kind: str,
                        dims: tuple[int, int, int, int] | None = None,
                        sinks: dict | None = None) -> torch.Tensor:
    """``params``: packed buffers — dense {"table", "cache"}, qr {"q", "cache",
    "r"}, tt {"g1", "g2", "g3", "cache"}; ``streams``: globally offset int32
    (..., K) streams — dense {"idx", "slot"}, qr {"q_idx", "slot", "r_idx"},
    tt {"i1", "i2", "i3", "slot"}; ``dims`` = (d1, d2, d3, rank) for tt.
    Returns (..., dim); differentiable in the packed buffers (the training
    lookup), ``repro``'s ``_packed_{qr,dense,tt}_diff``.

    ``sinks`` maps a stream (dense ``idx``, qr ``q_idx`` / ``r_idx``, tt
    ``i2``) to an all-zero row of its buffer whose gradient the caller
    discards (a rank's zero row, ``core/sharded_embedding.py``): the
    backward leaves the accesses routed there out of its recompute, and
    the gradients of every other row are those of the full recompute."""
    if kind not in PACKED_STREAMS:
        raise ValueError(f"packed_multi_pooled: unsupported kind {kind!r}")
    names, bufs = PACKED_STREAMS[kind], PACKED_BUFFERS[kind]
    first = streams[names[0]]
    tables = first.shape[-2] if first.dim() >= 3 else 1   # (..., T, K): the bag grid's T
    groups = tuple((names.index(name), int(row),
                    tuple(bufs.index(b) for b in SINK_BUFFERS[(kind, name)]))
                   for name, row in (sinks or {}).items())
    flat = tuple(_flat(streams[n]) for n in names)
    buffers = tuple(params[b] for b in bufs)
    if kind == "qr":
        out = _diff(functools.partial(packed_gather.packed_qr_bag, tables=tables),
                    ref.packed_qr_bag_ref, buffers, flat, params["q"].shape[1], sinks=groups)
    elif kind == "dense":
        out = _diff(functools.partial(packed_gather.packed_bag, tables=tables),
                    ref.packed_bag_ref, buffers, flat, params["table"].shape[1],
                    sinks=groups)
    else:
        out = _diff(packed_gather.packed_tt_bag, ref.packed_tt_bag_ref, buffers, flat,
                    params["g2"].shape[1], sinks=groups, dims=dims)
    return out.reshape(*first.shape[:-1], out.shape[-1])


def tt_pooled(g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
              i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, *,
              dims: tuple[int, int, int, int]) -> torch.Tensor:
    """``repro``'s public uncached TT bag, index shape (..., K) -> (..., dim):
    the TT-bag kernel K5 (``tt_pooled_auto(exec_mode="pallas")``) for every
    dim.  ``repro``'s ``dim % 8`` fallback to its jnp reference is a TPU
    tiling rule and is not ported (``kernels/tt_gather.py``)."""
    return tt_pooled_auto(g1, g2, g3, i1, i2, i3, dims=dims, exec_mode="pallas")


def tt_pooled_auto(g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
                   i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, *,
                   dims: tuple[int, int, int, int], exec_mode: str = "jnp"
                   ) -> torch.Tensor:
    """Pooled TT bag for index shape (..., K) -> (..., dim), dispatched by
    the config's ``tt_exec``: ``"pallas"`` is the TT-bag kernel K5 (its plain
    version on CPU tensors), differentiable in the cores as ``repro``'s
    ``_tt_pooled_diff``; ``"jnp"`` always the plain version (the names are
    ``repro``'s)."""
    if exec_mode == "jnp":
        return ref.tt_bag_ref(g1, g2, g3, i1, i2, i3, dims=dims)
    if exec_mode != "pallas":
        raise ValueError(f"tt_pooled_auto: unknown exec_mode {exec_mode!r}")
    lead = i1.shape[:-1]
    out = _diff(tt_gather.tt_bag, ref.tt_bag_ref, (g1, g2, g3),
                (_flat(i1), _flat(i2), _flat(i3)), g2.shape[1], dims=dims)
    return out.reshape(*lead, out.shape[-1])


def tt_lookup(g1: torch.Tensor, g2: torch.Tensor, g3: torch.Tensor,
              i1: torch.Tensor, i2: torch.Tensor, i3: torch.Tensor, *,
              dims: tuple[int, int, int, int]) -> torch.Tensor:
    """Unpooled TT rows for any index shape (...,) -> (..., dim): K5 with
    K = 1 per lookup."""
    shape = i1.shape
    out = _diff(tt_gather.tt_bag, ref.tt_bag_ref, (g1, g2, g3),
                (i1.reshape(-1, 1), i2.reshape(-1, 1), i3.reshape(-1, 1)), g2.shape[1],
                dims=dims)
    return out.reshape(*shape, out.shape[-1])


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, p_bf16: bool = False) -> torch.Tensor:
    """Attention through the kernel K9 with a blockwise-recompute backward.

    q: (B, H, Sq, D); k/v: (B, KH, Skv, D); GQA via KH | H; the causal mask
    is top-left aligned (query i sees key j iff i >= j); ``p_bf16`` rounds
    the probabilities to bf16 (``repro``'s ``flash_block_dtype="bf16"``)."""
    return flash_attention.flash_mha(q, k, v, causal, p_bf16)
