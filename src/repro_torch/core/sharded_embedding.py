"""Two-level sharded gather-and-reduce, the paper's PIM scheme on a mesh of
ranks (port of ``repro.core.sharded_embedding``).

Mapping:

* bank-group PIM -> one rank holding a contiguous **row shard** of the
  Q / G2 / dense table; it gathers and partially reduces only the rows it
  owns ("local GnR");
* base-die PIM   -> one ``psum`` over the ``model`` mesh axis combining the
  per-shard pooled partials (one vector per bag, never raw rows);
* SRAM LUT       -> the R table (and the TT outer cores) **replicated** on
  every rank; R contributions are spread across shards by bag position;
* HBM hot tier   -> the hottest big-table rows replicated on every rank; the
  duplication planner's comm-free tables are whole replicas whose bags
  skip the combine altogether.

Associativity of the ``add`` reconstruction (linearity in G2 for TT) is what
makes this legal: a zeroed or zero-routed non-owned row contributes exactly
zero to the psum.

``repro`` runs the ``*_partial`` functions inside ``shard_map``; the port runs
them in each rank's process (``launch.mesh.spawn``) on the rank's local
shards, with the rank's ``Mesh`` in place of the axis name's context.
``packed_local_partial`` is one launch of the packed kernels (K1 for QR, K3
for dense, K2 for TT) over the rank's packed local buffer, which
``pack_local`` builds once per set of tables and hot tiers for serving.

Every partial is differentiable in the rank's tables, as ``repro``'s are
under ``jax.grad``: the gathers and masks are autograd ops, the packed
kernels take their plain-version recompute backward (``kernels/ops.py``)
and ``pack_local`` copies each table into the packed buffer inside
autograd (a training step packs afresh, in the compute dtype, as
``packed_tables.packed_multi_bag_lookup`` does on one card).  The
replicated operands (``REPLICATED``: the R LUTs, the TT outer cores) get
only this rank's share of their gradient (its bag positions, its G2 rows);
``enter_replicated`` passes them through ``collectives.enter``, whose
backward sums the shares over the row axis.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import hashing, packed_tables, tt_embedding
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.sharding import P, local_shard
from repro_torch.kernels import ops

# Q tables are padded so every potential model-axis size divides the row count.
ROW_PAD = 128

# each kind's params replicated on every rank of the row axis (the rest are
# row-sharded): ``repro``'s ``P()`` in_specs of ``engine._table_specs``
REPLICATED = {"qr": ("r",), "tt": ("g1", "g3"), "dense": (), "hashed": ()}


def enter_replicated(tables: Sequence[dict], bags: Sequence[BagConfig], mesh,
                     axis: str) -> list[dict]:
    """``tables`` with every replicated param passed through
    ``collectives.enter`` (one all-reduce of their gradients over ``axis``
    in the backward); the row-sharded params as they are.  A set without
    replicated params is returned unchanged."""
    keys = [(t, k) for t, bag in enumerate(bags) for k in REPLICATED[bag.emb.kind]]
    if not keys:
        return list(tables)
    entered = collectives.enter([tables[t][k] for t, k in keys], mesh, axis)
    out = [dict(p) for p in tables]
    for (t, k), x in zip(keys, entered):
        out[t][k] = x
    return out


def padded_q_rows(cfg: EmbeddingConfig) -> int:
    """Padded rows of the row-sharded ("big") table: Q for the QR path, the
    middle core G2 for the TT path, the whole table otherwise."""
    if cfg.kind == "qr":
        rows = cfg.qr_spec.q_rows
    elif cfg.kind == "tt":
        rows = cfg.tt_spec.v2
    else:
        rows = cfg.vocab
    return -(-rows // ROW_PAD) * ROW_PAD


def pad_q_table(table: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    rows = padded_q_rows(cfg)
    if table.shape[0] == rows:
        return table
    return torch.nn.functional.pad(table, (0, 0, 0, rows - table.shape[0]))


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Static description of one table's tiered sharding."""

    cfg: EmbeddingConfig
    num_shards: int                      # size of the row-shard ("model") axis
    num_hot: int = 0                     # replicated-tier rows (0 = no hot tier)

    @property
    def q_rows_padded(self) -> int:
        return padded_q_rows(self.cfg)

    @property
    def rows_per_shard(self) -> int:
        return self.q_rows_padded // self.num_shards


# ---------------------------------------------------------------------------
# local ("bank-group") partials, run by each rank on its local shards
# ---------------------------------------------------------------------------

def _owned_rows_gather(q_shard: torch.Tensor, q_idx: torch.Tensor, plan: ShardPlan,
                       mesh, axis: str, compute=None) -> torch.Tensor:
    """Gather rows of ``q_idx`` owned by this shard, in ``compute`` (default:
    the shard's dtype); zeros elsewhere.  Rows are cast after the gather
    (``repro`` casts the shard, which XLA fuses into the gather; eagerly that
    would cast the whole shard every call).

    q_shard: (rows_per_shard, dim) local.  q_idx: (...,) global Q-row ids.
    """
    shard = mesh.axis_index(axis)
    local = q_idx - shard * plan.rows_per_shard
    owned = (local >= 0) & (local < plan.rows_per_shard)
    local = torch.clamp(local, 0, plan.rows_per_shard - 1)
    rows = q_shard[local].to(compute or q_shard.dtype)
    return rows * owned[..., None].to(rows.dtype)


def _pos_mine(pooling: int, nsh: int, shard: int, device) -> torch.Tensor:
    """(pooling,) bool: the bag positions this shard serves from a
    replicated tier (position % shards == shard)."""
    return (torch.arange(pooling, dtype=torch.int32, device=device) % nsh) == shard


def _tiered_rows(big_shard, big_idx, plan, mesh, axis, compute, hot_table, hot_slot,
                 serve_hot):
    """Big-table rows of ``big_idx``: hot rows from the replicated tier where
    ``serve_hot`` holds, cold rows from the owner's shard, zeros elsewhere."""
    if hot_table is None:
        return _owned_rows_gather(big_shard, big_idx, plan, mesh, axis, compute)
    slot = hot_slot[big_idx]
    is_hot = slot >= 0
    hot_rows = hot_table[torch.clamp(slot, min=0)].to(compute)
    hot_rows = hot_rows * (is_hot & serve_hot)[..., None].to(compute)
    cold = _owned_rows_gather(big_shard, big_idx, plan, mesh, axis, compute)
    cold = cold * (~is_hot)[..., None].to(compute)
    return hot_rows + cold


def qr_bag_partial(q_shard: torch.Tensor, r_full: torch.Tensor, idx: torch.Tensor,
                   plan: ShardPlan, *, mesh, axis: str = "model",
                   hot_table: torch.Tensor | None = None,
                   hot_slot: torch.Tensor | None = None,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Local pooled partial for one QR-add bag. idx: (..., pooling) -> (..., dim).

    Tier routing per index: hot -> the replicated table, spread across
    shards by bag position; cold -> the owner shard's local Q shard; R -> the
    replicated LUT, spread by bag position.  The caller psums the result over
    ``axis`` (the base-die combine).
    """
    cfg = plan.cfg
    shard = mesh.axis_index(axis)
    q_idx, r_idx = hashing.qr_decompose(idx, cfg.collision)
    pos_mine = _pos_mine(idx.shape[-1], plan.num_shards, shard, idx.device)
    compute = cfg.compute_dtype
    q_rows = _tiered_rows(q_shard, q_idx, plan, mesh, axis, compute, hot_table, hot_slot,
                          pos_mine)
    r_rows = r_full[r_idx].to(compute) * pos_mine[..., None].to(compute)
    rows = q_rows + r_rows
    if weights is not None:
        rows = rows * weights[..., None].to(compute)
    return rows.sum(dim=-2)


def tt_bag_partial(g1_full: torch.Tensor, g2_shard: torch.Tensor, g3_full: torch.Tensor,
                   idx: torch.Tensor, plan: ShardPlan, *, mesh, axis: str = "model",
                   hot_table: torch.Tensor | None = None,
                   hot_slot: torch.Tensor | None = None,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Local pooled partial for one TT bag. idx: (..., pooling) -> (..., dim).

    The QR path's tier routing, applied to the middle core; G1/G3 are
    duplicated whole on every shard, so the full chained contraction runs
    where the G2 row lives and only the pooled vector crosses the network.
    The contraction is linear in G2: zeroed non-owned rows contribute
    exactly zero to the psum.
    """
    cfg = plan.cfg
    spec = cfg.tt_spec
    shard = mesh.axis_index(axis)
    i1, i2, i3 = tt_embedding.tt_decompose(idx, spec)
    pos_mine = _pos_mine(idx.shape[-1], plan.num_shards, shard, idx.device)
    compute = cfg.compute_dtype
    g2_rows = _tiered_rows(g2_shard, i2, plan, mesh, axis, compute, hot_table, hot_slot,
                           pos_mine)
    rows = tt_embedding.contract_rows(g1_full[i1].to(compute), g2_rows,
                                      g3_full[i3].to(compute), spec)
    if weights is not None:
        rows = rows * weights[..., None].to(compute)
    return rows.sum(dim=-2)


def dense_bag_partial(table_shard: torch.Tensor, idx: torch.Tensor, plan: ShardPlan, *,
                      mesh, axis: str = "model",
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Local pooled partial for a dense (non-weight-sharing) bag."""
    rows = _owned_rows_gather(table_shard, idx, plan, mesh, axis, plan.cfg.compute_dtype)
    if weights is not None:
        rows = rows * weights[..., None].to(rows.dtype)
    return rows.sum(dim=-2)


def qr_token_partial(q_shard: torch.Tensor, r_full: torch.Tensor, idx: torch.Tensor,
                     plan: ShardPlan, *, mesh, axis: str = "model",
                     hot_table: torch.Tensor | None = None,
                     hot_slot: torch.Tensor | None = None) -> torch.Tensor:
    """Per-token (no pooling) partial: idx (...,) -> (..., dim); psum over axis.

    R rows are replicated, so only shard 0 contributes them (no position
    axis to spread over); hot rows likewise.
    """
    cfg = plan.cfg
    first = mesh.axis_index(axis) == 0
    q_idx, r_idx = hashing.qr_decompose(idx, cfg.collision)
    compute = cfg.compute_dtype
    serve_hot = torch.tensor(first, device=idx.device)
    q_rows = _tiered_rows(q_shard, q_idx, plan, mesh, axis, compute, hot_table, hot_slot,
                          serve_hot)
    r_rows = r_full[r_idx].to(compute) * float(first)
    return q_rows + r_rows


# ---------------------------------------------------------------------------
# packed-table local GnR: one kernel launch per rank
# ---------------------------------------------------------------------------

def _packed_rows(parts: Sequence[torch.Tensor], dtype, *, zero_row: bool) -> torch.Tensor:
    """Row-concatenate ``parts`` cast to ``dtype`` into one new buffer (each
    part copied in place, no cast copy of the whole set), with one trailing
    all-zero row if ``zero_row`` (``repro``'s ``concat_with_zero(parts,
    dtype)``).  Differentiable: each slice's ``copy_`` hands its part the
    buffer gradient's rows, cast back to the part's dtype."""
    rows = sum(int(p.shape[0]) for p in parts)
    out = torch.empty((rows + int(zero_row), parts[0].shape[1]), dtype=dtype,
                      device=parts[0].device)
    at = 0
    for p in parts:
        out[at:at + p.shape[0]].copy_(p)
        at += p.shape[0]
    if zero_row:
        out[rows:].zero_()
    return out


def _col(values, device, dtype=torch.int32) -> torch.Tensor:
    """(T,) values as a (1, T, 1) tensor on ``device``."""
    return torch.tensor(list(values), dtype=dtype).to(device)[None, :, None]


@dataclasses.dataclass(frozen=True, eq=False)
class LocalPack:
    """One rank's packed local buffers and the per-table routing constants.

    ``buffers`` are the packed kernel buffers in the compute dtype: the
    rank's big-subtable segments (its row shard, or the whole table where
    comm-free), then the hot-tier segments, then one zero row; the R LUTs
    (QR, with a zero row) or the outer cores (TT); a 1-row zero cache
    (every slot misses).  The (1, T, 1) tensors hold each table's segment
    offset, rows a shard, comm-free flag and hot-segment offset, the R
    LUTs' offsets (QR)."""

    buffers: dict
    seg_off: torch.Tensor
    rows_per_shard: torch.Tensor
    comm_free: torch.Tensor
    zero_row: int
    scale: torch.Tensor                            # (T,) fp32 combiner scale
    hot_off: torch.Tensor | None = None
    hot_slot: torch.Tensor | None = None           # (T, big rows) int32
    r_off: torch.Tensor | None = None
    r_zero: int = 0


def pack_local(tables: Sequence[dict], bags: Sequence[BagConfig],
               plans: Sequence[ShardPlan], *, hot_tiers: Sequence[dict] | None = None,
               comm_free: Sequence[bool] | None = None) -> LocalPack:
    """Build this rank's ``LocalPack`` from its local tables: the
    concatenation ``repro``'s ``packed_local_partial`` does inside every
    (jitted) call.  Serving builds it once (``EmbeddingEngine.local_pack``),
    since in eager PyTorch it is a copy of the whole local shard (1.66 GB at
    dlrm-dense 1M rows on 4 ranks); under grad it is built in every call,
    inside autograd, so the buffers' gradients reach the tables."""
    emb0 = bags[0].emb
    kind, compute = emb0.kind, emb0.compute_dtype
    num_t = len(bags)
    cf = tuple(bool(c) for c in (comm_free or [False] * num_t))
    big_key = packed_tables.big_key(kind)
    segs = [tables[t][big_key] for t in range(num_t)]
    dev = segs[0].device
    parts = list(segs)
    hot_sizes: list[int] = []
    if hot_tiers is not None:
        hots = [hot_tiers[t]["hot_table"] for t in range(num_t)]
        hot_sizes = [int(h.shape[0]) for h in hots]
        parts += hots
    seg_off = np.cumsum([0] + [int(s.shape[0]) for s in segs])
    hot_off = seg_off[-1] + np.cumsum([0] + hot_sizes)
    buffers = {big_key: _packed_rows(parts, compute, zero_row=True),
               "cache": torch.zeros((1, segs[0].shape[1]), dtype=compute, device=dev)}
    extra = {}
    if hot_tiers is not None:
        extra["hot_off"] = _col(hot_off[:num_t], dev)
        extra["hot_slot"] = torch.stack(
            [hot_tiers[t]["hot_slot"].to(dev, torch.int32) for t in range(num_t)])
    if kind == "qr":
        r_segs = [tables[t]["r"] for t in range(num_t)]
        r_off = np.cumsum([0] + [int(r.shape[0]) for r in r_segs])
        buffers["r"] = _packed_rows(r_segs, compute, zero_row=True)
        extra["r_off"] = _col(r_off[:num_t], dev)
        extra["r_zero"] = int(r_off[-1])
    elif kind == "tt":
        buffers["g1"] = _packed_rows([tables[t]["g1"] for t in range(num_t)], compute,
                                     zero_row=False)
        buffers["g3"] = _packed_rows([tables[t]["g3"] for t in range(num_t)], compute,
                                     zero_row=False)
    return LocalPack(
        buffers=buffers, seg_off=_col(seg_off[:num_t], dev),
        rows_per_shard=_col([p.rows_per_shard for p in plans], dev),
        comm_free=_col(cf, dev, torch.bool), zero_row=int(hot_off[-1]),
        scale=packed_tables.combiner_scale(bags, torch.float32, dev), **extra)


def packed_local_partial(
    tables: Sequence[dict],
    indices: torch.Tensor,
    bags: Sequence[BagConfig],
    plans: Sequence[ShardPlan],
    *,
    mesh,
    axis: str = "model",
    hot_tiers: Sequence[dict] | None = None,
    comm_free: Sequence[bool] | None = None,
    pack: LocalPack | None = None,
) -> torch.Tensor:
    """Every table's local pooled partial in ONE kernel launch.

    The per-table loop of ``*_bag_partial`` calls becomes index arithmetic
    over this rank's packed local buffer (``pack``, else built here by
    ``pack_local``): every access is *routed* instead of masked —

      hot row & my bag position  -> its hot-segment slot,
      cold row owned here        -> the local-shard segment,
      anything else              -> the zero row (contributes nothing),

    so the single ``ops.packed_multi_pooled`` call (K1 / K3 / K2) computes
    partials whose psum over ``axis`` counts every contribution exactly
    once.  R LUTs (QR) are spread across shards by bag position; TT outer
    cores are packed replicated.  Every slot misses (a one-row cache).

    ``comm_free[t]`` marks tables whose params are full local replicas:
    every access is served locally and their output columns must be
    EXCLUDED from the caller's psum.  Returns (B, T, dim) partials in the
    compute dtype, differentiable in ``tables`` when ``pack`` is None (the
    buffers are then packed here, inside autograd).
    """
    emb0 = bags[0].emb
    kind, compute = emb0.kind, emb0.compute_dtype
    num_t = len(bags)
    if pack is None:
        pack = pack_local(tables, bags, plans, hot_tiers=hot_tiers, comm_free=comm_free)
    shard = mesh.axis_index(axis)
    dev = indices.device
    pos_mine = _pos_mine(indices.shape[-1], plans[0].num_shards, shard, dev)[None, None, :]
    cf_b = pack.comm_free
    indices = indices.to(torch.int32)

    def route_big(big_idx: torch.Tensor) -> torch.Tensor:
        """Table-local big-subtable rows (B, T, K) -> packed stream rows."""
        local = big_idx - shard * pack.rows_per_shard
        owned = ((local >= 0) & (local < pack.rows_per_shard)) | cf_b
        local = torch.where(cf_b, big_idx, local)          # replicas: global row
        stream = torch.where(owned, pack.seg_off + local, pack.zero_row)
        if pack.hot_slot is not None:
            t_ids = torch.arange(num_t, dtype=torch.int32, device=dev)[None, :, None]
            slot = pack.hot_slot[t_ids, big_idx]
            stream = torch.where(
                slot >= 0, torch.where(pos_mine, pack.hot_off + slot, pack.zero_row), stream)
        return stream.to(torch.int32)

    miss = packed_tables.miss_slots(indices)
    # the zero rows take no part in the backward's recompute: their
    # gradients are discarded (one shard routes nothing there)
    sharded = plans[0].num_shards > 1
    big_sink = {{"qr": "q_idx", "tt": "i2"}.get(kind, "idx"): pack.zero_row} if sharded else {}
    if kind == "qr":
        q_idx, r_idx = hashing.qr_decompose(indices, emb0.collision)
        # replicated LUT: spread across shards by bag position; comm-free
        # tables take every position (their column skips the psum)
        r_stream = torch.where(pos_mine | cf_b, pack.r_off + r_idx, pack.r_zero)
        out = ops.packed_multi_pooled(
            pack.buffers, {"q_idx": route_big(q_idx), "slot": miss,
                           "r_idx": r_stream.to(torch.int32)}, kind="qr",
            sinks={**big_sink, "r_idx": pack.r_zero} if sharded else None)
    elif kind == "tt":
        spec = emb0.tt_spec
        i1, i2, i3 = tt_embedding.tt_decompose(indices, spec)
        t_ids = torch.arange(num_t, dtype=torch.int32, device=dev)[None, :, None]
        out = ops.packed_multi_pooled(
            pack.buffers, {"i1": (i1 + t_ids * spec.v1).to(torch.int32), "i2": route_big(i2),
                           "i3": (i3 + t_ids * spec.v3).to(torch.int32), "slot": miss},
            kind="tt", dims=spec.dims, sinks=big_sink)
    else:
        out = ops.packed_multi_pooled(pack.buffers, {"idx": route_big(indices), "slot": miss},
                                      kind="dense", sinks=big_sink)
    return (out * pack.scale[None, :, None].to(out.dtype)).to(compute)


def make_dup_hot_tiers(tables: Sequence[dict], bags: Sequence[BagConfig], dup_plan) -> list:
    """Hot-tier tensors per table from a DuplicationPlan: one
    ``{"hot_table", "hot_slot"}`` dict per bag, built from the GLOBAL tables
    (a hot row may sit in any shard); tables with nothing to replicate get a
    1-row dummy whose slot map never matches."""
    tiers = []
    for params, _bag, tp in zip(tables, bags, dup_plan.tables):
        big = params.get("q", params.get("g2", params.get("table")))
        rows = tp.hot_plan.hot_slot.size
        if tp.comm_free or tp.hot_plan.num_hot == 0:
            tiers.append({
                "hot_table": torch.zeros((1, big.shape[1]), dtype=big.dtype, device=big.device),
                "hot_slot": torch.full((rows,), -1, dtype=torch.int32, device=big.device),
            })
        else:
            hot_rows = torch.as_tensor(tp.hot_plan.hot_rows, dtype=torch.long, device=big.device)
            tiers.append({
                "hot_table": big[hot_rows],
                "hot_slot": torch.as_tensor(tp.hot_plan.hot_slot, dtype=torch.int32,
                                            device=big.device),
            })
    return tiers


# ---------------------------------------------------------------------------
# this rank's shards of the global params
# ---------------------------------------------------------------------------

def shard_qr_params(params: dict, cfg: EmbeddingConfig, mesh, *,
                    row_axis: str = "model") -> dict:
    """This rank's params in the tiered layout (``repro`` device-puts the
    global params with these shardings): the big subtable padded and
    row-sharded over ``row_axis`` (Q, the TT middle core G2, the dense
    table), the R LUT and the TT outer cores replicated."""
    row = P(row_axis, None)
    if "q" in params:
        return {"q": local_shard(pad_q_table(params["q"], cfg), mesh, row),
                "r": params["r"]}
    if "g2" in params:
        return {"g1": params["g1"],
                "g2": local_shard(pad_q_table(params["g2"], cfg), mesh, row),
                "g3": params["g3"]}
    return {"table": local_shard(pad_q_table(params["table"], cfg), mesh, row)}


def build_token_embed(mesh, cfg: EmbeddingConfig, *, batch_axis: str = "data",
                      row_axis: str = "model", hot: bool = False):
    """Token-embedding lookup, two-level scheme: ``fn(params, idx, tier=None)``
    on this rank's shards (``shard_qr_params``) and its batch shard ``idx``
    (B_local, S) -> (B_local, S, dim), one psum over ``row_axis``.
    ``batch_axis`` names the axis ``idx`` is split over (the caller's
    ``local_shard(idx, mesh, P(batch_axis))``)."""
    nsh = mesh.shape[row_axis]
    plan = ShardPlan(cfg, nsh)

    def fn(params, idx, tier=None):
        if hot and tier is None:
            raise ValueError("build_token_embed(hot=True) needs the hot tier")
        if cfg.kind == "qr":
            part = qr_token_partial(
                params["q"], params["r"], idx, plan, mesh=mesh, axis=row_axis,
                hot_table=None if tier is None else tier["hot_table"],
                hot_slot=None if tier is None else tier["hot_slot"])
        else:
            part = _owned_rows_gather(params["table"], idx, plan, mesh, row_axis,
                                      cfg.compute_dtype)
        return collectives.psum(part, mesh, row_axis)

    return fn


# what brings the vocabularies a meshed LM does not run yet
MESHED_VOCAB_ITEM = "ROADMAP.md §1 item 8 (TT and hashed vocabularies on a mesh)"


def token_embed_inline(params: dict, idx: torch.Tensor, cfg: EmbeddingConfig, *,
                       mesh, row_axis: str = "model") -> torch.Tensor:
    """Two-level GnR token embedding inside the model: (B_local, S) tokens ->
    (B_local, S, dim) in the compute dtype, on this rank's Q shard (QR-add)
    or row shard (dense) of ``params``.

    ``mesh`` must have a ``row_axis``; off one the single card's lookup is
    ``transformer.embed_tokens``'s, as ``repro``'s fallback.  Each rank
    routes its token stream before one ``ops.qr_lookup`` launch (K8) on its
    shard: a Q row it does not own goes to the zero row appended to its Q
    shard, and on every rank but the axis's first each R index goes to the
    zero row appended to R; then one ``collectives.combine`` over
    ``row_axis`` sums the partials (the base-die level).  The backward is
    K8's chunked recompute with the zero rows as sinks, and R's gradient,
    which only the first rank's lookups give, is summed over the axis
    (``collectives.enter``).  In fp32 every partial but the owner's and the
    first rank's is an exact zero, so the result is bitwise the single
    card's; in bf16 the combine adds the owner's Q row and the first rank's
    R row in the compute dtype, as ``repro``'s psum does.

    A dense vocabulary takes the owned-rows gather of its row shard and the
    same combine (Megatron's vocab-parallel embedding).  TT and hashed
    vocabularies, and QR with ``mul`` / ``concat``, raise."""
    if row_axis not in mesh.shape:
        raise ValueError(f"token_embed_inline needs a mesh with a {row_axis!r} axis, "
                         f"not {dict(mesh.shape)}")
    nsh, shard = mesh.shape[row_axis], mesh.axis_index(row_axis)
    plan = ShardPlan(cfg, nsh)
    if cfg.kind not in ("qr", "dense") or (cfg.kind == "qr" and cfg.reconstruction != "add"):
        what = cfg.kind if cfg.kind != "qr" else f"QR-{cfg.reconstruction}"
        raise NotImplementedError(f"a {what} vocabulary on a mesh: {MESHED_VOCAB_ITEM} "
                                  f"brings it")
    big = params["q" if cfg.kind == "qr" else "table"]
    if plan.q_rows_padded % nsh or big.shape[0] != plan.rows_per_shard:
        raise ValueError(f"a {row_axis} axis of {nsh} does not split the "
                         f"{plan.q_rows_padded} padded rows; this rank holds {big.shape[0]}")
    compute = cfg.compute_dtype
    if cfg.kind == "dense":
        part = _owned_rows_gather(big, idx, plan, mesh, row_axis, compute)
        return collectives.combine(part, mesh, row_axis)
    rps, c = plan.rows_per_shard, cfg.collision
    q_idx, r_idx = hashing.qr_decompose(idx, c)
    local = q_idx - shard * rps
    q_stream = torch.where((local >= 0) & (local < rps), local, rps).to(torch.int32)
    r_stream = (r_idx if shard == 0 else torch.full_like(r_idx, c)).to(torch.int32)
    [r] = collectives.enter([params["r"]], mesh, row_axis)
    part = ops.qr_lookup(_packed_rows([big], compute, zero_row=True),
                         _packed_rows([r], compute, zero_row=True), q_stream, r_stream,
                         sinks={"q_idx": rps, "r_idx": c})
    return collectives.combine(part, mesh, row_axis)
