"""Multi-table gather-and-reduce (GnR), the DLRM embedding-bag operator
(port of ``repro.core.embedding_bag``).

A recommendation batch carries, per sample and per sparse feature (table),
a multi-hot bag of ``pooling`` logical indices; GnR gathers each row and
reduces (sum / mean / weighted sum) into one pooled vector per (sample,
table).  ``bag_lookup`` is the per-table semantic path: plain torch gathers
and sums in the compute dtype, as ``repro``'s is jnp, except a TT table with
``tt_exec="pallas"``, which runs the TT-bag kernel K5.  The one-launch path
for packable sets is ``core.packed_tables.packed_multi_bag_lookup``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import hashing, qr_embedding, tt_embedding
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class BagConfig:
    """One sparse feature's table + pooling semantics."""

    emb: EmbeddingConfig
    pooling: int = 32                 # indices per bag (multi-hot degree)
    combiner: str = "sum"             # sum | mean


def init_tables(bags: Sequence[BagConfig], *, generator: torch.Generator,
                device: torch.device) -> list[dict]:
    return [qr_embedding.init(b.emb, generator=generator, device=device) for b in bags]


def table_axes(bags: Sequence[BagConfig]) -> list[dict]:
    return [qr_embedding.param_axes(b.emb) for b in bags]


def bag_lookup(params: dict, idx: torch.Tensor, bag: BagConfig,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Pooled lookup for one table: ``idx`` (batch, pooling) -> (batch, dim)
    in the compute dtype.

    For QR-add tables the reduction is pushed through the reconstruction,
    ``Σ_k (Q[q_k] + R[r_k]) = Σ_k Q[q_k] + Σ_k R[r_k]``, each sum in the
    compute dtype, as ``repro`` does.
    """
    emb = bag.emb
    if emb.kind == "qr" and emb.reconstruction == "add" and weights is None:
        q_idx, r_idx = hashing.qr_decompose(idx, emb.collision)
        q = params["q"].to(emb.compute_dtype)[q_idx.long()].sum(dim=-2)
        r = params["r"].to(emb.compute_dtype)[r_idx.long()].sum(dim=-2)
        pooled = q + r
    elif emb.kind == "tt" and emb.tt_exec == "pallas" and weights is None:
        spec = emb.tt_spec
        i1, i2, i3 = tt_embedding.tt_decompose(idx, spec)
        pooled = ops.tt_pooled_auto(
            params["g1"], params["g2"], params["g3"], i1, i2, i3,
            dims=spec.dims, exec_mode="pallas",
        ).to(emb.compute_dtype)
    else:
        vecs = qr_embedding.lookup(params, idx, emb)        # (batch, pooling, dim)
        if weights is not None:
            vecs = vecs * weights[..., None].to(vecs.dtype)
        pooled = vecs.sum(dim=-2)
    if bag.combiner == "mean":
        pooled = pooled / bag.pooling
    return pooled


def multi_bag_lookup(tables: Sequence[dict], indices: torch.Tensor,
                     bags: Sequence[BagConfig],
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """All-tables GnR, one table at a time: ``indices`` (batch, num_tables,
    pooling) -> (batch, num_tables, dim).  Tables may differ in vocab but
    share ``dim``."""
    outs = []
    for t, (params, bag) in enumerate(zip(tables, bags)):
        w = None if weights is None else weights[:, t]
        outs.append(bag_lookup(params, indices[:, t], bag, w))
    return torch.stack(outs, dim=1)


def traffic_model(bag: BagConfig, bytes_per_elem: int = 2) -> dict:
    """Analytic DRAM bytes per bag of weight sharing: the dense baseline,
    naive weight sharing (every physical row from DRAM) and LUT-fused
    execution (the shared table pinned on chip)."""
    emb, p = bag.emb, bag.pooling
    row = emb.dim * bytes_per_elem
    dense = p * row
    if emb.kind == "dense":
        return {"dense": dense, "naive": dense, "fused": dense}
    if emb.kind == "hashed":
        naive = p * emb.hashed_k * row
        return {"dense": dense, "naive": naive, "fused": naive}  # no tiny LUT to pin
    if emb.kind == "tt":
        spec = emb.tt_spec
        w1 = spec.g1_width * bytes_per_elem
        w2 = spec.g2_width * bytes_per_elem
        w3 = spec.g3_width * bytes_per_elem
        naive = p * (w1 + w2 + w3)           # all three cores from DRAM
        fused = p * w2                       # outer cores pinned on chip
        return {"dense": dense, "naive": naive, "fused": fused}
    naive = 2 * p * row                      # Q row + R row per index
    fused = p * row                          # R served from the on-chip LUT
    return {"dense": dense, "naive": naive, "fused": fused}
