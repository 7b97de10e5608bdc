"""DLRM — the paper's own model family (port of ``repro.models.dlrm``).

Dense features -> bottom MLP; sparse features -> the packed embedding bags
(``repro_torch.engine``); pairwise-dot interaction; top MLP -> CTR logit.
The head runs in the config's compute dtype (bf16), as ``repro``'s does;
its products are ``torch.matmul``, as ``repro`` left them to XLA.
``forward_dlrm`` is the training forward (the embedding layer through
``EmbeddingEngine.inline_gnr``: the single-card ``lookup`` without a mesh;
under ``sharding.use_rules(mesh, ...)`` the two-level sharded GnR on this
rank's row-sharded tables and batch shard; differentiable on both);
``forward_from_pooled`` the serving head; ``bce_loss`` and ``auc`` the
training loss and the quality metric.  ``param_axes`` gives each param's
logical axes (``repro``'s ``init_dlrm`` returns them beside the params),
by which a meshed training run places them (``sharding.tree_specs``).

Distribution, as in ``repro``: tables row-sharded over ``model`` ("bank
groups"), requests over ``data``; the only ``model``-axis collective is one
psum of pooled vectors.
"""

from __future__ import annotations

import math

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import embedding_bag
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.engine import EngineSpec, engine_for


def make_bags(cfg: DLRMConfig) -> list[BagConfig]:
    emb = EmbeddingConfig(
        vocab=cfg.vocab_per_table,
        dim=cfg.dim,
        kind=cfg.embedding_kind,  # type: ignore[arg-type]
        collision=cfg.qr_collision,
        param_dtype=cfg.pdtype,
        compute_dtype=cfg.cdtype,
        tt_rank=cfg.tt_rank,
        tt_vocab_factors=cfg.tt_vocab_factors,
        tt_dim_factors=cfg.tt_dim_factors,
        tt_exec=cfg.tt_exec,
    )
    return [BagConfig(emb=emb, pooling=cfg.pooling) for _ in range(cfg.num_tables)]


def _init_mlp(dims: tuple[int, ...], in_dim: int, dtype, generator, device) -> list[dict]:
    params = []
    d = in_dim
    for out in dims:
        w = torch.randn((d, out), generator=generator, device=device)
        params.append({
            "w": w.mul_(1.0 / math.sqrt(d)).to(dtype),
            "b": torch.zeros((out,), dtype=dtype, device=device),
        })
        d = out
    return params


def _mlp_fwd(params: list[dict], x: torch.Tensor, compute_dtype, *,
             final_linear: bool = True) -> torch.Tensor:
    for i, p in enumerate(params):
        x = x.to(compute_dtype) @ p["w"].to(compute_dtype) + p["b"].to(compute_dtype)
        last = i == len(params) - 1
        if not (last and final_linear):
            x = torch.relu(x)
    return x


def num_interactions(cfg: DLRMConfig) -> int:
    f = cfg.num_tables + 1
    return f * (f - 1) // 2


def init_dlrm(cfg: DLRMConfig, *, seed: int = 0, device=None) -> dict:
    """Random params ``{"bottom", "top", "tables"}`` drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (the card
    unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    g = device_mod.generator(dev)
    g.manual_seed(seed)
    top_in = cfg.bottom_mlp[-1] + num_interactions(cfg)
    return {
        "bottom": _init_mlp(cfg.bottom_mlp, cfg.num_dense, cfg.pdtype, g, dev),
        "top": _init_mlp(cfg.top_mlp, top_in, cfg.pdtype, g, dev),
        "tables": embedding_bag.init_tables(make_bags(cfg), generator=g, device=dev),
    }


def param_axes(cfg: DLRMConfig) -> dict:
    """Logical axes of every param of ``init_dlrm(cfg)``, the same nesting:
    the tables' ``embedding_bag.table_axes``, ``("mlp", "mlp")`` and
    ``("mlp",)`` for each MLP layer's weight and bias."""
    layer = lambda: {"w": ("mlp", "mlp"), "b": ("mlp",)}
    return {"bottom": [layer() for _ in cfg.bottom_mlp],
            "top": [layer() for _ in cfg.top_mlp],
            "tables": embedding_bag.table_axes(make_bags(cfg))}


def _gnr(tables, idx: torch.Tensor, bags, cfg: DLRMConfig) -> torch.Tensor:
    """(B, T, pooling) indices -> (B, T, dim) pooled, through the memoised
    engine's ``inline_gnr``: single card without a mesh, two-level under
    one."""
    return engine_for(EngineSpec.from_bags(bags)).inline_gnr(tables, idx)


def pad_tables_for_mesh(params: dict, cfg: DLRMConfig, num_shards: int) -> dict:
    """Pad Q / G2 / dense tables so the ``model`` axis divides their rows."""
    from repro_torch.core import sharded_embedding as SE

    out = []
    for t, bag in zip(params["tables"], make_bags(cfg)):
        if "q" in t:
            out.append({"q": SE.pad_q_table(t["q"], bag.emb), "r": t["r"]})
        elif "g2" in t:
            out.append({"g1": t["g1"], "g2": SE.pad_q_table(t["g2"], bag.emb), "g3": t["g3"]})
        else:
            out.append({"table": SE.pad_q_table(t["table"], bag.emb)})
    return {**params, "tables": out}


def interact(bottom: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """Pairwise-dot interaction. bottom: (B, dim); pooled: (B, T, dim) ->
    (B, F*(F-1)/2), pairs in row-major upper-triangle order."""
    feats = torch.cat([bottom[:, None, :], pooled], dim=1)      # (B, F, dim)
    gram = torch.bmm(feats, feats.transpose(1, 2))
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    return gram[:, iu, ju]


def forward_from_pooled(params: dict, dense: torch.Tensor, pooled: torch.Tensor,
                        cfg: DLRMConfig) -> torch.Tensor:
    """CTR logits from precomputed pooled embeddings (B, T, dim) -> (B,) fp32."""
    bottom = _mlp_fwd(params["bottom"], dense, cfg.cdtype, final_linear=False)
    z = interact(bottom.to(cfg.cdtype), pooled.to(cfg.cdtype))
    top_in = torch.cat([bottom, z], dim=-1)
    return _mlp_fwd(params["top"], top_in, cfg.cdtype)[:, 0].to(torch.float32)


def forward_dlrm(params: dict, dense: torch.Tensor, idx: torch.Tensor,
                 cfg: DLRMConfig) -> torch.Tensor:
    """dense: (B, num_dense) fp; idx: (B, T, pooling) int -> CTR logits (B,)
    fp32.  The embedding layer is ``_gnr`` (one packed kernel launch on
    packable sets).  Under a mesh every argument is this rank's piece: its
    batch shard of ``dense`` / ``idx``, its row shards of the tables
    (``pad_tables_for_mesh``, then ``sharded_embedding.shard_qr_params``),
    the MLPs whole."""
    return forward_from_pooled(params, dense, _gnr(params["tables"], idx, make_bags(cfg), cfg),
                               cfg)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits (labels in {0, 1}), fp32, in
    ``repro``'s form: mean(max(x, 0) - x*y + log1p(exp(-|x|)))."""
    logits = logits.float()
    labels = labels.float()
    return torch.mean(torch.clamp(logits, min=0.0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def auc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank-based AUC (Mann-Whitney); ties ranked in a stable order, as
    ``repro``'s argsort does."""
    order = torch.argsort(logits, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(1, logits.numel() + 1, device=logits.device)
    pos = labels > 0.5
    n_pos = pos.sum()
    n_neg = labels.numel() - n_pos
    sum_pos = torch.where(pos, ranks, torch.zeros_like(ranks)).sum()
    return (sum_pos - n_pos * (n_pos + 1) / 2) / torch.clamp(n_pos * n_neg, min=1)
