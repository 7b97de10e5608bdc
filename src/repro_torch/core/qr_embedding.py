"""Weight-sharing embedding tables (port of ``repro.core.qr_embedding``):
dense, hashed (the hashing trick, k-ary) and quotient-remainder kinds here,
TT routed to ``repro_torch.core.tt_embedding`` through the same ``init`` /
``lookup`` / ``param_axes`` entry points.

``lookup``, ``materialize`` and ``logits_head`` are plain torch (gathers,
adds, ``torch.matmul``), as ``repro``'s are jnp: on the card they run
PyTorch's own gathers; the pooled kernels sit under ``embedding_bag`` and
``kernels.ops``.

``init(cfg, generator=..., device=...)`` draws from an explicit
``torch.Generator``, so its numbers differ from ``jax.random``'s; the parity
tests carry ``repro``'s params across with ``repro_torch.convert``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import hashing, tt_embedding

EmbeddingKind = Literal["dense", "hashed", "qr", "tt"]
Reconstruction = Literal["add", "mul", "concat"]

# Physical row counts are padded to a multiple of ROW_PAD (repro pads so mesh
# axes divide them; the packed layout keeps the same row offsets).
ROW_PAD = 128


def _pad_rows(rows: int) -> int:
    return -(-rows // ROW_PAD) * ROW_PAD


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    vocab: int
    dim: int
    kind: EmbeddingKind = "dense"
    collision: int = 64               # QR hash-collision value c
    reconstruction: Reconstruction = "add"
    hashed_rows: int = 0              # physical rows for kind="hashed" (0 -> vocab//collision)
    hashed_k: int = 2                 # k-ary reconstruction for hashing trick
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    hot_fraction: float = 0.0
    head: str = "factorized"
    tt_rank: int = 16
    tt_vocab_factors: tuple[int, int, int] | None = None
    tt_dim_factors: tuple[int, int, int] | None = None
    tt_exec: str = "jnp"

    @property
    def qr_spec(self) -> hashing.QRSpec:
        return hashing.QRSpec(vocab=self.vocab, collision=self.collision, dim=self.dim)

    @property
    def tt_spec(self) -> tt_embedding.TTSpec:
        return tt_embedding.spec_for(self)

    @property
    def physical_hashed_rows(self) -> int:
        return self.hashed_rows or max(1, self.vocab // self.collision)

    def param_count(self) -> int:
        if self.kind == "dense":
            return self.vocab * self.dim
        if self.kind == "hashed":
            return self.physical_hashed_rows * self.dim
        if self.kind == "tt":
            return self.tt_spec.param_count()
        spec = self.qr_spec
        if self.reconstruction == "concat":
            return (spec.q_rows + spec.r_rows) * (self.dim // 2)
        return (spec.q_rows + spec.r_rows) * self.dim


def _normal(shape, dtype, generator, device, scale: float) -> torch.Tensor:
    out = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return out.mul_(scale)


def init(cfg: EmbeddingConfig, *, generator: torch.Generator,
         device: torch.device) -> dict:
    """Random params of one table: dense and hashed ``{"table"}``, QR
    ``{"q", "r"}`` or TT ``{"g1", "g2", "g3"}``."""
    if cfg.kind == "tt":
        return tt_embedding.init(cfg, generator=generator, device=device)
    scale = cfg.dim ** -0.5
    if cfg.kind in ("dense", "hashed"):
        rows = cfg.vocab if cfg.kind == "dense" else cfg.physical_hashed_rows
        shape = (_pad_rows(rows), cfg.dim)
        return {"table": _normal(shape, cfg.param_dtype, generator, device, scale)}
    spec = cfg.qr_spec
    dim = cfg.dim // 2 if cfg.reconstruction == "concat" else cfg.dim
    q = _normal((_pad_rows(spec.q_rows), dim), cfg.param_dtype, generator, device, scale)
    if cfg.reconstruction == "mul":
        # Multiplicative sharing: R initialized around 1 so early training is stable.
        r = _normal((spec.r_rows, dim), cfg.param_dtype, generator, device, 0.01).add_(1.0)
    else:
        r = _normal((spec.r_rows, dim), cfg.param_dtype, generator, device, scale)
    return {"q": q, "r": r}


def param_axes(cfg: EmbeddingConfig) -> dict:
    """Logical sharding axes per parameter: ``qrow``/``vocab`` rows are the
    bank-group partition axis, ``rrow`` the replicated LUT tier."""
    if cfg.kind in ("dense", "hashed"):
        return {"table": ("vocab", "embed")}
    if cfg.kind == "tt":
        return tt_embedding.param_axes(cfg)
    return {"q": ("qrow", "embed"), "r": ("rrow", "embed")}


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------

def lookup(params: dict, idx: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Logical-row lookup ``idx -> (..., dim)`` in the compute dtype."""
    if cfg.kind == "tt":
        return tt_embedding.lookup(params, idx, cfg)
    if cfg.kind == "dense":
        return params["table"].to(cfg.compute_dtype)[idx.long()]
    if cfg.kind == "hashed":
        table = params["table"].to(cfg.compute_dtype)
        hs = hashing.k_ary_hash(idx, cfg.physical_hashed_rows, cfg.hashed_k)
        return table[hs.long()].sum(dim=-2)
    q_idx, r_idx = hashing.qr_decompose(idx, cfg.collision)
    q = params["q"].to(cfg.compute_dtype)[q_idx.long()]
    r = params["r"].to(cfg.compute_dtype)[r_idx.long()]
    return reconstruct(q, r, cfg.reconstruction)


def reconstruct(q: torch.Tensor, r: torch.Tensor, op: Reconstruction) -> torch.Tensor:
    if op == "add":
        return q + r
    if op == "mul":
        return q * r
    if op == "concat":
        return torch.cat([q, r], dim=-1)
    raise ValueError(f"unknown reconstruction {op!r}")


def _all_rows(cfg: EmbeddingConfig, device) -> torch.Tensor:
    return torch.arange(cfg.vocab, dtype=torch.int32, device=device)


def materialize(params: dict, cfg: EmbeddingConfig) -> torch.Tensor:
    """The full logical table ``(vocab, dim)`` (tied LM head, test oracle)."""
    device = next(iter(params.values())).device
    return lookup(params, _all_rows(cfg, device), cfg)


def logits_head(params: dict, x: torch.Tensor, cfg: EmbeddingConfig, *, lo: int = 0,
                hi: int | None = None) -> torch.Tensor:
    """Tied-embedding LM head ``x @ E^T``.  For ``add`` reconstruction,
    ``logits[v] = x·Q[v//c] + x·R[v%c]``: the products run against the
    physical tables, and the expansion is one broadcast add of the (..., q,
    1) and (..., 1, c) products read out as (..., q·c), ``v = (v//c)·c +
    v%c`` (the values ``repro``'s two gathers and add give, bit for bit).
    Its backward sums the logits' gradient over each axis, where two
    gathers would write two (..., vocab) copies forward and scatter back.

    ``[lo, hi)`` (default the whole vocabulary) gives that range's logits
    from a dense table or a QR-add Q whose rows start at token ``lo`` (a
    row shard on a mesh, ``logits_head_shard``)."""
    compute = cfg.compute_dtype
    n = (cfg.vocab if hi is None else hi) - lo
    if cfg.kind == "dense":
        return (x @ params["table"].to(compute).T)[..., :n]
    factorized = cfg.kind == "qr" and cfg.reconstruction == "add" and cfg.head != "materialize"
    if n != cfg.vocab and not factorized:
        raise NotImplementedError(f"a vocabulary range of the {cfg.kind} head")
    if cfg.kind == "hashed":
        table = params["table"].to(compute)
        hs = hashing.k_ary_hash(_all_rows(cfg, x.device), cfg.physical_hashed_rows,
                                cfg.hashed_k)                       # (vocab, k)
        small = x @ table.T                                         # (..., rows)
        return small[..., hs.long()].sum(dim=-1)
    if not factorized:
        return x @ materialize(params, cfg).T
    c = cfg.collision
    rows = -(-n // c)                                               # the Q rows it covers
    xq = x @ params["q"].to(compute).T                              # (..., padded q rows)
    xr = x @ params["r"].to(compute).T                              # (..., c)
    full = xq[..., :rows, None] + xr[..., None, :]                  # (..., rows, c)
    return full.reshape(*x.shape[:-1], rows * c)[..., :n]


# ---------------------------------------------------------------------------
# the tied head on a mesh (vocab-parallel)
# ---------------------------------------------------------------------------

def vocab_shard_range(cfg: EmbeddingConfig, nsh: int, shard: int) -> tuple[int, int]:
    """The contiguous vocabulary ``[lo, hi)`` whose tied-head logits rank
    ``shard`` of a row axis of ``nsh`` computes: the tokens of its row
    shard of the padded table, QR's Q shard ``[shard·rps·c, (shard+1)·rps·c)``
    (rps Q rows a shard, c the collision), a dense table's rows, each cut
    at ``vocab`` (the padding never reaches the softmax).  Uneven: aligned
    with the shards, not with ``vocab / nsh``."""
    if cfg.kind == "qr":
        rows, width = _pad_rows(cfg.qr_spec.q_rows), cfg.collision
    elif cfg.kind == "dense":
        rows, width = _pad_rows(cfg.vocab), 1
    else:
        raise NotImplementedError(f"the tied head of a {cfg.kind} vocabulary on a mesh")
    per = rows // nsh * width
    return min(cfg.vocab, shard * per), min(cfg.vocab, (shard + 1) * per)


def logits_head_shard(params: dict, x: torch.Tensor, cfg: EmbeddingConfig, *, mesh,
                      axis: str = "model") -> torch.Tensor:
    """This rank's slice ``[lo, hi)`` (``vocab_shard_range``) of the tied
    head's logits ``x @ E^T``: ``logits_head`` over that range on its row
    shard of ``params`` (QR-add's Q shard beside the whole R, or a dense
    table's rows).  Every rank's slice reads ``x`` (and R): both enter
    through ``collectives.enter``, so their gradients are summed over
    ``axis``."""
    from repro_torch.distributed import collectives

    lo, hi = vocab_shard_range(cfg, mesh.shape[axis], mesh.axis_index(axis))
    if cfg.kind == "dense":
        [x] = collectives.enter([x], mesh, axis)
        return logits_head(params, x, cfg, lo=lo, hi=hi)
    if cfg.reconstruction != "add" or cfg.head == "materialize":
        raise NotImplementedError(f"the {cfg.head} QR-{cfg.reconstruction} head on a mesh")
    x, r = collectives.enter([x, params["r"]], mesh, axis)
    return logits_head({"q": params["q"], "r": r}, x, cfg, lo=lo, hi=hi)
