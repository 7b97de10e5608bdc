"""Weight-sharing embedding configs and init (port of
``repro.core.qr_embedding``: dense and QR kinds here, TT routed to
``repro_torch.core.tt_embedding``; the hashed kind waits for the per-table
slice).

``init(cfg, generator=..., device=...)`` draws from an explicit
``torch.Generator``, so its numbers differ from ``jax.random``'s; the parity
tests carry ``repro``'s params across with ``repro_torch.convert``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch import HASHED_NEXT
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
    """Random params of one table: dense ``{"table"}``, QR ``{"q", "r"}`` or
    TT ``{"g1", "g2", "g3"}``."""
    if cfg.kind == "tt":
        return tt_embedding.init(cfg, generator=generator, device=device)
    if cfg.kind == "hashed":
        raise NotImplementedError(HASHED_NEXT)
    scale = cfg.dim ** -0.5
    if cfg.kind == "dense":
        shape = (_pad_rows(cfg.vocab), cfg.dim)
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
