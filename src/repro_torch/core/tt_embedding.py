"""TT-Rec embedding tables: tensor-train weight sharing (port of
``repro.core.tt_embedding``).

A logical table ``(vocab, dim)`` is a 3-core tensor train.  Logical row
``i`` splits as ``i -> (i1, i2, i3)`` over vocab factors ``(v1, v2, v3)``
and is rebuilt by the chained contraction

    W[i] = G1[i1] @ G2[i2] @ G3[i3]          # (d1,r) @ (r,d2,r) @ (r,d3)

reshaped to ``dim = d1*d2*d3``.  The outer factors ``v1, v3`` are small
(~vocab**0.25) and the middle core carries the bulk of the rows: G2 is the
streamed, cached "big table", as Q is on the QR path.  Every core is stored
2-D ``(rows, flat_width)``.

``init(cfg, generator=..., device=...)`` draws from an explicit
``torch.Generator``, so its numbers differ from ``jax.random``'s; the parity
tests carry ``repro``'s params across with ``repro_torch.convert``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import ops

# Same physical-row padding as qr_embedding.
ROW_PAD = 128


def _pad_rows(rows: int) -> int:
    return -(-rows // ROW_PAD) * ROW_PAD


# ---------------------------------------------------------------------------
# factorization
# ---------------------------------------------------------------------------

def dim_factors3(dim: int) -> tuple[int, int, int]:
    """Exact 3-way factorization of ``dim``, most balanced, largest in the
    middle (keeps the outer cores small)."""
    best: tuple[int, int, int] | None = None
    for a in range(1, dim + 1):
        if dim % a:
            continue
        rest = dim // a
        for b in range(a, rest + 1):
            if rest % b:
                continue
            c = rest // b
            if c < b:
                continue
            tri = (a, b, c)
            if best is None or sum(tri) < sum(best):
                best = tri
    if best is None:
        raise ValueError(f"dim {dim} has no 3-way factorization")
    lo, mid, hi = best
    return (mid, hi, lo)


def vocab_factors3(vocab: int) -> tuple[int, int, int]:
    """Covering factorization ``v1*v2*v3 >= vocab``: outer factors
    ~vocab**0.25, the bulk in the middle core."""
    outer = max(2, math.ceil(vocab ** 0.25))
    mid = math.ceil(vocab / (outer * outer))
    return (outer, mid, outer)


@dataclasses.dataclass(frozen=True)
class TTSpec:
    """Static shape spec of a 3-core tensor-train factorization."""

    vocab: int
    dim: int
    rank: int
    vocab_factors: tuple[int, int, int]
    dim_factors: tuple[int, int, int]

    def __post_init__(self):
        v1, v2, v3 = self.vocab_factors
        d1, d2, d3 = self.dim_factors
        if v1 * v2 * v3 < self.vocab:
            raise ValueError(
                f"vocab factors {self.vocab_factors} cover only {v1 * v2 * v3} "
                f"< vocab {self.vocab}"
            )
        if d1 * d2 * d3 != self.dim:
            raise ValueError(
                f"dim factors {self.dim_factors} must multiply to dim {self.dim}"
            )

    @property
    def v1(self) -> int: return self.vocab_factors[0]
    @property
    def v2(self) -> int: return self.vocab_factors[1]
    @property
    def v3(self) -> int: return self.vocab_factors[2]
    @property
    def d1(self) -> int: return self.dim_factors[0]
    @property
    def d2(self) -> int: return self.dim_factors[1]
    @property
    def d3(self) -> int: return self.dim_factors[2]

    @property
    def padded_vocab(self) -> int:
        return self.v1 * self.v2 * self.v3

    # flat core widths (the last axis of each stored 2-D core)
    @property
    def g1_width(self) -> int: return self.d1 * self.rank
    @property
    def g2_width(self) -> int: return self.rank * self.d2 * self.rank
    @property
    def g3_width(self) -> int: return self.rank * self.d3

    @property
    def g2_rows_padded(self) -> int:
        return _pad_rows(self.v2)

    @property
    def dims(self) -> tuple[int, int, int, int]:
        """(d1, d2, d3, rank), the kernels' ``dims``."""
        return (self.d1, self.d2, self.d3, self.rank)

    def param_count(self) -> int:
        """Physical elements (middle core padded, as ``init`` makes it)."""
        return (
            self.v1 * self.g1_width
            + self.g2_rows_padded * self.g2_width
            + self.v3 * self.g3_width
        )

    @property
    def compression(self) -> float:
        return (self.vocab * self.dim) / self.param_count()

    def sram_bytes(self, bytes_per_elem: int = 4) -> int:
        """Footprint of the outer cores (G1 + G3)."""
        return (self.v1 * self.g1_width + self.v3 * self.g3_width) * bytes_per_elem

    def streamed_bytes_per_lookup(self, bytes_per_elem: int = 4) -> int:
        """Bytes one lookup streams once the outer cores stay resident: one
        G2 row."""
        return self.g2_width * bytes_per_elem


def spec_for(cfg) -> TTSpec:
    """The TTSpec of an ``EmbeddingConfig`` with kind='tt'."""
    return TTSpec(
        vocab=cfg.vocab,
        dim=cfg.dim,
        rank=cfg.tt_rank,
        vocab_factors=cfg.tt_vocab_factors or vocab_factors3(cfg.vocab),
        dim_factors=cfg.tt_dim_factors or dim_factors3(cfg.dim),
    )


# ---------------------------------------------------------------------------
# index factorization
# ---------------------------------------------------------------------------

def tt_decompose_factors(idx, v2: int, v3: int):
    """Mixed-radix split ``idx = (i1*v2 + i2)*v3 + i3``, int32, for numpy
    arrays and torch tensors alike."""
    if isinstance(idx, torch.Tensor):
        idx = idx.to(torch.int32)
    else:
        idx = np.asarray(idx).astype(np.int32)
    i3 = idx % v3
    rest = idx // v3
    i2 = rest % v2
    i1 = rest // v2
    return i1, i2, i3


def tt_decompose(idx, spec: TTSpec):
    """Logical index -> (i1, i2, i3) core-row indices (int32)."""
    return tt_decompose_factors(idx, spec.v2, spec.v3)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg, *, generator: torch.Generator, device: torch.device) -> dict:
    """Three 2-D cores, middle-core rows padded, drawn in the order g1, g2,
    g3.  Core std ``(dim * rank**2) ** (-1/6)`` gives the rebuilt table
    ``dim**-0.5``-scale entries."""
    spec = spec_for(cfg)
    scale = (cfg.dim * spec.rank ** 2) ** (-1.0 / 6.0)

    def normal(shape):
        out = torch.randn(shape, generator=generator, device=device,
                          dtype=cfg.param_dtype)
        return out.mul_(scale)

    return {
        "g1": normal((spec.v1, spec.g1_width)),
        "g2": normal((spec.g2_rows_padded, spec.g2_width)),
        "g3": normal((spec.v3, spec.g3_width)),
    }


def param_axes(cfg) -> dict:
    """Middle-core rows ride the bank-group partition axis (the Q table's
    name); the outer cores are the replicated tier (the R LUT's name)."""
    return {"g1": ("rrow", "embed"), "g2": ("qrow", "embed"), "g3": ("rrow", "embed")}


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------

def contract_rows(a_rows: torch.Tensor, b_rows: torch.Tensor, c_rows: torch.Tensor,
                  spec: TTSpec) -> torch.Tensor:
    """Chained TT contraction on gathered flat core rows, in the kernels'
    order: ``(d1,r) @ (r,d2*r)``, reshaped to ``(d1*d2, r)``, then
    ``@ (r,d3)``.

    a_rows: (..., d1*r); b_rows: (..., r*d2*r); c_rows: (..., r*d3)
    -> (..., d1*d2*d3), layout ``(d1-major, d2, d3-minor)``.
    """
    lead = a_rows.shape[:-1]
    d1, d2, d3, r = spec.dims
    a = a_rows.reshape(*lead, d1, r)
    b = b_rows.reshape(*lead, r, d2 * r)
    c = c_rows.reshape(*lead, r, d3)
    t = torch.matmul(a, b).reshape(*lead, d1 * d2, r)
    return torch.matmul(t, c).reshape(*lead, spec.dim)


def lookup(params: dict, idx: torch.Tensor, cfg) -> torch.Tensor:
    """Logical-row lookup ``idx -> (..., dim)`` in the compute dtype.

    With ``cfg.tt_exec == "pallas"`` and the cores on the card, the lookup is
    one launch of the TT-bag kernel (K5, K = 1 per lookup), cast to the
    compute dtype, as ``repro`` runs its Pallas kernel on the TPU.  Otherwise
    the plain contraction runs in the compute dtype, as ``repro`` does off
    the TPU.
    """
    spec = spec_for(cfg)
    i1, i2, i3 = tt_decompose(idx, spec)
    if cfg.tt_exec == "pallas" and params["g2"].device.type == "cuda":
        out = ops.tt_pooled_auto(
            params["g1"], params["g2"], params["g3"],
            i1.reshape(-1, 1), i2.reshape(-1, 1), i3.reshape(-1, 1),
            dims=spec.dims, exec_mode="pallas",
        )
        return out.reshape(*i1.shape, spec.dim).to(cfg.compute_dtype)
    compute = cfg.compute_dtype
    a = params["g1"].to(compute)[i1.long()]
    b = params["g2"].to(compute)[i2.long()]
    c = params["g3"].to(compute)[i3.long()]
    return contract_rows(a, b, c, spec)


def materialize(params: dict, cfg) -> torch.Tensor:
    """The full logical table ``(vocab, dim)`` (test oracle)."""
    all_idx = torch.arange(cfg.vocab, dtype=torch.int32, device=params["g2"].device)
    return lookup(params, all_idx, cfg)
