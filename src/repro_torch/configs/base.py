"""DLRM config dataclasses (port of ``repro.configs.base``, DLRM part).

Field names and defaults are ``repro``'s; dtype names map to torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The paper's own model family (CTR prediction)."""

    name: str = "dlrm-qr"
    num_tables: int = 26               # criteo-like sparse features
    vocab_per_table: int = 2_000_000
    dim: int = 128
    pooling: int = 32                  # multi-hot indices per bag
    num_dense: int = 13
    bottom_mlp: tuple[int, ...] = (512, 256, 128)
    top_mlp: tuple[int, ...] = (1024, 1024, 512, 256, 1)
    embedding_kind: str = "qr"         # dense | hashed | qr | tt
    qr_collision: int = 64
    hot_request_share: float = 0.8     # paper's hot-vector definition
    # TT-Rec knobs (embedding_kind="tt")
    tt_rank: int = 16
    tt_vocab_factors: tuple[int, int, int] | None = None
    tt_dim_factors: tuple[int, int, int] | None = None
    tt_exec: str = "jnp"
    # ProactivePIM cache-subsystem knobs (serving)
    cache_slots: int = 1024            # prefetch-cache rows per big subtable
    cache_slot_policy: str = "adaptive"
    # Ceiling on the packed cache block: the global slot budget is clamped so
    # slots * row_bytes fits it (repro sized it for TPU VMEM; on the card
    # the block lives in device memory and stays in the 50 MB L2).
    cache_vmem_mb: int = 8
    dup_budget_mb: int = 64            # per-chip replicated-subtable budget
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    def replace(self, **kw) -> "DLRMConfig":
        return dataclasses.replace(self, **kw)


DLRM_SHAPES: tuple[ShapeConfig, ...] = (
    # seq_len carries the pooling factor for DLRM; batch is the request batch.
    ShapeConfig("serve_2k", 32, 2048, "prefill"),
    ShapeConfig("train_8k", 32, 8192, "train"),
)
