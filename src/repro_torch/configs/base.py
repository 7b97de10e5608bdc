"""Config dataclasses (port of ``repro.configs.base``): the LM's
``ModelConfig`` and shape grid ``LM_SHAPES``, ``DLRMConfig`` and its shapes,
and ``MeshConfig``.

Field names and defaults are ``repro``'s; dtype names map to torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

# float64 is the port's own: a reference of how far fp32's rounding alone
# moves a value (chip_smoke.py's phase 15)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0        # chatglm3: 0.5 ("RoPE 2d")
    activation: str = "silu"           # silu | gelu | relu2
    norm: str = "rms"                  # rms | layer
    tie_embedding: bool = True

    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid / xlstm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    attn_every: int = 0                # zamba2: shared attention block cadence
    slstm_every: int = 0               # xlstm: sLSTM block cadence

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    enc_layers: int = 0
    dec_layers: int = 0

    # vlm (pixtral): length of the stub patch-embedding prefix
    num_patches: int = 0

    # the paper's technique knob (applies to vocab embedding + tied head)
    embedding_kind: str = "dense"      # dense | hashed | qr | tt
    qr_collision: int = 64
    hot_fraction: float = 0.0
    # TT-Rec knobs (embedding_kind="tt")
    tt_rank: int = 16
    tt_vocab_factors: tuple[int, int, int] | None = None
    tt_dim_factors: tuple[int, int, int] | None = None
    tt_exec: str = "jnp"               # jnp | pallas (the TT-bag kernel on the card)
    # execution-scheme knobs
    qr_head: str = "factorized"        # factorized | materialize (paper-faithful)
    embedding_exec: str = "gspmd"      # gspmd | twolevel (the PIM scheme)
    moe_dispatch: str = "scatter"      # scatter (GShard-style) | gather (opt)

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"         # full | dots (save matmul outputs)
    flash_block_dtype: str = "f32"     # f32 | bf16 probability-tile storage
    scan_layers: bool = True
    microbatches: int = 1              # grad-accum steps per train_step

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def emb_config(self):
        """The vocabulary's ``qr_embedding.EmbeddingConfig``."""
        from repro_torch.core.qr_embedding import EmbeddingConfig

        return EmbeddingConfig(
            vocab=self.vocab,
            dim=self.d_model,
            kind=self.embedding_kind,  # type: ignore[arg-type]
            collision=self.qr_collision,
            param_dtype=self.pdtype,
            compute_dtype=self.cdtype,
            hot_fraction=self.hot_fraction,
            head=self.qr_head,
            tt_rank=self.tt_rank,
            tt_vocab_factors=self.tt_vocab_factors,
            tt_dim_factors=self.tt_dim_factors,
            tt_exec=self.tt_exec,
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned LM shape set (identical across the 10 archs).
LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n
