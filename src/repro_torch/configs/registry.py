"""Architecture registry (port of ``repro.configs.registry``): ``--arch``
ids -> configs, model bindings and the shape grid; ``--config`` ids -> the
DLRM configs.

The ten assigned LM architectures are all listed, with ``repro``'s
bindings, shape grid and skip rules, and every kind has a model in the
port: the transformers (the dense qwen2-1.5b, granite-34b, chatglm3-6b,
minitron-4b and the MoE granite-moe-3b-a800m, qwen3-moe-235b-a22b), the
zamba2 hybrid (zamba2-7b), xlstm (xlstm-125m) and the prefix models,
whisper (whisper-large-v3: its batches carry the frames) and pixtral
(pixtral-12b: the patches).

The dry run's abstract inputs (``batch_specs``, ``cache_specs``,
``abstract_params``) are tensors on the ``meta`` device: shapes and dtypes,
no data, nothing allocated.  ``repro``'s ``_axes_for`` (the axes from a
reduced config, a jax workaround) has no counterpart: ``init_fn`` on meta
gives the axes of the full config itself.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

from repro_torch.configs import dlrm_qr, dlrm_tt
from repro_torch.configs.base import LM_SHAPES, ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class ArchBinding:
    arch_id: str
    module: str                    # repro_torch.configs.<module> holding CONFIG/SMOKE
    kind: str                      # transformer | zamba2 | xlstm | whisper | pixtral
    sub_quadratic: bool            # eligible for long_500k
    has_decode: bool = True

    @property
    def config(self) -> ModelConfig:
        return importlib.import_module(f"repro_torch.configs.{self.module}").CONFIG

    @property
    def smoke(self) -> ModelConfig:
        return importlib.import_module(f"repro_torch.configs.{self.module}").SMOKE


ARCHS: dict[str, ArchBinding] = {
    b.arch_id: b
    for b in [
        ArchBinding("qwen2-1.5b", "qwen2_1_5b", "transformer", False),
        ArchBinding("granite-34b", "granite_34b", "transformer", False),
        ArchBinding("chatglm3-6b", "chatglm3_6b", "transformer", False),
        ArchBinding("minitron-4b", "minitron_4b", "transformer", False),
        ArchBinding("zamba2-7b", "zamba2_7b", "zamba2", True),
        ArchBinding("whisper-large-v3", "whisper_large_v3", "whisper", False),
        ArchBinding("pixtral-12b", "pixtral_12b", "pixtral", False),
        ArchBinding("granite-moe-3b-a800m", "granite_moe_3b_a800m", "transformer", False),
        ArchBinding("qwen3-moe-235b-a22b", "qwen3_moe_235b_a22b", "transformer", False),
        ArchBinding("xlstm-125m", "xlstm_125m", "xlstm", True),
    ]
}


def get(arch_id: str) -> ArchBinding:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {sorted(ARCHS)}")
    return ARCHS[arch_id]


# ---------------------------------------------------------------------------
# DLRM (the paper's own model): --config ids -> DLRMConfig objects
# ---------------------------------------------------------------------------

DLRM_CONFIGS = {
    "dlrm-qr": dlrm_qr.CONFIG,
    "dlrm-qr-smoke": dlrm_qr.SMOKE,
    "dlrm-dense": dlrm_qr.DENSE_BASELINE,
    "dlrm-dense-smoke": dlrm_qr.DENSE_SMOKE,
    "dlrm-tt": dlrm_tt.CONFIG,
    "dlrm-tt-smoke": dlrm_tt.SMOKE,
}


def get_dlrm(name: str):
    """Resolve a DLRM config id."""
    if name not in DLRM_CONFIGS:
        raise KeyError(f"unknown dlrm config {name!r}; choose from {sorted(DLRM_CONFIGS)}")
    return DLRM_CONFIGS[name]


# ---------------------------------------------------------------------------
# shape grid + skip rules
# ---------------------------------------------------------------------------

def shape_status(binding: ArchBinding, shape: ShapeConfig) -> str:
    """'run' or a skip reason."""
    if shape.kind == "decode" and not binding.has_decode:
        return "skip: encoder-only, no decode step"
    if shape.name.startswith("long_") and not binding.sub_quadratic:
        return "skip: pure full-attention arch; long_500k needs sub-quadratic"
    return "run"


def cells(include_skipped: bool = False):
    """Iterate (binding, shape, status) over the 10 x 4 assigned grid."""
    for binding in ARCHS.values():
        for shape in LM_SHAPES:
            status = shape_status(binding, shape)
            if status == "run" or include_skipped:
                yield binding, shape, status


# ---------------------------------------------------------------------------
# model bindings
# ---------------------------------------------------------------------------

def init_fn(binding: ArchBinding) -> Callable:
    """``(cfg, *, seed, device) -> (params, axes)`` for this family."""
    if binding.kind == "zamba2":
        from repro_torch.models import zamba2 as Z

        return Z.init_zamba2
    if binding.kind == "xlstm":
        from repro_torch.models import xlstm as X

        return X.init_xlstm
    if binding.kind == "whisper":
        from repro_torch.models import whisper as W

        return W.init_whisper
    from repro_torch.models import transformer as T

    return T.init_lm             # the transformers' and pixtral's tree


def train_loss_fn(binding: ArchBinding, cfg: ModelConfig) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` for this family: the
    causal LM loss on ``transformer.forward_train``, or on the logits of
    ``forward_zamba2`` / ``forward_xlstm`` without a cache, or the prefix
    models' (``make_prefixed_lm_loss`` on whisper's or pixtral's
    ``forward_train``, the batch's ``"frames"`` / ``"patches"`` in front);
    every one vocab-parallel on a mesh (``transformer.vocab_range``)."""
    from repro_torch.train import train_step as TS

    from repro_torch.models import transformer as T

    if binding.kind == "zamba2":
        from repro_torch.models import zamba2 as Z

        return TS.make_lm_loss(lambda p, t, c: Z.forward_zamba2(p, t, c)[0], cfg,
                               vocab_range=T.vocab_range)
    if binding.kind == "xlstm":
        from repro_torch.models import xlstm as X

        return TS.make_lm_loss(lambda p, t, c: X.forward_xlstm(p, t, c)[0], cfg,
                               vocab_range=T.vocab_range)
    if binding.kind == "whisper":
        from repro_torch.models import whisper as W

        return TS.make_prefixed_lm_loss(W.forward_train, cfg, "frames",
                                        vocab_range=T.vocab_range)
    if binding.kind == "pixtral":
        from repro_torch.models import pixtral as P

        return TS.make_prefixed_lm_loss(P.forward_train, cfg, "patches",
                                        vocab_range=T.vocab_range)
    return TS.make_lm_loss(T.forward_train, cfg, vocab_range=T.vocab_range)


def make_batch_fn(binding: ArchBinding, cfg: ModelConfig) -> Callable:
    """``(batch, seq, seed=, step=, device=) -> {"tokens"}`` for this family,
    with whisper's ``"frames"`` or pixtral's ``"patches"``."""
    from repro_torch.data import synthetic as syn

    if binding.kind == "whisper":
        return lambda b, s, **kw: syn.whisper_batch(cfg, b, s, **kw)
    if binding.kind == "pixtral":
        return lambda b, s, **kw: syn.pixtral_batch(cfg, b, s, **kw)
    return lambda b, s, **kw: syn.lm_batch(cfg, b, s, **kw)


# ---------------------------------------------------------------------------
# abstract inputs (the dry run: meta tensors, no allocation)
# ---------------------------------------------------------------------------

def batch_specs(binding: ArchBinding, cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The batch of a train or prefill step on meta: ``tokens`` (batch, seq)
    int32, whisper's ``frames`` (batch, N_AUDIO, d_model) or pixtral's
    ``patches`` (batch, num_patches, d_model) fp32."""
    import torch

    specs = {"tokens": torch.empty((batch, seq), dtype=torch.int32, device="meta")}
    if binding.kind == "whisper":
        from repro_torch.models.whisper import N_AUDIO

        specs["frames"] = torch.empty((batch, N_AUDIO, cfg.d_model), dtype=torch.float32,
                                      device="meta")
    if binding.kind == "pixtral":
        specs["patches"] = torch.empty((batch, cfg.num_patches, cfg.d_model),
                                       dtype=torch.float32, device="meta")
    return specs


def cache_specs(binding: ArchBinding, cfg: ModelConfig, batch: int, max_len: int, *,
                mesh=None):
    """The decode cache (or recurrent states) of ``batch`` sequences and
    ``max_len`` positions on meta: the family's ``make_cache``; on an
    abstract ``mesh`` (``launch.mesh.abstract_mesh``) this rank's block of
    it."""
    from repro_torch.train.serve_step import serve_family

    return serve_family(binding.kind).make_cache(cfg, batch, max_len, device="meta", mesh=mesh)


def abstract_params(binding: ArchBinding, cfg: ModelConfig, *, mesh=None):
    """``(params, axes)``: the family's ``init_fn`` at ``cfg``'s full width
    on meta, and the logical axes of its leaves; on an abstract ``mesh``
    the params are this rank's blocks in the serving layout (``lm_specs(
    serve=True)``: ``embed`` whole, tensor parallel over ``model``)."""
    params, axes = init_fn(binding)(cfg, seed=0, device="meta")
    if mesh is not None:
        from repro_torch.distributed import sharding as SH

        params = SH.shard_tree(params, lm_specs(cfg, params, axes, mesh, serve=True), mesh)
    return params, axes


def lm_axes(cfg: ModelConfig, axes, mesh):
    """The logical axes tree ``axes`` of an LM's params for
    ``sharding.tree_specs`` on ``mesh``: the transformers' and the prefix
    models' as they are (whisper's stacked ``enc`` / ``dec`` layers, its
    cross-attention ``xattn`` among them, resolve by their logical axes as
    a transformer layer does); zamba2's and xlstm's with the specs of their
    fused and head-split leaves given outright by their model
    (``zamba2.mesh_axes``, ``xlstm.mesh_axes``), their ``embed`` dims left
    to the rules (``sharding.given``: FSDP over ``data`` in training).  No
    ``model`` axis: as they are."""
    from repro_torch.distributed import sharding as SH

    mesh = SH.model_mesh(mesh)
    if mesh is None or cfg.family not in ("hybrid", "ssm"):
        return axes
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2 as Z

        return Z.mesh_axes(cfg, axes, mesh)
    from repro_torch.models import xlstm as X

    return X.mesh_axes(cfg, axes, mesh)


def lm_specs(cfg: ModelConfig, tree, axes, mesh, *, serve: bool = False) -> list:
    """One spec per leaf of ``tree`` (an LM's params, or a tree such as the
    training state whose leaves' axes are ``axes``): ``sharding.tree_specs``
    of ``lm_axes`` under ``sharding.lm_param_rules``, the training layout
    (FSDP over ``data``) or with ``serve`` the serving one (``embed``
    whole)."""
    from repro_torch.distributed import sharding as SH

    return SH.tree_specs(tree, lm_axes(cfg, axes, mesh), mesh,
                         SH.lm_param_rules(cfg, mesh, serve=serve))
