"""Serving steps: prefill + one-token decode, one surface for every model
family (port of ``repro.train.serve_step``).

    make_cache(cfg, batch, max_len, mesh=)        -> cache (+ axes via cache_axes)
    prefill(params, batch, cfg, max_len, mesh=)   -> (last logits, cache)
    decode(params, cache, token, pos, cfg, mesh=) -> (logits, cache)
    prepare(params, cfg)                          -> the params a server holds

Every family of ``repro`` is ported: the transformers, zamba2, xlstm and
the prefix models whisper (its batch carries ``"frames"``) and pixtral
(``"patches"``).  ``greedy_generate`` runs under ``torch.inference_mode``
with no compile step (``repro`` jits the prefill and the decode step).  The
transformer's, zamba2's, whisper's and pixtral's decode write the cache in
place, so the cache handed back is the one prefill allocated; xlstm's
decode returns new states.

On a ``mesh`` (one process a rank, ``launch.serve --mesh-shape``) every
family serves tensor-parallel: ``params`` are the rank's blocks
(``registry.lm_specs``), the batch its ``data`` block (whisper's frames
and pixtral's patches too), the cache or states its block
(``sharding.cache_block``; zamba2's SSM states and xlstm's mLSTM states by
the heads the rank runs; whisper's self and cross k / v by its kv heads)
and the logits whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeFamily:
    make_cache: Callable          # (cfg, batch, max_len, device=, mesh=) -> cache
    cache_axes: Callable          # () -> logical-axes tree
    prefill: Callable             # (params, batch, cfg, max_len, mesh=) -> (logits, cache)
    decode: Callable              # (params, cache, token, pos, cfg, mesh=) -> (logits, cache)
    prepare: Callable             # (params, cfg) -> params cast once for serving


# ---------------------------------------------------------------------------
# decoder-only transformers (qwen2, granite, chatglm3, minitron; the MoE
# ones granite-moe and qwen3-moe)
# ---------------------------------------------------------------------------

def _tf_family() -> ServeFamily:
    from repro_torch.models import transformer as T

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None, mesh=None: T.init_cache(
            cfg, b, m, device=device, mesh=mesh),
        cache_axes=T.cache_axes,
        prefill=lambda p, batch, cfg, m, mesh=None: T.forward_prefill(
            p, batch["tokens"], cfg, m, mesh=mesh),
        decode=lambda p, c, tok, pos, cfg, mesh=None: T.forward_decode(
            p, tok, c, pos, cfg, mesh=mesh),
        prepare=T.serving_params,
    )


# ---------------------------------------------------------------------------
# the sub-quadratic models: the zamba2 hybrid (a KV cache a site beside each
# layer's SSM state) and xLSTM (recurrent states only).  Their prefills give
# ``repro``'s last-row logits but head the last row alone, where ``repro``
# heads every row and slices: at prefill_32k xlstm-125m's whole logits would
# be 32 x 32,768 x 50,304 bf16, 105 GB
# ---------------------------------------------------------------------------

def _zamba_family() -> ServeFamily:
    from repro_torch.models import zamba2 as Z

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None, mesh=None: Z.init_zamba2_cache(
            cfg, b, m, device=device, mesh=mesh),
        cache_axes=Z.zamba2_cache_axes,
        prefill=_zamba_prefill,
        decode=lambda p, c, tok, pos, cfg, mesh=None: Z.forward_zamba2(
            p, tok, cfg, cache=c, pos=pos, decode=True, mesh=mesh),
        prepare=Z.serving_params,
    )


def _zamba_prefill(params, batch: dict, cfg: ModelConfig, max_len: int, mesh=None):
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import zamba2 as Z

    tokens = batch["tokens"]
    mesh = SH.model_mesh(mesh)
    cache = Z.init_zamba2_cache(cfg, tokens.shape[0] * SH.data_ranks(mesh), max_len,
                                device=tokens.device, mesh=mesh)
    return Z.forward_zamba2(params, tokens, cfg, cache=cache, pos=0, last=True, mesh=mesh)


def _xlstm_family() -> ServeFamily:
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import xlstm as X

    def prefill(params, batch, cfg, max_len, mesh=None):
        tokens = batch["tokens"]
        mesh = SH.model_mesh(mesh)
        states = X.init_xlstm_state(cfg, tokens.shape[0] * SH.data_ranks(mesh),
                                    device=tokens.device, mesh=mesh)
        return X.forward_xlstm(params, tokens, cfg, states=states, last=True, mesh=mesh)

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None, mesh=None: X.init_xlstm_state(
            cfg, b, device=device, mesh=mesh),
        cache_axes=lambda: None,     # repro's: recurrent states replicated over model
        prefill=prefill,
        decode=lambda p, c, tok, pos, cfg, mesh=None: X.forward_xlstm(
            p, tok, cfg, states=c, decode=True, mesh=mesh),
        prepare=X.serving_params,
    )


# ---------------------------------------------------------------------------
# the prefix models: whisper (encoder-decoder; the cache holds the frozen
# cross k / v beside the self k / v) and pixtral (the patches occupy the
# cache's first ``num_patches`` positions, so its cache and prefill take
# ``max_len + num_patches`` of them)
# ---------------------------------------------------------------------------

def _whisper_family() -> ServeFamily:
    from repro_torch.models import whisper as W

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None, mesh=None: W.init_cache(
            cfg, b, m, device=device, mesh=mesh),
        cache_axes=W.cache_axes,
        prefill=lambda p, batch, cfg, m, mesh=None: W.forward_prefill(
            p, batch["frames"], batch["tokens"], cfg, m, mesh=mesh),
        decode=lambda p, c, tok, pos, cfg, mesh=None: W.forward_decode(
            p, tok, c, pos, cfg, mesh=mesh),
        prepare=W.serving_params,
    )


def _pixtral_family() -> ServeFamily:
    from repro_torch.models import pixtral as P

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None, mesh=None: P.init_cache(
            cfg, b, m + cfg.num_patches, device=device, mesh=mesh),
        cache_axes=P.cache_axes,
        prefill=lambda p, batch, cfg, m, mesh=None: P.forward_prefill(
            p, batch["patches"], batch["tokens"], cfg, m + cfg.num_patches, mesh=mesh),
        decode=lambda p, c, tok, pos, cfg, mesh=None: P.forward_decode(
            p, tok, c, pos, cfg, mesh=mesh),
        prepare=P.serving_params,
    )


_FAMILIES: dict[str, Callable[[], ServeFamily]] = {
    "transformer": _tf_family,
    "zamba2": _zamba_family,
    "xlstm": _xlstm_family,
    "whisper": _whisper_family,
    "pixtral": _pixtral_family,
}


def serve_family(kind: str) -> ServeFamily:
    return _FAMILIES[kind]()


# ---------------------------------------------------------------------------
# batched serving loop
# ---------------------------------------------------------------------------

@torch.inference_mode()
def greedy_generate(
    fam: ServeFamily,
    params: Any,
    batch: dict,
    cfg: ModelConfig,
    *,
    max_new: int,
    max_len: int,
    mesh=None,
) -> torch.Tensor:
    """Prefill then greedy-decode ``max_new`` tokens.  Returns (B, max_new)
    int32 on the batch's device.  On a ``mesh`` the loop of one rank: its
    blocks of ``params``, its ``data`` block of ``batch`` and of the tokens
    returned; every rank takes the ``argmax`` of the same whole logits."""
    logits, cache = fam.prefill(params, batch, cfg, max_len, mesh=mesh)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    pos0 = batch["tokens"].shape[1]
    if "patches" in batch:
        pos0 += batch["patches"].shape[1]
    outs = []
    for i in range(max_new):
        outs.append(tok[:, 0])
        logits, cache = fam.decode(params, cache, tok, pos0 + i, cfg, mesh=mesh)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    return torch.stack(outs, dim=1)
