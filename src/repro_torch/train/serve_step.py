"""Serving steps: prefill + one-token decode, one surface for every model
family (port of ``repro.train.serve_step``).

    make_cache(cfg, batch, max_len)        -> cache (+ axes via cache_axes)
    prefill(params, batch, cfg, max_len)   -> (last logits, cache)
    decode(params, cache, token, pos, cfg) -> (logits, cache)
    prepare(params, cfg)                   -> the params a server holds

The transformer family is ported; the other families raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
``greedy_generate`` runs under ``torch.inference_mode`` with no compile
step (``repro`` jits the prefill and the decode step).  Its decode writes
the cache in place (``models/transformer.py``), so the cache handed back
is the one prefill allocated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import NOT_PORTED


@dataclasses.dataclass(frozen=True)
class ServeFamily:
    make_cache: Callable          # (cfg, batch, max_len, device=) -> cache
    cache_axes: Callable          # () -> logical-axes tree
    prefill: Callable             # (params, batch, cfg, max_len) -> (logits, cache)
    decode: Callable              # (params, cache, token, pos, cfg) -> (logits, cache)
    prepare: Callable             # (params, cfg) -> params cast once for serving


# ---------------------------------------------------------------------------
# decoder-only transformers (qwen2, granite, chatglm3, minitron; the MoE
# ones granite-moe and qwen3-moe)
# ---------------------------------------------------------------------------

def _tf_family() -> ServeFamily:
    from repro_torch.models import transformer as T

    return ServeFamily(
        make_cache=lambda cfg, b, m, device=None: T.init_cache(cfg, b, m, device=device),
        cache_axes=T.cache_axes,
        prefill=lambda p, batch, cfg, m: T.forward_prefill(p, batch["tokens"], cfg, m),
        decode=lambda p, c, tok, pos, cfg: T.forward_decode(p, tok, c, pos, cfg),
        prepare=T.serving_params,
    )


_FAMILIES: dict[str, Callable[[], ServeFamily]] = {
    "transformer": _tf_family,
}


def serve_family(kind: str) -> ServeFamily:
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"the {kind} serve family is not ported yet; {NOT_PORTED[kind]} brings it")
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
) -> torch.Tensor:
    """Prefill then greedy-decode ``max_new`` tokens.  Returns (B, max_new)
    int32 on the batch's device."""
    logits, cache = fam.prefill(params, batch, cfg, max_len)
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    pos0 = batch["tokens"].shape[1]
    if "patches" in batch:
        pos0 += batch["patches"].shape[1]
    outs = []
    for i in range(max_new):
        outs.append(tok[:, 0])
        logits, cache = fam.decode(params, cache, tok, pos0 + i, cfg)
        tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    return torch.stack(outs, dim=1)
