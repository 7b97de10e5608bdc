"""Pixtral-12B backbone, a Mistral-NeMo decoder with a vision prefix (port
of ``repro.models.pixtral``).

The pixtral-ViT frontend is a stub, as in ``repro``: the batch carries the
patch embeddings (B, ``num_patches``, d_model), the vision encoder's and
adapter's output of the real model.  The sequence is ``[patches ; text
tokens]`` with causal attention over the whole of it; the logits are the
text positions'.  The params are the decoder LM's (``transformer.init_lm``).

On the card every layer's attention of the train and prefill forwards is
the attention kernel K9, causal over the num_patches + S positions (Sq ==
Skv, so its top-left mask is the causal one), and a QR vocabulary's token
lookup is the QR gather K8 (``transformer.embed_tokens``); the patches are
cast to the compute dtype and go in front of the tokens' rows.

Decode: the patches occupy cache slots [0, num_patches); text decoding
goes on from position num_patches + S with the transformer's one-token
step (``transformer.forward_decode``, the cache written in place).  The
prefill heads the last row alone, as ``repro``'s does.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T

init_pixtral = T.init_lm          # the decoder LM's parameter tree
init_cache = T.init_cache
cache_axes = T.cache_axes
serving_params = T.serving_params
forward_decode = T.forward_decode  # ``pos`` counts from the start of the prefix


def _with_prefix(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """(B, P + S, d) in the compute dtype: the patches, then the tokens'
    rows."""
    x_txt = T.embed_tokens(params, tokens, cfg).to(cfg.cdtype)
    return torch.cat([patches.to(cfg.cdtype), x_txt], dim=1)


def forward_train(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """patches: (B, P, d); tokens: (B, S) -> the text's logits (B, S, vocab);
    each layer recomputed in the backward with ``cfg.remat``."""
    x = T.run_layers(params, _with_prefix(params, patches, tokens, cfg), cfg)
    return T.lm_logits(params, x[:, patches.shape[1]:, :], cfg)


def forward_prefill(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig, max_len: int) -> tuple[torch.Tensor, dict]:
    """Prefill patches + prompt: the last token's logits (B, 1, vocab) and
    the cache of ``max_len`` positions, prefix included, [0, P + S) filled."""
    return T.prefill_rows(params, _with_prefix(params, patches, tokens, cfg), cfg, max_len)
