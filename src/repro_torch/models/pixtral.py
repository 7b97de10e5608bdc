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

On a mesh (``launch.serve`` / ``launch.train --mesh-shape``, one process a
rank) the transformer's meshed path runs it: the rank's ``data`` block of
the patches goes in front of its tokens' rows from the two-level GnR
(``transformer.embed_tokens(mesh=)``), every layer tensor-parallel over
``model`` (``transformer.run_layers`` / ``prefill_rows`` /
``forward_decode(mesh=)``), the untied head column-parallel, the cache the
rank's block (``init_cache(mesh=)``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.models import transformer as T

init_pixtral = T.init_lm          # the decoder LM's parameter tree
init_cache = T.init_cache
cache_axes = T.cache_axes
serving_params = T.serving_params
forward_decode = T.forward_decode  # ``pos`` counts from the start of the prefix


def _with_prefix(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig, mesh=None) -> torch.Tensor:
    """(B, P + S, d) in the compute dtype: the patches, then the tokens'
    rows (on a ``mesh`` from the two-level GnR)."""
    x_txt = T.embed_tokens(params, tokens, cfg, mesh=mesh).to(cfg.cdtype)
    return torch.cat([patches.to(cfg.cdtype), x_txt], dim=1)


def forward_train(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """patches: (B, P, d); tokens: (B, S) -> the text's logits (B, S, vocab);
    each layer recomputed in the backward with ``cfg.remat``.  Under the
    active mesh (``sharding.model_mesh``) this rank's blocks and batch
    block, the logits its vocabulary slice (``transformer.vocab_range``);
    the mesh is taken once here, as ``transformer.forward_train`` takes
    it."""
    mesh = SH.model_mesh()
    x = T.run_layers(params, _with_prefix(params, patches, tokens, cfg, mesh), cfg, mesh=mesh)
    return T.lm_logits(params, x[:, patches.shape[1]:, :], cfg, mesh=mesh)


def forward_prefill(params: dict, patches: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig, max_len: int, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """Prefill patches + prompt: the last token's logits (B, 1, vocab) and
    the cache of ``max_len`` positions, prefix included, [0, P + S) filled;
    on a ``mesh`` (default the active one) this rank's blocks, batch block
    and cache block, the logits whole (``transformer.prefill_rows``)."""
    mesh = SH.model_mesh(mesh)
    return T.prefill_rows(params, _with_prefix(params, patches, tokens, cfg, mesh), cfg,
                          max_len, mesh=mesh)
