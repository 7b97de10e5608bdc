"""Zamba2-style hybrid (port of ``repro.models.zamba2``): a Mamba2 backbone
with one weight-SHARED attention + MLP block applied every ``attn_every``
layers.

``repro``'s simplifications are kept: the shared block reads the hidden
state only (no concatenated original embedding, no per-application LoRA
deltas); one shared block, full MHA; its MLP is tanh GELU with no gate.

The layer stack is segmented statically: ``cfg.num_layers // attn_every``
segments of ``attn_every`` mamba layers, each followed by one application
of the shared block (a site), then the trailing mamba layers.  Each site
owns its KV-cache slot (the weights are shared, the caches are not).  The
mamba layers are stacked along a leading layer dim, as ``repro``'s
``vmap`` draws them, and taken once a forward with one ``torch.unbind`` a
leaf (``transformer.layer_list``).

On the card every site's attention in the train and prefill forwards is
the attention kernel K9 (``layers.attention``), and a QR vocabulary's token
lookup is the QR gather K8: the tokens go through
``transformer.embed_tokens``, the value ``repro``'s ``qr_embedding.lookup``
gives.  Everything else is plain torch.

The stateful forwards write the cache in place, where ``repro`` returns a
new one: the prefill writes each layer's SSM and conv states and rows
[0, S) of each site's k and v slot, as ``transformer.forward_prefill``
does (``repro`` pads k and v to ``max_len`` and sets the slot); a decode
step writes row ``pos``.  With ``cfg.remat`` and gradients enabled the
training forward recomputes each mamba layer in the backward
(``torch.utils.checkpoint``, ``full`` or ``dots`` as
``transformer._remat_kwargs`` maps them), ``repro``'s ``jax.checkpoint``
over its scan body; the shared block is not recomputed there either.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import qr_embedding
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T


def num_attn_sites(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def init_zamba2(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random params and their logical axes, ``(params, axes)``: ``embed``,
    ``mamba`` (stacked), ``shared_attn``, ``shared_mlp``, ``shared_ln1``,
    ``shared_ln2``, ``final_norm``; drawn from a ``torch.Generator`` seeded
    with ``seed`` on the target device (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    g = device_mod.generator(dev)
    g.manual_seed(seed)
    kw = dict(generator=g, device=dev)
    params, axes = {}, {}
    params["embed"] = qr_embedding.init(cfg.emb_config, **kw)
    axes["embed"] = qr_embedding.param_axes(cfg.emb_config)
    params["mamba"], axes["mamba"] = T._stack_layers(cfg, M.init_mamba2, **kw)
    params["shared_attn"], axes["shared_attn"] = L.init_attention(cfg, **kw)
    params["shared_mlp"], axes["shared_mlp"] = L.init_mlp(cfg, **kw)
    for name in ("shared_ln1", "shared_ln2", "final_norm"):
        params[name], axes[name] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=dev)
    return params, axes


# the leaves the compute dtype reads: the projections (``w``, ``b``) and the
# mamba weights ``mamba2_fwd`` casts to it (A_log, dt_bias and norm_scale
# it reads in fp32)
_SERVING_CAST = ("w", "b", "in_proj", "out_proj", "conv_w", "conv_b", "D")


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with every leaf the forwards cast to the compute dtype on
    each call cast once (the vocabulary's tables, the shared block's
    projections, the mamba projections, conv and ``D``): the same logits bit
    for bit, half the weight bytes a decode step reads.  The norms, ``A_log``
    and ``dt_bias`` keep their dtype."""
    return T.cast_for_serving(params, cfg, _SERVING_CAST)


def _shared_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache=None, pos=None):
    h = L.apply_norm(params["shared_ln1"], x)
    attn_out, new_cache = L.attention(params["shared_attn"], h, cfg, cache=cache, pos=pos)
    x = x + attn_out
    h = L.apply_norm(params["shared_ln2"], x)
    x = x + L.mlp(params["shared_mlp"], h, cfg)
    return x, new_cache


def init_zamba2_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                      device=None) -> dict:
    """Zeros: ``ssm`` (L, B, H, P, N), ``conv`` (L, B, W-1, conv_dim), and
    each site's ``k`` / ``v`` (sites, B, max_len, KH, D)."""
    dtype = dtype or cfg.cdtype
    dev = device_mod.resolve(device)
    sites = num_attn_sites(cfg)
    h, pdim, n = M.num_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = M.d_inner(cfg) + 2 * cfg.ssm_groups * cfg.ssm_state
    kv = (sites, batch, max_len, cfg.kv_heads, cfg.head_dim_)
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, h, pdim, n), dtype=dtype, device=dev),
        "conv": torch.zeros((cfg.num_layers, batch, M.CONV_WIDTH - 1, conv_dim), dtype=dtype,
                            device=dev),
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def zamba2_cache_axes() -> dict:
    return {
        "ssm": ("layers", "batch", "heads", None, "state"),
        "conv": ("layers", "batch", None, "ffn"),
        "k": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
    }


def _segment_bounds(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """(start, stop, attn_after) per segment: ``attn_every``-layer mamba runs
    with a shared-attention application after each complete segment, plus a
    trailing remainder segment."""
    nl, every = cfg.num_layers, cfg.attn_every
    sites = num_attn_sites(cfg)
    segs = [(g * every, (g + 1) * every, True) for g in range(sites)]
    if sites * every < nl:
        segs.append((sites * every, nl, False))
    return segs


def forward_zamba2(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *, cache=None,
                   pos=None, decode: bool = False, last: bool = False):
    """tokens: (B, S) -> (logits, cache).  Train: ``cache=None`` (the cache
    returned is None).  Prefill: ``cache`` from ``init_zamba2_cache``,
    filled in place.  Decode: S == 1 at position ``pos``, the cache updated
    in place.  With ``last`` the head runs on the last row only (logits
    (B, 1, vocab))."""
    x = T.embed_tokens(params, tokens, cfg).to(cfg.cdtype)
    layers = T.layer_list({"layers": params["mamba"]})
    segs = _segment_bounds(cfg)

    if cache is None:
        def body(lp, h):
            return M.mamba2_fwd(lp, h, cfg)[0]

        remat = cfg.remat and torch.is_grad_enabled()
        kw = T._remat_kwargs(cfg) if remat else {}
        for start, stop, attn in segs:
            for lp in layers[start:stop]:
                x = ckpt.checkpoint(body, lp, x, use_reentrant=False, **kw) if remat \
                    else body(lp, x)
            if attn:
                x, _ = _shared_block(params, x, cfg)
    else:
        pos = None if pos is None else int(pos)
        s = tokens.shape[1]
        for g, (start, stop, attn) in enumerate(segs):
            for i in range(start, stop):
                x, (ssm, conv) = M.mamba2_fwd(layers[i], x, cfg, state=cache["ssm"][i],
                                              conv_state=cache["conv"][i], decode=decode)
                cache["ssm"][i] = ssm
                cache["conv"][i] = conv
            if not attn:
                continue
            if decode:
                x, _ = _shared_block(params, x, cfg, cache=(cache["k"][g], cache["v"][g]),
                                     pos=pos)
            else:        # prefill: full-sequence attention, then rows [0, S) of the slot
                x, (k, v) = _shared_block(params, x, cfg)
                cache["k"][g, :, :s] = k
                cache["v"][g, :, :s] = v
    x = L.apply_norm(params["final_norm"], x)
    if last:
        x = x[:, -1:, :]
    return T.lm_logits(params, x, cfg), cache
