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

On a mesh (``launch.serve`` / ``launch.train --mesh-shape``) every mamba
layer runs tensor-parallel by SSM heads (``mamba2.mamba2_fwd(mesh=)``) and
the shared block through the tensor-parallel ``layers.attention`` /
``mlp``; the cache is the rank's block (``init_zamba2_cache(mesh=)``).
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import qr_embedding
from repro_torch.distributed import sharding as SH
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


def mesh_axes(cfg: ModelConfig, axes: dict, mesh) -> dict:
    """``init_zamba2``'s axes with the mamba layers' leaves given their
    specs on ``mesh`` outright (``mamba2.layout`` behind the layer dim: a
    contiguous block of the fused ``in_proj`` or ``conv_w`` is not the
    rank's columns), each ``embed`` dim left to the rules
    (``sharding.given``: FSDP over ``data`` in training)."""
    lay = M.layout(cfg, mesh)
    return dict(axes, mamba={k: SH.given(SH.P(None, *lay[k]), a)
                             for k, a in axes["mamba"].items()})


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


_SHARED = ("shared_ln1", "shared_attn", "shared_ln2", "shared_mlp")


def _shared_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *, cache=None, pos=None,
                  mesh=None):
    h = L.apply_norm(params["shared_ln1"], x)
    attn_out, new_cache = L.attention(params["shared_attn"], h, cfg, cache=cache, pos=pos,
                                      mesh=mesh)
    x = x + attn_out
    h = L.apply_norm(params["shared_ln2"], x)
    x = x + L.mlp(params["shared_mlp"], h, cfg, mesh=mesh)
    return x, new_cache


def _cache(cfg: ModelConfig, rows: int, max_len: int, dtype, dev, mesh) -> dict:
    """Zeros for ``rows`` sequences: this rank's heads and conv columns
    (``mamba2.ssm_state_shapes``) and kv heads (``sharding.cache_heads``) on
    a ``mesh``."""
    state, conv = M.ssm_state_shapes(cfg, rows, mesh)
    kv = (num_attn_sites(cfg), rows, max_len, SH.cache_heads(cfg, mesh), cfg.head_dim_)
    return {
        "ssm": torch.zeros((cfg.num_layers, *state), dtype=dtype, device=dev),
        "conv": torch.zeros((cfg.num_layers, *conv), dtype=dtype, device=dev),
        "k": torch.zeros(kv, dtype=dtype, device=dev),
        "v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def init_zamba2_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
                      device=None, mesh=None) -> dict:
    """Zeros: ``ssm`` (L, B, H, P, N), ``conv`` (L, B, W-1, conv_dim), and
    each site's ``k`` / ``v`` (sites, B, max_len, KH, D).  On a ``mesh``
    (default the active one) this rank's block of the cache of ``batch``
    (global) sequences: its ``data`` block of them, its SSM heads and conv
    columns (``mamba2.ssm_split``: its x, B and C whole) and the kv heads
    of its attention heads (``sharding.cache_block`` with the sites in place
    of the layers)."""
    dtype = dtype or cfg.cdtype
    dev = device_mod.resolve(device)
    mesh = SH.current_mesh() if mesh is None else mesh
    rows = SH.cache_block(cfg, mesh, batch, max_len)[1]
    return _cache(cfg, rows, max_len, dtype, dev, mesh)


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
                   pos=None, decode: bool = False, last: bool = False, mesh=None):
    """tokens: (B, S) -> (logits, cache).  Train: ``cache=None`` (the cache
    returned is None).  Prefill: ``cache`` from ``init_zamba2_cache``,
    filled in place.  Decode: S == 1 at position ``pos``, the cache updated
    in place.  With ``last`` the head runs on the last row only (logits
    (B, 1, vocab)).

    On a ``mesh`` (default the active one, ``sharding.model_mesh``)
    ``params`` are this rank's blocks (``registry.lm_axes``), ``tokens`` its
    batch block and the cache its block: the tokens through the two-level
    GnR, every mamba layer tensor-parallel by SSM heads, the shared block
    through the tensor-parallel attention and MLP; the logits are this
    rank's vocabulary slice in training (``transformer.lm_logits``) and
    whole when serving (``transformer.whole_logits``)."""
    mesh = SH.model_mesh(mesh)
    x = T.embed_tokens(params, tokens, cfg, mesh=mesh).to(cfg.cdtype)
    layers = T.layer_list({"layers": params["mamba"]})
    segs = _segment_bounds(cfg)

    if cache is None:
        gather = SH.fsdp_layers("mamba")

        def body(lp, h):
            return M.mamba2_fwd(lp if gather is None else gather(lp), h, cfg, mesh=mesh)[0]

        remat = cfg.remat and torch.is_grad_enabled()
        kw = T._remat_kwargs(cfg) if remat else {}
        # the shared block whole over ``data`` (FSDP), gathered once for
        # every site: it is not recomputed, so each site's own gather would
        # keep its own whole copy for the backward
        shared = {k: SH.fsdp_take(params, k) for k in _SHARED}
        for start, stop, attn in segs:
            for lp in layers[start:stop]:
                x = ckpt.checkpoint(body, lp, x, use_reentrant=False, **kw) if remat \
                    else body(lp, x)
            if attn:
                x, _ = _shared_block(shared, x, cfg, mesh=mesh)
    else:
        pos = None if pos is None else int(pos)
        s = tokens.shape[1]
        for g, (start, stop, attn) in enumerate(segs):
            for i in range(start, stop):
                x, (ssm, conv) = M.mamba2_fwd(layers[i], x, cfg, state=cache["ssm"][i],
                                              conv_state=cache["conv"][i], decode=decode,
                                              mesh=mesh)
                cache["ssm"][i] = ssm
                cache["conv"][i] = conv
            if not attn:
                continue
            if decode:
                x, _ = _shared_block(params, x, cfg, cache=(cache["k"][g], cache["v"][g]),
                                     pos=pos, mesh=mesh)
            else:        # prefill: full-sequence attention, then rows [0, S) of the slot
                x, (k, v) = _shared_block(params, x, cfg, mesh=mesh)
                cache["k"][g, :, :s] = k
                cache["v"][g, :, :s] = v
    x = L.apply_norm(SH.fsdp_take(params, "final_norm"), x)
    if last:
        x = x[:, -1:, :]
    head = T.lm_logits if cache is None else T.whole_logits
    return head(params, x, cfg, mesh=mesh), cache
