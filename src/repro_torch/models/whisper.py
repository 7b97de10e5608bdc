"""Whisper-large-v3 backbone, an encoder–decoder transformer (port of
``repro.models.whisper``).

The conv / mel frontend is a stub, as in ``repro``: the batch carries the
frame embeddings (B, ``N_AUDIO``, d_model), the conv output of the real
model.  The backbone is ``repro``'s: pre-LayerNorm, GELU MLPs, MHA
(kv_heads == num_heads), sinusoidal positions on the encoder and on the
decoder (``repro``'s two formulas, fp32: the table of ``sinusoid_positions``
for a prefill, ``_sinusoid_at``'s one row for a decode step), the tied
vocabulary head, cross-attention into the encoder's output.

Both stacks are stacked, as ``repro``'s ``vmap`` draws them: every leaf of
``params["enc"]`` and ``params["dec"]`` holds its layers along a leading
axis, taken once a forward with one ``torch.unbind`` a leaf
(``transformer.layer_list``).  With ``cfg.remat`` and gradients enabled
``forward_train`` recomputes each encoder and each decoder layer in the
backward (``transformer.remat_layers``), ``repro``'s ``jax.checkpoint``
over its two scan bodies.

On the card every attention of the train and prefill forwards is the
attention kernel K9 (``layers.attention``): the encoder's self-attention
non-causal over the ``N_AUDIO`` frames, the decoder's causal over its
tokens, and its cross-attention non-causal, S queries over the
``N_AUDIO`` encoder states.  A QR vocabulary's token lookup is the QR
gather K8 (``transformer.embed_tokens``, the value ``repro``'s
``qr_embedding.lookup`` gives).  The norms, projections, MLPs, the head and
the decode attention are plain torch.

Serving: the prefill runs the encoder once and writes every decoder layer's
self k / v into rows [0, S) and its cross k / v (``ck`` / ``cv``) into a
cache allocated once (``init_cache``); a decode step writes the self cache
in place at ``pos`` and reads the frozen cross k / v over all ``N_AUDIO``
positions.  ``repro`` returns new caches, and computes the cross k / v
twice in its prefill (inside ``attention(kv_src=)`` and again for the
cache, from the same weights and encoder states): the port takes the cache's
from the attention call, the same values computed once.

On a mesh (``launch.serve`` / ``launch.train --mesh-shape``, one process a
rank) every encoder and decoder layer runs tensor-parallel over ``model``
on the rank's blocks (``layers.attention`` / ``mlp(mesh=)``: its heads, its
``d_ff`` columns; a block whose heads or ``d_ff`` the axis does not divide
runs replicated), the tokens go through the two-level GnR
(``transformer.embed_tokens(mesh=)``: K8 on the rank's routed Q shard) and
the tied head is vocab-parallel.  The cross-attention projects the k / v of
the rank's heads from the encoder states, which every rank holds whole:
they enter once ahead of the decoder stack (``_cross_src``), so that their
gradient sums every rank's heads' partial in one all-reduce.  The cache is
the rank's block: its ``data`` block of the sequences and its kv heads, the
cross k / v of all ``N_AUDIO`` positions (``init_cache(mesh=)``).
"""

from __future__ import annotations

import math

import torch

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import qr_embedding
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

# whisper's 30 s audio context after the conv frontend (stubbed), 1,500
# frames padded to 1,536 as in ``repro``
N_AUDIO = 1536


def _freqs(dim: int, device) -> torch.Tensor:
    half = dim // 2
    return torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))


def sinusoid_positions(n: int, dim: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """(n, dim) table: sin then cos of each position times the frequencies,
    in fp32, cast to ``dtype``."""
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * _freqs(dim, device)[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _sinusoid_at(pos: int, dim: int, dtype, *, device=None) -> torch.Tensor:
    """The row of one position, (1, 1, dim): ``pos`` times the frequencies in
    fp32, as ``repro`` computes a decode step's row."""
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) * _freqs(dim, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)[None, None, :]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_enc_layer(cfg: ModelConfig, *, generator: torch.Generator, device):
    kw = dict(generator=generator, device=device)
    params, axes = {}, {}
    params["attn"], axes["attn"] = L.init_attention(cfg, **kw)
    params["mlp"], axes["mlp"] = L.init_mlp(cfg, **kw)
    for name in ("ln1", "ln2"):
        params[name], axes[name] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=device)
    return params, axes


def _init_dec_layer(cfg: ModelConfig, *, generator: torch.Generator, device):
    kw = dict(generator=generator, device=device)
    params, axes = {}, {}
    params["attn"], axes["attn"] = L.init_attention(cfg, **kw)
    params["xattn"], axes["xattn"] = L.init_attention(cfg, cross=True, **kw)
    params["mlp"], axes["mlp"] = L.init_mlp(cfg, **kw)
    for name in ("ln1", "lnx", "ln2"):
        params[name], axes[name] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=device)
    return params, axes


def init_whisper(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random params and their logical axes, ``(params, axes)``: ``embed``,
    ``enc`` and ``dec`` (stacked), ``enc_norm``, ``dec_norm``; drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device (the card
    unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    g = device_mod.generator(dev)
    g.manual_seed(seed)
    kw = dict(generator=g, device=dev)
    params, axes = {}, {}
    params["embed"] = qr_embedding.init(cfg.emb_config, **kw)
    axes["embed"] = qr_embedding.param_axes(cfg.emb_config)
    params["enc"], axes["enc"] = T._stack_layers(cfg, _init_enc_layer, count=cfg.enc_layers, **kw)
    params["dec"], axes["dec"] = T._stack_layers(cfg, _init_dec_layer, count=cfg.dec_layers, **kw)
    for name in ("enc_norm", "dec_norm"):
        params[name], axes[name] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=dev)
    return params, axes


# the vocabulary's tables and every projection's ``w`` and ``b`` cast once
# to the compute dtype (the same logits bit for bit); the layer norms keep
# theirs
serving_params = T.serving_params


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_layer_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh=None) -> torch.Tensor:
    h = L.apply_norm(p["ln1"], x)
    attn, _ = L.attention(p["attn"], h, cfg, causal=False, use_rope=False, mesh=mesh)
    y = x + attn
    return y + L.mlp(p["mlp"], L.apply_norm(p["ln2"], y), cfg, mesh=mesh)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           mesh=None) -> torch.Tensor:
    """frames: (B, N_AUDIO, d_model), the stub conv output -> the encoder's
    states, each layer's attention K9 non-causal on the card; on a ``mesh``
    (``sharding.model_mesh``) each layer tensor-parallel on the rank's
    blocks, the states whole on every rank."""
    cd = cfg.cdtype
    x = frames.to(cd) + sinusoid_positions(frames.shape[1], cfg.d_model, cd,
                                           device=frames.device)[None]
    x = T.remat_layers(T.layer_list(params, "enc"), x, cfg,
                       lambda p, y: _enc_layer_fwd(p, y, cfg, mesh),
                       gather=SH.fsdp_layers("enc"))
    return L.apply_norm(SH.fsdp_take(params, "enc_norm"), x)


def _cross_src(enc_out: torch.Tensor, cfg: ModelConfig, mesh) -> torch.Tensor:
    """The encoder states as every decoder layer's cross-attention reads
    them: on a ``mesh`` whose ``model`` axis splits the heads, entered once
    (``collectives.enter``: each rank's cross k / v are its heads' own, so
    the states' cotangent is summed over ``model`` in one all-reduce, where
    entering them in each layer would take one a layer); as they are where
    the attention runs replicated (each rank's cotangent is then whole)."""
    if SH.head_split(cfg, mesh) is None:
        return enc_out
    [src] = collectives.enter([enc_out], mesh, "model")
    return src


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_layer_fwd(p: dict, x: torch.Tensor, enc_out, cfg: ModelConfig, *, cache=None,
                   pos=None, cross_kv=None, mesh=None):
    """One decoder layer -> (x, self k / v, cross k / v).  Train / prefill
    (``cache`` None): causal self-attention, then cross-attention on
    ``enc_out`` (``_cross_src``'s, entered on a mesh), each through K9; the
    pairs are (B, S, KH, D) and (B, N_AUDIO, KH, D), the rank's kv heads on
    a ``mesh``.  Decode: ``cache`` the layer's self k / v, written in place
    at ``pos``, and ``cross_kv`` its frozen ``ck`` / ``cv``, read over every
    position (``decode_attention`` at ``N_AUDIO - 1``): on a ``mesh`` the
    rank's q heads against its block of them, ``wo`` row-parallel and its
    partials summed by one ``collectives.combine``."""
    h = L.apply_norm(p["ln1"], x)
    attn, self_kv = L.attention(p["attn"], h, cfg, causal=True, use_rope=False, cache=cache,
                                pos=pos, mesh=mesh)
    x = x + attn
    h = L.apply_norm(p["lnx"], x)
    if cross_kv is not None:
        xk, xv = cross_kv
        b, s, _ = h.shape
        split = SH.head_split(cfg, mesh)
        heads = cfg.num_heads if split is None else split.q
        q = L.dense(p["xattn"]["wq"], h, cfg.cdtype).reshape(b, s, heads, cfg.head_dim_)
        y = L.decode_attention(q.transpose(1, 2), xk.transpose(1, 2).to(cfg.cdtype),
                               xv.transpose(1, 2).to(cfg.cdtype), xk.shape[1] - 1)
        xattn = L.dense(p["xattn"]["wo"], y.transpose(1, 2).reshape(b, s, -1), cfg.cdtype)
        if split is not None:
            xattn = collectives.combine(xattn, mesh, "model")
    else:
        xattn, cross_kv = L.attention(p["xattn"], h, cfg, causal=False, use_rope=False,
                                      kv_src=enc_out, mesh=mesh)
    x = x + xattn
    x = x + L.mlp(p["mlp"], L.apply_norm(p["ln2"], x), cfg, mesh=mesh)
    return x, self_kv, cross_kv


def _embed_dec(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
               pos: int | None = None, mesh=None) -> torch.Tensor:
    """The tokens' rows (``transformer.embed_tokens``: K8 for a QR vocabulary
    on the card; the two-level GnR on a ``mesh``) plus their positions:
    [0, S) from the table, or the one row of the decode position ``pos``."""
    cd = cfg.cdtype
    x = T.embed_tokens(params, tokens, cfg, mesh=mesh).to(cd)
    if pos is None:
        return x + sinusoid_positions(tokens.shape[1], cfg.d_model, cd, device=x.device)[None]
    return x + _sinusoid_at(pos, cfg.d_model, cd, device=x.device)


def forward_train(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, N_AUDIO, d); tokens: (B, S) -> logits (B, S, vocab).
    Under the active mesh (``sharding.model_mesh``) ``params`` are this
    rank's blocks, ``frames`` / ``tokens`` its batch block and the logits
    its vocabulary slice (``transformer.vocab_range``); the mesh is taken
    once here, so the layers' recompute in the backward runs on it too."""
    mesh = SH.model_mesh()
    enc_out = _cross_src(encode(params, frames, cfg, mesh=mesh), cfg, mesh)
    x = _embed_dec(params, tokens, cfg, mesh=mesh)
    x = T.remat_layers(T.layer_list(params, "dec"), x, cfg,
                       lambda p, y, e: _dec_layer_fwd(p, y, e, cfg, mesh=mesh)[0], enc_out,
                       gather=SH.fsdp_layers("dec"))
    x = L.apply_norm(SH.fsdp_take(params, "dec_norm"), x)
    return T.lm_logits(params, x, cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# serving: the prefill builds the self cache and the frozen cross k / v; a
# decode step is one token
# ---------------------------------------------------------------------------

def _zeros(cfg: ModelConfig, rows: int, max_len: int, dtype, dev, mesh) -> dict:
    kv = (SH.cache_heads(cfg, mesh), cfg.head_dim_)
    shapes = {"k": max_len, "v": max_len, "ck": N_AUDIO, "cv": N_AUDIO}
    return {k: torch.zeros((cfg.dec_layers, rows, n, *kv), dtype=dtype, device=dev)
            for k, n in shapes.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device=None,
               mesh=None) -> dict:
    """``{"k", "v"}`` (dec_layers, B, max_len, KH, D) and ``{"ck", "cv"}``
    (dec_layers, B, N_AUDIO, KH, D), zeros; on a ``mesh`` (default the
    active one) this rank's block of the cache of ``batch`` (global)
    sequences: its ``data`` block of them and the kv heads its q heads read
    (``sharding.cache_heads``), every position."""
    mesh = SH.current_mesh() if mesh is None else mesh
    return _zeros(cfg, SH.batch_rows(batch, mesh), max_len, dtype or cfg.cdtype,
                  device_mod.resolve(device), mesh)


def cache_axes() -> dict:
    return {
        "k": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
        "ck": ("layers", "batch", None, "kv_heads", "head_dim"),
        "cv": ("layers", "batch", None, "kv_heads", "head_dim"),
    }


def forward_prefill(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig, max_len: int, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """The encoder once, then the prompt through the decoder: (the last
    token's logits (B, 1, vocab), the cache with self k / v rows [0, S) and
    the cross k / v filled).  On a ``mesh`` (default the active one,
    ``sharding.model_mesh``) ``params`` are this rank's blocks and
    ``frames`` / ``tokens`` its batch block: the layers tensor-parallel, the
    cache this rank's block (``init_cache``), the logits whole
    (``transformer.whole_logits``)."""
    mesh = SH.model_mesh(mesh)
    b, s = tokens.shape
    cache = _zeros(cfg, b, max_len, cfg.cdtype, tokens.device, mesh)
    enc_out = _cross_src(encode(params, frames, cfg, mesh=mesh), cfg, mesh)
    x = _embed_dec(params, tokens, cfg, mesh=mesh)
    for i, p in enumerate(T.layer_list(params, "dec")):
        x, (k, v), (ck, cv) = _dec_layer_fwd(p, x, enc_out, cfg, mesh=mesh)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        cache["ck"][i] = ck
        cache["cv"][i] = cv
    x = L.apply_norm(params["dec_norm"], x[:, -1:, :])
    return T.whole_logits(params, x, cfg, mesh=mesh), cache


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos: int,
                   cfg: ModelConfig, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B, 1); the cache of ``forward_prefill``,
    its self k / v written in place at ``pos`` and returned.  On a ``mesh``
    (default the active one) this rank's blocks, batch block and cache
    block, as ``forward_prefill``; the logits whole."""
    mesh = SH.model_mesh(mesh)
    pos = int(pos)
    x = _embed_dec(params, token, cfg, pos=pos, mesh=mesh)
    for i, p in enumerate(T.layer_list(params, "dec")):
        x, _, _ = _dec_layer_fwd(p, x, None, cfg, cache=(cache["k"][i], cache["v"][i]), pos=pos,
                                 cross_kv=(cache["ck"][i], cache["cv"][i]), mesh=mesh)
    x = L.apply_norm(params["dec_norm"], x)
    return T.whole_logits(params, x, cfg, mesh=mesh), cache
