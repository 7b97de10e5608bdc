"""Decoder-only LM (port of ``repro.models.transformer``): the dense
transformers qwen2-1.5b, granite-34b, chatglm3-6b and minitron-4b, and the
MoE transformers granite-moe-3b-a800m and qwen3-moe-235b-a22b.

GQA (and MQA) attention with an explicit head_dim, RoPE (full or partial),
qkv bias, q/k norm, SwiGLU / GeLU / ReLU² MLP or the capacity-based top-k
MoE (``models/moe.py``, where ``num_experts > 0``), tied or untied vocab
head, and the paper's weight-sharing vocabulary (dense / hashed / qr) with
the QR-factorized tied head.

Layers are stacked, as ``repro``'s: every leaf of ``params["layers"]``
holds all L layers along a leading axis, so ``convert`` and checkpoints map
the two packages' trees one to one.  Each forward takes the L layers once
with one ``torch.unbind`` a leaf (``layer_list``) and runs them in a Python
loop where ``repro`` scans: under autograd the backward of an unbind is one
stack of the L gradients, where L views ``[i]`` would each write a zero
tensor of the whole stacked leaf (at qwen2-1.5b's width 28 x 5.2 GB).

With ``cfg.remat`` and gradients enabled, ``forward_train`` runs each layer
under ``torch.utils.checkpoint.checkpoint`` (non-reentrant), as ``repro``
wraps its scan body in ``jax.checkpoint``: ``remat_policy="full"`` saves
only the layer's input and recomputes the layer in the backward;
``"dots"`` saves the matrix products' outputs (``aten.mm``, ``addmm``,
``bmm``, ``matmul``: ``checkpoint_dots``) and recomputes the rest.  The
recompute runs K9 again, so under ``"full"`` a layer launches it twice a
training step.  Under ``inference_mode`` or ``no_grad`` nothing is
checkpointed.

On the card, every layer's attention in ``forward_train`` and
``forward_prefill`` is the attention kernel K9, and a QR vocabulary's token
lookup (``add`` reconstruction) is the QR gather K8; the projections, the
MLP, the MoE's routing, dispatch and expert products, the heads, the norms
and the decode attention are plain torch (``repro`` computes them outside
Pallas too).
``forward_prefill`` writes each layer's k and v into a cache allocated once
(``init_cache``) and ``forward_decode`` writes row ``pos`` of it in place,
where ``repro`` returns new caches.  ``repro``'s sharding constraints have
no counterpart on one card.

On a mesh (``launch.train --mesh-shape``, one process a rank) the
training forward runs under the mesh of ``sharding.use_rules``, on this
rank's blocks (``sharding.lm_param_rules``) and batch block: the tokens
through the two-level GnR (``sharded_embedding.token_embed_inline``: K8
on the rank's routed Q shard, one combine over ``model``), every layer
tensor-parallel over ``model`` (K9 on the rank's heads; an MoE layer
expert-parallel, each rank running its block of the experts), and the head
vocab-parallel: ``lm_logits`` gives this rank's vocabulary slice, which
``train_step.next_token_loss`` reduces over ``model``.  Served on a mesh
(``launch.serve --mesh-shape``), ``forward_prefill`` and ``forward_decode``
run the same layers on the rank's batch block against its block of the
cache (``sharding.cache_block``: its batch block and the kv heads its q
heads read, every position), and ``whole_logits`` gathers the ranks'
vocabulary slices so that every rank holds the whole logits, as ``repro``
returns them replicated.

Trained on a mesh whose ``data`` axis has more than one rank, the params
are stored FSDP (``sharding.lm_param_rules``: each leaf's ``embed`` dim
split over ``data``): each layer's leaves are gathered whole inside its
recompute body (``remat_layers(gather=)``, ``sharding.fsdp_layers``), so no
whole weight outlives its layer and the backward's recompute gathers again,
as XLA does inside ``repro``'s checkpointed scan; the vocabulary's tables,
the head and the final norm are gathered at their use
(``sharding.fsdp_take``), in the param dtype.  Their gradients come back
reduce-scattered over ``data`` (``collectives.fsdp_gather``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.core import hashing, qr_embedding
from repro_torch.core import sharded_embedding as SE
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.tree import leaves, tree_map, unflatten

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, *, generator: torch.Generator, device):
    kw = dict(generator=generator, device=device)
    params, axes = {}, {}
    params["attn"], axes["attn"] = L.init_attention(cfg, **kw)
    if cfg.num_experts > 0:
        params["moe"], axes["moe"] = moe_mod.init_moe(cfg, **kw)
    else:
        params["mlp"], axes["mlp"] = L.init_mlp(cfg, **kw)
    params["ln1"], axes["ln1"] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=device)
    params["ln2"], axes["ln2"] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype, device=device)
    return params, axes


def _stack_layers(cfg: ModelConfig, init_fn, *, generator: torch.Generator, device,
                  count: int | None = None):
    """``count`` (``cfg.num_layers``) layers of ``init_fn`` stacked along a
    leading L axis: the stacked leaves are allocated once and each layer's
    draws are copied into row i and freed (no stack of L separate trees: at
    most one layer's draws beside the stack)."""
    count = cfg.num_layers if count is None else count
    layer, axes = init_fn(cfg, generator=generator, device=device)
    stacked = tree_map(
        lambda a: torch.empty((count, *a.shape), dtype=a.dtype, device=a.device), layer)
    for i in range(count):
        if i:
            layer = init_fn(cfg, generator=generator, device=device)[0]
        tree_map(lambda dst, src: dst[i].copy_(src), stacked, layer)
        del layer
    return stacked, _prefix_axes(axes)


def _prefix_axes(axes: dict) -> dict:
    """Each leaf's axis tuple with ``"layers"`` in front."""
    return {k: _prefix_axes(a) if isinstance(a, dict) else ("layers",) + a
            for k, a in axes.items()}


def init_lm(cfg: ModelConfig, *, seed: int = 0, device=None):
    """Random params and their logical axes, ``(params, axes)``: ``embed``
    (the vocabulary's table(s)), ``layers`` (stacked), ``final_norm`` and,
    untied, ``head``; drawn from a ``torch.Generator`` seeded with ``seed``
    on the target device (the card unless ``device="cpu"``)."""
    dev = device_mod.resolve(device)
    g = device_mod.generator(dev)
    g.manual_seed(seed)
    params, axes = {}, {}
    params["embed"] = qr_embedding.init(cfg.emb_config, generator=g, device=dev)
    axes["embed"] = qr_embedding.param_axes(cfg.emb_config)
    params["layers"], axes["layers"] = _stack_layers(cfg, init_layer, generator=g, device=dev)
    params["final_norm"], axes["final_norm"] = L.init_norm(cfg.norm, cfg.d_model, cfg.pdtype,
                                                           device=dev)
    if not cfg.tie_embedding:
        params["head"], axes["head"] = L.init_dense(
            cfg.d_model, cfg.vocab, ("embed", "vocab"), dtype=cfg.pdtype, generator=g,
            device=dev)
    return params, axes


_SERVING_CAST = ("w", "b", *moe_mod.STACKS)


def cast_for_serving(params: dict, cfg: ModelConfig, keys) -> dict:
    """``params`` with the vocabulary's tables and every leaf stored under
    one of ``keys`` (in dicts, or lists of dicts) cast once to the compute
    dtype; the other leaves as they are."""
    cd = cfg.cdtype

    def cast(node, key=None):
        if isinstance(node, dict):
            return {k: cast(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [cast(v) for v in node]
        return node.to(cd) if key in keys else node

    out = cast(params)
    out["embed"] = {k: v.to(cd) for k, v in params["embed"].items()}
    return out


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """``params`` with the vocabulary's tables, every projection's ``w`` and
    ``b`` (the head's too) and the MoE's expert stacks cast once to the
    compute dtype (``cast_for_serving``).  The lookup, ``dense``, the heads
    and ``apply_moe`` cast those to it on every call, so serving from this
    tree gives the same logits bit for bit and reads half the weight bytes
    a decode step.  The norms keep their dtype (``apply_norm`` widens them
    to fp32), and so does the MoE's router (it runs in fp32)."""
    return cast_for_serving(params, cfg, _SERVING_CAST)


# ---------------------------------------------------------------------------
# embedding in/out (the paper's technique lives here)
# ---------------------------------------------------------------------------

def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                 mesh=None) -> torch.Tensor:
    """(B, S) tokens -> (B, S, d_model) in the compute dtype.  A QR
    vocabulary with ``add`` reconstruction goes through ``ops.qr_lookup`` on
    the compute-dtype casts of Q and R (K8 on the card): the value
    ``qr_embedding.lookup`` gives, one rounding of an exact sum.

    On a ``mesh`` with a ``model`` axis both ``embedding_exec`` values take
    the two-level GnR, ``sharded_embedding.token_embed_inline``, on this
    rank's row shard (``repro``'s ``gspmd`` lets XLA place the gather; the
    values are the same); off a mesh ``twolevel`` is this single card's
    lookup, as ``repro``'s ``token_embed_inline`` falls back to it."""
    mesh = SH.model_mesh(mesh)
    emb = cfg.emb_config
    table = SH.fsdp_take(params, "embed")          # whole over ``data`` (FSDP)
    if mesh is not None:
        return SE.token_embed_inline(table, tokens, emb, mesh=mesh)
    if emb.kind == "qr" and emb.reconstruction == "add":
        q_idx, r_idx = hashing.qr_decompose(tokens, emb.collision)
        return ops.qr_lookup(table["q"].to(emb.compute_dtype),
                             table["r"].to(emb.compute_dtype), q_idx, r_idx)
    return qr_embedding.lookup(table, tokens, emb)


def vocab_range(cfg: ModelConfig, mesh, shard: int | None = None) -> tuple[int, int]:
    """The vocabulary ``[lo, hi)`` whose logits this rank's (or the rank at
    ``model`` coordinate ``shard``'s) ``lm_logits`` gives on ``mesh``
    (``sharding.model_mesh``): a tied head's row shard
    (``qr_embedding.vocab_shard_range``), an untied head's block of
    columns, or of ``ceil(vocab / model)`` where the axis does not divide
    ``vocab`` (the head is then whole on every rank)."""
    m = mesh.shape["model"]
    s = mesh.axis_index("model") if shard is None else shard
    if cfg.tie_embedding:
        return qr_embedding.vocab_shard_range(cfg.emb_config, m, s)
    per = -(-cfg.vocab // m)
    return min(cfg.vocab, s * per), min(cfg.vocab, (s + 1) * per)


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig, *, mesh=None) -> torch.Tensor:
    """The logits (..., vocab); on a ``mesh`` with a ``model`` axis this
    rank's slice ``vocab_range`` of them (vocab-parallel, ``x`` and what
    every slice reads entering through ``collectives.enter``)."""
    mesh = SH.model_mesh(mesh)
    if cfg.tie_embedding:
        table = SH.fsdp_take(params, "embed")      # whole over ``data`` (FSDP)
        if mesh is None:
            return qr_embedding.logits_head(table, x, cfg.emb_config)
        return qr_embedding.logits_head_shard(table, x, cfg.emb_config, mesh=mesh)
    head = SH.fsdp_take(params, "head")
    if mesh is None:
        return L.dense(head, x, cfg.cdtype)
    lo, hi = vocab_range(cfg, mesh)
    if head["w"].shape[-1] != hi - lo:            # whole on every rank: slice it
        x, w = collectives.enter([x, head["w"]], mesh, "model")
        return L.dense({"w": w[:, lo:hi]}, x, cfg.cdtype)
    [x] = collectives.enter([x], mesh, "model")
    return L.dense(head, x, cfg.cdtype)


def layer_list(params: dict, stack: str = "layers") -> list[dict]:
    """The L layers' params of the stack ``params[stack]`` (``"layers"``;
    whisper's ``"enc"`` and ``"dec"``), layer i's leaves the ``[i]`` rows of
    the stacked leaves, taken with one ``torch.unbind`` a leaf."""
    stacked = params[stack]
    rows = [torch.unbind(a) for a in leaves(stacked)]
    return [unflatten(stacked, [r[i] for r in rows]) for i in range(len(rows[0]))]


# ---------------------------------------------------------------------------
# per-layer recompute (repro's remat)
# ---------------------------------------------------------------------------

_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.matmul.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.checkpoint_dots``: keep the products."""
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: ModelConfig) -> dict:
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _save_dots)}
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} (full | dots)")
    return {}


# ---------------------------------------------------------------------------
# layer body (shared by train/prefill/decode)
# ---------------------------------------------------------------------------

def layer_fwd(p: dict, x: torch.Tensor, cfg: ModelConfig, *, cache=None, pos=None,
              positions=None, mesh=None):
    """One layer; on a ``mesh`` (``sharding.model_mesh``) its attention and
    MLP run tensor-parallel on this rank's blocks of ``p``, its MoE
    expert-parallel."""
    h = L.apply_norm(p["ln1"], x)
    attn_out, new_cache = L.attention(p["attn"], h, cfg, causal=True, cache=cache, pos=pos,
                                      positions=positions, mesh=mesh)
    x = x + attn_out
    h = L.apply_norm(p["ln2"], x)
    if cfg.num_experts > 0:
        x = x + moe_mod.apply_moe(p["moe"], h, cfg, mesh=mesh)
    else:
        x = x + L.mlp(p["mlp"], h, cfg, mesh=mesh)
    return x, new_cache


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def forward_train(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
                  positions=None) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, vocab); each layer recomputed in the
    backward with ``cfg.remat`` (the module's docstring).  Under the active
    mesh (``sharding.model_mesh``), ``params`` are this rank's blocks,
    ``tokens`` its batch block, and the logits its vocabulary slice
    (``vocab_range``); the mesh is taken once here, so the layers' recompute
    in the backward, outside ``use_rules``, runs on it too and issues the
    same collectives."""
    mesh = SH.model_mesh()
    x = embed_tokens(params, tokens, cfg, mesh=mesh).to(cfg.cdtype)
    x = run_layers(params, x, cfg, positions=positions, mesh=mesh)
    return lm_logits(params, x, cfg, mesh=mesh)


def remat_layers(layers: list, x: torch.Tensor, cfg: ModelConfig, body, *extra,
                 gather=None) -> torch.Tensor:
    """``x`` through ``body(p, x, *extra)`` for each layer's params ``p`` in
    turn, each call recomputed in the backward with ``cfg.remat`` while
    gradients are enabled (the module's docstring).  ``gather`` (FSDP,
    ``sharding.fsdp_layers``) makes a layer's params whole inside the call,
    so the recompute gathers them again."""
    remat = cfg.remat and torch.is_grad_enabled()
    kw = _remat_kwargs(cfg) if remat else {}
    if gather is not None:
        inner = body

        def body(p, *a):
            return inner(gather(p), *a)

    for p in layers:
        x = (ckpt.checkpoint(body, p, x, *extra, use_reentrant=False, **kw) if remat
             else body(p, x, *extra))
    return x


def run_layers(params: dict, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
               mesh=None) -> torch.Tensor:
    """Input rows (B, S, d) through every layer (``remat_layers``) and the
    final norm: the body of ``forward_train``, and of pixtral's, whose rows
    start with its patches."""

    def body(p, y):
        return layer_fwd(p, y, cfg, positions=positions, mesh=mesh)[0]

    x = remat_layers(layer_list(params), x, cfg, body, gather=SH.fsdp_layers("layers"))
    return L.apply_norm(SH.fsdp_take(params, "final_norm"), x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device=None, mesh=None) -> dict:
    """Stacked KV cache, ``{"k", "v"}`` each (L, B, max_len, KH, D), zeros;
    on a ``mesh`` (default the active one) this rank's block of the cache of
    ``batch`` (global) sequences, ``sharding.cache_block``."""
    dtype = dtype or cfg.cdtype
    dev = device_mod.resolve(device)
    shape = SH.cache_block(cfg, SH.current_mesh() if mesh is None else mesh, batch, max_len)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_axes() -> dict:
    return {
        "k": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
        "v": ("layers", "batch", "kvseq", "kv_heads", "head_dim"),
    }


def whole_logits(params: dict, x: torch.Tensor, cfg: ModelConfig, *, mesh=None) -> torch.Tensor:
    """``lm_logits`` whole on every rank: on a ``mesh`` with a ``model``
    axis the ranks' vocabulary slices (``vocab_range``, uneven) gathered
    over it (``collectives.gather_slices``, site ``logits``), as ``repro``'s
    serving steps return their logits replicated."""
    mesh = SH.model_mesh(mesh)
    logits = lm_logits(params, x, cfg, mesh=mesh)
    if mesh is None:
        return logits
    widths = [hi - lo for lo, hi in (vocab_range(cfg, mesh, i)
                                      for i in range(mesh.shape["model"]))]
    return collectives.gather_slices(logits, mesh, "model", widths, site="logits")


def forward_prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    max_len: int, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """Prefill: (last-token logits (B, 1, vocab), the cache of length
    ``max_len`` with positions [0, S) filled).  On a ``mesh`` (default the
    active one, ``sharding.model_mesh``) ``params`` are this rank's blocks
    and ``tokens`` its batch block: the tokens through the two-level GnR,
    every layer tensor-parallel, the cache this rank's block
    (``init_cache``), the logits whole (``whole_logits``)."""
    mesh = SH.model_mesh(mesh)
    x = embed_tokens(params, tokens, cfg, mesh=mesh).to(cfg.cdtype)
    return prefill_rows(params, x, cfg, max_len, mesh=mesh)


def prefill_rows(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 max_len: int, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """``forward_prefill`` from given input rows ``x`` (B, S, d) in the
    compute dtype (the embedded tokens; pixtral's patches followed by
    them): the last row's logits and a cache of ``max_len`` >= S positions,
    [0, S) filled."""
    mesh = SH.model_mesh(mesh)
    b, s, _ = x.shape
    shape = (cfg.num_layers, b, max_len, SH.cache_heads(cfg, mesh), cfg.head_dim_)
    cache = {k: torch.zeros(shape, dtype=cfg.cdtype, device=x.device) for k in ("k", "v")}
    for i, p in enumerate(layer_list(params)):
        x, (k, v) = layer_fwd(p, x, cfg, mesh=mesh)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = L.apply_norm(params["final_norm"], x)
    return whole_logits(params, x[:, -1:, :], cfg, mesh=mesh), cache


def forward_decode(params: dict, token: torch.Tensor, cache: dict, pos: int,
                   cfg: ModelConfig, *, mesh=None) -> tuple[torch.Tensor, dict]:
    """One decode step. token: (B, 1); cache: stacked (L, ...), updated in
    place at ``pos`` and returned; pos: the token's position.  On a
    ``mesh`` (default the active one) this rank's blocks, batch block and
    cache block, as ``forward_prefill``; the logits whole."""
    mesh = SH.model_mesh(mesh)
    pos = int(pos)
    x = embed_tokens(params, token, cfg, mesh=mesh).to(cfg.cdtype)
    for i, p in enumerate(layer_list(params)):
        x, _ = layer_fwd(p, x, cfg, cache=(cache["k"][i], cache["v"][i]), pos=pos, mesh=mesh)
    x = L.apply_norm(params["final_norm"], x)
    return whole_logits(params, x, cfg, mesh=mesh), cache
