"""Rank bodies and ``repro``'s child of the prefix models' mesh tests
(``tests/test_torch_prefix_mesh.py``).  No jax and no tests: every rank of
``repro_torch.launch.mesh.spawn`` imports this module, not the test file
that spawns it.

Each body runs on one rank of a gloo mesh on the CPU: it places the params
by ``registry.lm_specs`` (whisper's encoder and decoder layers and
pixtral's layers by head and ``d_ff`` column, the vocabulary by Q shard or
head column; served with ``embed`` whole, trained FSDP over ``data``),
takes its ``data`` block of the prompts and of the frames or patches, and
runs the port's meshed prefill and greedy decode, and the
step-1 gradients of its training loss, gathered to the logical arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.train import train_step as ts
from repro_torch.train.serve_step import greedy_generate, serve_family

BATCH, SEQ, STEPS = 2, 8, 4
# the smoke configs' vocabulary cut to 498 tokens, as the other meshed tests
# cut it: neither the padded dense table nor the last Q row is full, and an
# untied head's 498 columns do not split over 4 ranks
VOCAB = 498
# name -> (arch, overrides, mesh shapes), QR at collision 4, fp32 compute.
# whisper-large-v3-smoke's 4 heads split over 2 and 4 ranks; "whisper-h6"
# has 6, which 4 ranks do not divide, so on (1, 4) its attention (the
# cross-attention too) runs replicated while its MLPs split, as whisper's 20
# heads meet the 16 ranks of pod1; pixtral-12b-smoke's 2 kv heads split over
# 2 ranks and stay whole over 4 (each rank slicing the one its q head reads)
CASES = {
    "whisper": ("whisper-large-v3", dict(embedding_kind="qr", qr_collision=4),
                ((1, 2), (1, 4), (2, 2))),
    "whisper-h6": ("whisper-large-v3", dict(embedding_kind="qr", qr_collision=4,
                                            num_heads=6, kv_heads=6), ((1, 4),)),
    "pixtral": ("pixtral-12b", dict(embedding_kind="qr", qr_collision=4),
                ((1, 2), (1, 4), (2, 2))),
}
PREFIX = {"whisper-large-v3": "frames", "pixtral-12b": "patches"}


def config(name: str, compute: str = "float32"):
    arch, over, _ = CASES[name]
    return registry.get(arch).smoke.replace(vocab=VOCAB, compute_dtype=compute, **over)


def cases_on(shape) -> list[str]:
    return [name for name, (_, _, shapes) in CASES.items() if tuple(shape) in shapes]


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def place(params, axes, cfg, mesh, serve: bool = False):
    specs = registry.lm_specs(cfg, params, axes, mesh, serve=serve)
    return SH.shard_tree(params, specs, mesh), specs


def make_batch(arch: str, cfg, batch: int, seq: int, seed: int = 3) -> dict:
    """A global batch of ``batch`` prompts of ``seq`` tokens and their
    frames or patches (the family's synthetic batch)."""
    return registry.make_batch_fn(registry.get(arch), cfg)(batch, seq, seed=seed)


def serve_greedy(fam, params, batch: dict, cfg, steps: int, mesh=None) -> dict:
    """``greedy_generate``'s loop on this rank, every step's logits kept:
    the prefill's and ``steps`` decode steps' whole logits, the greedy
    tokens, ``greedy_generate``'s own tokens and the cache's leaves."""
    seq = batch["tokens"].shape[1]
    max_len = seq + steps
    pos0 = seq + (batch["patches"].shape[1] if "patches" in batch else 0)
    with torch.inference_mode():
        logits, cache = fam.prefill(params, batch, cfg, max_len, mesh=mesh)
        out = [logits.clone()]
        toks = []
        for i in range(steps):
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
            toks.append(tok[:, 0])
            logits, cache = fam.decode(params, cache, tok, pos0 + i, cfg, mesh=mesh)
            out.append(logits.clone())
        gen = greedy_generate(fam, params, batch, cfg, max_new=steps, max_len=max_len,
                              mesh=mesh)
    return {"logits": [_np(x) for x in out], "tokens": torch.stack(toks, 1).numpy(),
            "generated": gen.numpy(), "cache": [_np(x) for x in tree.leaves(cache)]}


def cache_heads(cfg, mesh) -> tuple[int, int]:
    """The kv heads ``[lo, hi)`` of this rank's cache block (every leaf's dim
    3: whisper's ``ck``, ``cv``, ``k``, ``v``, pixtral's ``k``, ``v``): those
    its q heads read (``sharding.head_split``), all of them where the
    attention runs replicated."""
    split = SH.head_split(cfg, mesh)
    return (0, cfg.kv_heads) if split is None else (split.kv0, split.kv0 + split.kv)


def write_inputs(path: str) -> None:
    """Every case's params (the port's draw, seed 0, fp32), prompts (a numpy
    draw) and frames or patches (a numpy draw) to an .npz, which
    ``repro``'s child and the ranks read."""
    out = {}
    rng = np.random.default_rng(1)
    for name in CASES:
        cfg = config(name)
        arch = CASES[name][0]
        params, _ = registry.init_fn(registry.get(arch))(cfg, seed=0, device="cpu")
        for i, leaf in enumerate(tree.leaves(params)):
            out[f"{name}/param/{i}"] = leaf.numpy()
        out[f"{name}/tokens"] = rng.integers(0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
        like = make_batch(arch, cfg, BATCH, SEQ)[PREFIX[arch]]
        out[f"{name}/prefix"] = rng.standard_normal(tuple(like.shape)).astype(np.float32)
    np.savez(path, **out)


def _from_npz(arrs, name: str, cfg) -> tuple:
    arch = CASES[name][0]
    binding = registry.get(arch)
    like, axes = registry.init_fn(binding)(cfg, seed=0, device="meta")
    n = len(tree.leaves(like))
    params = tree.unflatten(like, [torch.from_numpy(np.array(arrs[f"{name}/param/{i}"]))
                                   for i in range(n)])
    batch = {"tokens": torch.from_numpy(np.array(arrs[f"{name}/tokens"])),
             PREFIX[arch]: torch.from_numpy(np.array(arrs[f"{name}/prefix"]))}
    return binding, params, axes, batch


def step1_grads(binding, cfg, local, specs, batch, mesh) -> tuple:
    """The step-1 loss and gradients of the training loss on this rank's
    blocks and ``data`` block, averaged over ``data`` and gathered whole."""
    loss, _m, grads = ts.meshed_grads(registry.train_loss_fn(binding, cfg), local,
                                      synthetic.data_block(batch, mesh), mesh, specs)
    return float(loss), [_np(SH.gather(g, s, mesh)) for g, s in zip(tree.leaves(grads), specs)]


def repro_cases(mesh, path: str, with_sites: bool = False) -> dict:
    """Every case of ``CASES`` on this mesh shape, on this rank, from the
    params and inputs of ``write_inputs``'s ``.npz``: ``serve_greedy`` on the
    mesh, the cache's specs, the step-1 loss and gradients, and whether the
    params gathered back from the rank's blocks are the logical ones
    (bitwise); ``with_sites`` adds ``all_sites`` at ``BATCH`` x ``SEQ``."""
    arrs = np.load(path)
    out = {"coords": dict(mesh.coords)}
    if with_sites:
        out["sites"] = all_sites(mesh, BATCH, SEQ)
    for name in cases_on(tuple(mesh.shape.values())):
        cfg = config(name)
        binding, params, axes, batch = _from_npz(arrs, name, cfg)
        fam = serve_family(binding.kind)
        local, specs = place(fam.prepare(params, cfg), axes, cfg, mesh, serve=True)
        got = serve_greedy(fam, local, synthetic.data_block(batch, mesh), cfg, STEPS, mesh=mesh)
        got["cache_heads"] = cache_heads(cfg, mesh)
        local, specs = place(params, axes, cfg, mesh)
        got["gathered"] = all(torch.equal(SH.gather(x, s, mesh), w) for x, s, w in
                              zip(tree.leaves(local), specs, tree.leaves(params)))
        got["loss"], got["grads"] = step1_grads(binding, cfg, local, specs, batch, mesh)
        out[name] = got
    return out


def world1(mesh) -> dict:
    """Mesh (1, 1): the meshed prefill, cache and decode logits and tokens,
    and the step-1 gradients, against the single card's (no mesh) on the
    same rank, for whisper-large-v3-smoke and pixtral-12b-smoke (QR, the
    two-level GnR) in fp32 compute (``chip_smoke.py`` holds world 1 in bf16
    on the card); each read for bitwise equality."""
    out = {}
    for arch in PREFIX:
        binding = registry.get(arch)
        cfg = binding.smoke.replace(vocab=VOCAB, embedding_kind="qr", qr_collision=4,
                                    compute_dtype="float32")
        fam = serve_family(binding.kind)
        params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
        served = fam.prepare(params, cfg)
        batch = make_batch(arch, cfg, BATCH, SEQ)
        one = serve_greedy(fam, served, batch, cfg, STEPS)
        meshed = serve_greedy(fam, place(served, axes, cfg, mesh, serve=True)[0], batch, cfg,
                              STEPS, mesh=mesh)
        _, _, g_one = ts.value_and_grad(registry.train_loss_fn(binding, cfg), params, batch)
        local, specs = place(params, axes, cfg, mesh)
        _, g_mesh = step1_grads(binding, cfg, local, specs, batch, mesh)
        out[arch] = {
            "logits": all(np.array_equal(a, b) for a, b in zip(one["logits"], meshed["logits"])),
            "cache": all(np.array_equal(a, b) for a, b in zip(one["cache"], meshed["cache"])),
            "tokens": np.array_equal(one["generated"], meshed["generated"]),
            "grads": all(np.array_equal(_np(a), b) for a, b in zip(tree.leaves(g_one), g_mesh))}
    return out


def sites_config(arch: str):
    """``arch``'s smoke config in fp32 compute, the collectives test's
    config on both sides (its dense vocabulary: a meta trace cannot run
    the QR recompute's sinks, whose kept accesses depend on the index
    values)."""
    return registry.get(arch).smoke.replace(compute_dtype="float32")


def sites(mesh, arch: str, batch: int, seq: int) -> dict:
    """One prefill of ``batch`` x ``seq`` prompts (a cache of ``seq``
    positions), one decode step against a cache ``seq`` deep at position
    ``seq - 1``, and one training step of ``sites_config(arch)`` on this
    rank, as ``launch.dryrun.trace_serve`` / ``trace_train`` run them: the
    collectives of each, ``{"site/axis": [calls, bytes]}``."""
    from repro_torch.launch.train import place as train_place
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    binding = registry.get(arch)
    cfg = sites_config(arch)
    fam = serve_family(binding.kind)
    params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
    served = fam.prepare(params, cfg)
    local = SH.shard_tree(served, registry.lm_specs(cfg, served, axes, mesh, serve=True), mesh)
    data = synthetic.data_block(make_batch(arch, cfg, batch, seq), mesh)

    def read():
        return {f"{s}/{a}": list(v) for (s, a), v in collectives.SITES.items()}

    res = {}
    with torch.inference_mode():
        collectives.reset_counts()
        fam.prefill(local, data, cfg, seq, mesh=mesh)
        res["prefill"] = read()
        cache = fam.make_cache(cfg, batch, seq, device="cpu", mesh=mesh)
        collectives.reset_counts()
        fam.decode(local, cache, data["tokens"][:, :1], seq - 1, cfg, mesh=mesh)
        res["decode"] = read()
    local, specs, _ = train_place(params, registry.lm_axes(cfg, axes, mesh), mesh,
                                  SH.lm_param_rules(cfg, mesh))
    step = make_train_step(registry.train_loss_fn(binding, cfg), opt.OptConfig(), mesh=mesh,
                           specs=specs)
    collectives.reset_counts()
    step(local, opt.init(local), data)
    res["train"] = read()
    return res


def all_sites(mesh, batch: int, seq: int) -> dict:
    """``sites`` of whisper-large-v3 and pixtral-12b."""
    return {arch: sites(mesh, arch, batch, seq) for arch in PREFIX}


# ---------------------------------------------------------------------------
# repro's side, in a child with four host devices (the tests' mesh_runner)
# ---------------------------------------------------------------------------

# repro's meshed serving as its dry run lowers it (launch/dryrun.py::
# lower_cell: params by PARAM_RULES, the prompts and their frames or patches
# by ("batch", ...), the cache by the family's cache_axes under
# DEFAULT_RULES, the logits replicated; prefill and decode jitted under
# use_rules), greedy, fp32 compute; and the step-1 gradients of its jitted
# meshed loss (launch/train.py::build's loss under use_rules), on one mesh,
# from write_inputs's params and inputs; the results to an .npz
REPRO_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.train.serve_step import serve_family

INPUTS, PATH, CASES, PREFIX, shape = __INPUTS__, __PATH__, __CASES__, __PREFIX__, __SHAPE__
B, S, STEPS = __BATCH__, __SEQ__, __STEPS__
arrs = np.load(INPUTS)
out = {}
for name, (arch, over, shapes) in CASES.items():
    if tuple(shape) not in shapes:
        continue
    binding = registry.get(arch)
    cfg = binding.smoke.replace(vocab=__VOCAB__, compute_dtype="float32", **over)
    fam = serve_family(binding.kind)
    like, axes = registry.init_fn(binding)(jax.random.PRNGKey(0), cfg)
    leaves = [jnp.asarray(arrs[f"{name}/param/{i}"]) for i in range(len(jax.tree.leaves(like)))]
    params = jax.tree.unflatten(jax.tree.structure(like), leaves)
    key = PREFIX[arch]
    batch = {"tokens": jnp.asarray(arrs[f"{name}/tokens"]),
             key: jnp.asarray(arrs[f"{name}/prefix"])}
    pos0 = S + (batch[key].shape[1] if key == "patches" else 0)
    loss0 = registry.train_loss_fn(binding, cfg)
    tag = f"{name}/{shape[0]}x{shape[1]}"
    mesh = make_mesh(shape, ("data", "model"))
    rules = SH.DEFAULT_RULES
    pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)
    row = lambda shp: NamedSharding(mesh, SH.resolve_spec(
        mesh, shp, ("batch",) + (None,) * (len(shp) - 1), rules))
    cache_sds = jax.eval_shape(lambda: fam.make_cache(cfg, B, S + STEPS))
    cshard = SH.shardings_for_tree(mesh, cache_sds, fam.cache_axes(), rules)

    def prefill(p, batch):
        with SH.use_rules(mesh, rules):
            return fam.prefill(p, batch, cfg, S + STEPS)

    def decode(p, c, tok, pos):
        with SH.use_rules(mesh, rules):
            return fam.decode(p, c, tok, pos, cfg)

    def loss(p, b):
        with SH.use_rules(mesh, rules):
            return loss0(p, b)[0]

    prefill = jax.jit(prefill, in_shardings=(pshard, {k: row(v.shape) for k, v in batch.items()}),
                      out_shardings=(None, cshard))
    decode = jax.jit(decode, in_shardings=(pshard, cshard, row((B, 1)),
                                           NamedSharding(mesh, P())),
                     out_shardings=(None, cshard))
    p = jax.device_put(params, pshard)
    logits, cache = prefill(p, batch)
    gen = []
    for i in range(STEPS):
        out[f"{tag}/logits{i}"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        gen.append(np.asarray(tok[:, 0]))
        logits, cache = decode(p, cache, tok, jnp.int32(pos0 + i))
    out[f"{tag}/logits{STEPS}"] = np.asarray(logits)
    out[f"{tag}/tokens"] = np.stack(gen, 1)
    for i, leaf in enumerate(jax.tree.leaves(cache)):
        out[f"{tag}/cache/{i}"] = np.asarray(leaf)
    value, grads = jax.jit(jax.value_and_grad(loss))(p, batch)
    out[f"{tag}/loss"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"{tag}/grad/{i}"] = np.asarray(leaf)
np.savez(PATH, **out)
"""


def repro_child_code(inputs: str, path: str, shape) -> str:
    """``REPRO_CHILD`` for the cases of ``shape`` on a host mesh (four host
    devices or fewer), from ``write_inputs``'s ``inputs``, its results to
    ``path``."""
    subs = {"__INPUTS__": repr(str(inputs)), "__PATH__": repr(str(path)),
            "__CASES__": repr(CASES), "__PREFIX__": repr(PREFIX),
            "__SHAPE__": repr(tuple(shape)), "__BATCH__": str(BATCH), "__SEQ__": str(SEQ),
            "__STEPS__": str(STEPS), "__VOCAB__": str(VOCAB)}
    code = REPRO_CHILD
    for k, v in subs.items():
        code = code.replace(k, v)
    return code
