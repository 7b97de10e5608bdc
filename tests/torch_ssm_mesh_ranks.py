"""Rank bodies and ``repro``'s child of the sub-quadratic models' mesh tests
(``tests/test_torch_ssm_mesh.py``).  No jax and no tests: every rank of
``repro_torch.launch.mesh.spawn`` imports this module, not the test file
that spawns it.

Each body runs on one rank of a gloo mesh on the CPU: it places the params
by ``registry.lm_specs`` (zamba2's mamba layers by SSM head, B and C whole;
xlstm's mLSTM blocks by head, its sLSTM blocks' FFN by hidden unit; served
with ``embed`` whole, trained FSDP over ``data``), takes
its ``data`` block of the prompts and runs the port's meshed prefill and
greedy decode, and the step-1 gradients of its training loss, gathered to
the logical arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.models import mamba2 as MB
from repro_torch.models import xlstm as XL
from repro_torch.train import train_step as ts
from repro_torch.train.serve_step import greedy_generate, serve_family

BATCH, SEQ, STEPS = 4, 16, 4
# the smoke configs' vocabulary cut to 498 tokens, as the other meshed tests
# cut it: neither the padded dense table nor the last Q row is full
VOCAB = 498
# name -> (arch, overrides), QR at collision 4, fp32 compute.  zamba2-7b-smoke
# has one SSM group, so "zamba2-g2" crosses a group boundary; xlstm runs at
# d_model 96, whose sLSTM FFN of int(4/3 * 96) = 128 units splits over 2 and
# 4 ranks (the smoke's 64 gives 85, which runs replicated)
CASES = {
    "zamba2": ("zamba2-7b", dict(embedding_kind="qr", qr_collision=4)),
    "zamba2-g2": ("zamba2-7b", dict(embedding_kind="qr", qr_collision=4, ssm_groups=2)),
    "xlstm": ("xlstm-125m", dict(embedding_kind="qr", qr_collision=4, d_model=96)),
}


def config(name: str, compute: str = "float32"):
    arch, over = CASES[name]
    return registry.get(arch).smoke.replace(vocab=VOCAB, compute_dtype=compute, **over)


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def place(params, axes, cfg, mesh, serve: bool = False):
    specs = registry.lm_specs(cfg, params, axes, mesh, serve=serve)
    return SH.shard_tree(params, specs, mesh), specs


def serve_greedy(fam, params, tokens, cfg, steps: int, mesh=None) -> dict:
    """``greedy_generate``'s loop on this rank, every step's logits kept:
    the prefill's and ``steps`` decode steps' whole logits, the greedy
    tokens, ``greedy_generate``'s own tokens and the cache's leaves."""
    max_len = tokens.shape[1] + steps
    with torch.inference_mode():
        logits, cache = fam.prefill(params, {"tokens": tokens}, cfg, max_len, mesh=mesh)
        out = [logits.clone()]
        toks = []
        for i in range(steps):
            tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
            toks.append(tok[:, 0])
            logits, cache = fam.decode(params, cache, tok, tokens.shape[1] + i, cfg, mesh=mesh)
            out.append(logits.clone())
        gen = greedy_generate(fam, params, {"tokens": tokens}, cfg, max_new=steps,
                              max_len=max_len, mesh=mesh)
    return {"logits": [_np(x) for x in out], "tokens": torch.stack(toks, 1).numpy(),
            "generated": gen.numpy(), "cache": [_np(x) for x in tree.leaves(cache)]}


def cache_specs(cfg, mesh, cache) -> list:
    """The spec of each leaf of this rank's cache or states (flatten order),
    as the port lays them out: zamba2's SSM states by head, its conv states'
    columns as ``conv_w``'s, its k / v by the kv heads the rank reads
    (split only where ``sharding.head_split`` splits the kv projections);
    xlstm's mLSTM states by head, its sLSTM states whole; the batch dim by
    the rank's ``data`` block of the sequences."""
    rows = "data" if SH.data_ranks(mesh) > 1 else None
    if isinstance(cache, dict):
        ssm = MB.layout(cfg, mesh)
        split = SH.head_split(cfg, mesh)
        kv = SH.P(None, rows, None, "model" if split is not None and split.kv_local else None)
        heads = SH.P(None, rows, "model" if MB.ssm_split(cfg, mesh) else None)
        return [SH.P(None, rows, None, *ssm["conv_w"][1:]), kv, heads, kv]
    head = SH.P(rows, "model" if XL.mlstm_split(cfg, mesh) else None)
    return [SH.P(rows) if len(st) == 4 else head for st in cache for _ in st]


def write_inputs(path: str) -> None:
    """Every case's params (the port's draw, seed 0, fp32) and prompts (a
    numpy draw) to an .npz, which ``repro``'s child and the ranks read."""
    out = {}
    for name in CASES:
        cfg = config(name)
        params, _ = registry.init_fn(registry.get(CASES[name][0]))(cfg, seed=0, device="cpu")
        for i, leaf in enumerate(tree.leaves(params)):
            out[f"{name}/param/{i}"] = leaf.numpy()
        out[f"{name}/tokens"] = np.random.default_rng(1).integers(
            0, cfg.vocab, (BATCH, SEQ)).astype(np.int32)
    np.savez(path, **out)


def _from_npz(arrs, name: str, cfg) -> tuple:
    binding = registry.get(CASES[name][0])
    like, axes = registry.init_fn(binding)(cfg, seed=0, device="meta")
    n = len(tree.leaves(like))
    params = tree.unflatten(like, [torch.from_numpy(np.array(arrs[f"{name}/param/{i}"]))
                                   for i in range(n)])
    return binding, params, axes, torch.from_numpy(np.array(arrs[f"{name}/tokens"]))


def step1_grads(binding, cfg, local, specs, toks, mesh) -> list:
    """The step-1 gradients of the training loss on this rank's blocks and
    ``data`` block, averaged over ``data`` and gathered whole."""
    block = synthetic.data_block({"tokens": toks}, mesh)
    loss, _m, grads = ts.meshed_grads(registry.train_loss_fn(binding, cfg), local, block, mesh,
                                      specs)
    return float(loss), [_np(SH.gather(g, s, mesh)) for g, s in zip(tree.leaves(grads), specs)]


def repro_cases(mesh, path: str, with_sites: bool = False) -> dict:
    """Every case of ``CASES`` on this rank from the params and prompts of
    ``write_inputs``'s ``.npz``: ``serve_greedy`` on the mesh, the
    cache's specs, the step-1 loss and gradients, and whether the params
    gathered back from the rank's blocks are the logical ones (bitwise);
    ``with_sites`` adds ``all_sites`` at ``BATCH`` x ``SEQ``."""
    arrs = np.load(path)
    out = {"coords": dict(mesh.coords)}
    if with_sites:
        out["sites"] = all_sites(mesh, BATCH, SEQ)
    for name in CASES:
        cfg = config(name)
        binding, params, axes, toks = _from_npz(arrs, name, cfg)
        fam = serve_family(binding.kind)
        served = fam.prepare(params, cfg)
        local, specs = place(served, axes, cfg, mesh, serve=True)
        block = synthetic.data_block({"tokens": toks}, mesh)["tokens"]
        got = serve_greedy(fam, local, block, cfg, STEPS, mesh=mesh)
        with torch.inference_mode():
            cache = fam.make_cache(cfg, BATCH, SEQ + STEPS, device="cpu", mesh=mesh)
        got["cache_specs"] = [tuple(s) for s in cache_specs(cfg, mesh, cache)]
        local, specs = place(params, axes, cfg, mesh)
        got["gathered"] = all(torch.equal(SH.gather(x, s, mesh), w) for x, s, w in
                              zip(tree.leaves(local), specs, tree.leaves(params)))
        got["loss"], got["grads"] = step1_grads(binding, cfg, local, specs, toks, mesh)
        out[name] = got
    return out


def world1(mesh) -> dict:
    """Mesh (1, 1): the meshed prefill, cache and decode logits and tokens,
    and the step-1 gradients, against the single card's (no mesh) on the
    same rank, for zamba2-7b-smoke and xlstm-125m-smoke (QR, the two-level
    GnR) in fp32 compute (bf16 products run ~20x slower on a CPU;
    ``chip_smoke.py`` holds world 1 in bf16 on the card); each read for
    bitwise equality."""
    out = {}
    for arch in ("zamba2-7b", "xlstm-125m"):
        binding = registry.get(arch)
        cfg = binding.smoke.replace(vocab=VOCAB, embedding_kind="qr", qr_collision=4,
                                    compute_dtype="float32")
        fam = serve_family(binding.kind)
        params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
        served = fam.prepare(params, cfg)
        toks = synthetic.lm_batch(cfg, BATCH, SEQ, seed=3)["tokens"]
        one = serve_greedy(fam, served, toks, cfg, STEPS)
        meshed = serve_greedy(fam, place(served, axes, cfg, mesh, serve=True)[0], toks, cfg,
                              STEPS, mesh=mesh)
        fn = registry.train_loss_fn(binding, cfg)
        _, _, g_one = ts.value_and_grad(fn, params, {"tokens": toks})
        local, specs = place(params, axes, cfg, mesh)
        _, g_mesh = step1_grads(binding, cfg, local, specs, toks, mesh)
        out[arch] = {
            "logits": all(np.array_equal(a, b) for a, b in zip(one["logits"], meshed["logits"])),
            "cache": all(np.array_equal(a, b) for a, b in zip(one["cache"], meshed["cache"])),
            "tokens": np.array_equal(one["generated"], meshed["generated"]),
            "grads": all(np.array_equal(_np(a), b) for a, b in zip(tree.leaves(g_one), g_mesh))}
    return out


def whole_batch(mesh) -> dict:
    """A mesh whose data ranks do not divide the batch (one sequence on
    (2, 1)): each rank keeps the whole sequence (``sharding.batch_split``),
    and its cache, greedy tokens and step-1 gradients (the data mean of two
    equal ones) are the single card's bitwise, its logits within rtol 1e-5
    / atol 1e-5 (the meshed head's prefill row reads up to 9.5e-07 from
    the single card's, its decode rows equal), for zamba2-7b-smoke and
    xlstm-125m-smoke in fp32 compute; beside the rows the rank kept."""
    out = {}
    for arch in ("zamba2-7b", "xlstm-125m"):
        binding = registry.get(arch)
        cfg = binding.smoke.replace(vocab=VOCAB, embedding_kind="qr", qr_collision=4,
                                    compute_dtype="float32")
        fam = serve_family(binding.kind)
        params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
        served = fam.prepare(params, cfg)
        toks = synthetic.lm_batch(cfg, 1, SEQ, seed=5)["tokens"]
        block = synthetic.data_block({"tokens": toks}, mesh)["tokens"]
        one = serve_greedy(fam, served, toks, cfg, STEPS)
        meshed = serve_greedy(fam, place(served, axes, cfg, mesh, serve=True)[0], block, cfg,
                              STEPS, mesh=mesh)
        _, _, g_one = ts.value_and_grad(registry.train_loss_fn(binding, cfg), params,
                                        {"tokens": toks})
        local, specs = place(params, axes, cfg, mesh)
        _, g_mesh = step1_grads(binding, cfg, local, specs, toks, mesh)
        out[arch] = {
            "rows": int(block.shape[0]),
            "logits": all(np.allclose(a, b, rtol=1e-5, atol=1e-5)
                          for a, b in zip(one["logits"], meshed["logits"])),
            "cache": all(np.array_equal(a, b) for a, b in zip(one["cache"], meshed["cache"])),
            "tokens": np.array_equal(one["generated"], meshed["generated"]),
            "grads": all(np.array_equal(_np(a), b) for a, b in zip(tree.leaves(g_one), g_mesh))}
    return out


def sites_config(arch: str):
    """``arch``'s smoke config in fp32 compute (bf16 products run ~20x
    slower on a CPU), the collectives test's config on both sides."""
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
    toks = synthetic.data_block(synthetic.lm_batch(cfg, batch, seq), mesh)["tokens"]

    def read():
        return {f"{s}/{a}": list(v) for (s, a), v in collectives.SITES.items()}

    res = {}
    with torch.inference_mode():
        collectives.reset_counts()
        fam.prefill(local, {"tokens": toks}, cfg, seq, mesh=mesh)
        res["prefill"] = read()
        cache = fam.make_cache(cfg, batch, seq, device="cpu", mesh=mesh)
        collectives.reset_counts()
        fam.decode(local, cache, toks[:, :1], seq - 1, cfg, mesh=mesh)
        res["decode"] = read()
    local, specs, _ = train_place(params, registry.lm_axes(cfg, axes, mesh), mesh,
                                  SH.lm_param_rules(cfg, mesh))
    step = make_train_step(registry.train_loss_fn(binding, cfg), opt.OptConfig(), mesh=mesh,
                           specs=specs)
    collectives.reset_counts()
    step(local, opt.init(local), {"tokens": toks})
    res["train"] = read()
    return res


def all_sites(mesh, batch: int, seq: int) -> dict:
    """``sites`` of zamba2-7b and xlstm-125m."""
    return {arch: sites(mesh, arch, batch, seq) for arch in ("zamba2-7b", "xlstm-125m")}


# ---------------------------------------------------------------------------
# repro's side, in a child with four host devices (the tests' mesh_runner)
# ---------------------------------------------------------------------------

# repro's meshed serving as its dry run lowers it (launch/dryrun.py::
# lower_cell: params by PARAM_RULES, the prompts and token by ("batch", None),
# the cache by the family's cache_axes under DEFAULT_RULES or replicated
# where it has none, the logits replicated; prefill and decode jitted under
# use_rules), greedy, fp32 compute; and the step-1 gradients of its jitted
# meshed loss (launch/train.py::build's loss under use_rules), on one mesh,
# from write_inputs's params and prompts; the results to an .npz
REPRO_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.train.serve_step import serve_family

INPUTS, PATH, CASES, shape = __INPUTS__, __PATH__, __CASES__, __SHAPE__
B, S, STEPS = __BATCH__, __SEQ__, __STEPS__
arrs = np.load(INPUTS)
out = {}
for name, (arch, over) in CASES.items():
    binding = registry.get(arch)
    cfg = binding.smoke.replace(vocab=__VOCAB__, compute_dtype="float32", **over)
    fam = serve_family(binding.kind)
    like, axes = registry.init_fn(binding)(jax.random.PRNGKey(0), cfg)
    leaves = [jnp.asarray(arrs[f"{name}/param/{i}"]) for i in range(len(jax.tree.leaves(like)))]
    params = jax.tree.unflatten(jax.tree.structure(like), leaves)
    toks = arrs[f"{name}/tokens"]
    loss0 = registry.train_loss_fn(binding, cfg)
    tag = f"{name}/{shape[0]}x{shape[1]}"
    mesh = make_mesh(shape, ("data", "model"))
    rules = SH.DEFAULT_RULES
    pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)
    row = lambda shp: NamedSharding(mesh, SH.resolve_spec(mesh, shp, ("batch", None), rules))
    cache_sds = jax.eval_shape(lambda: fam.make_cache(cfg, B, S + STEPS))
    ca = fam.cache_axes()
    cshard = (SH.shardings_for_tree(mesh, cache_sds, ca, rules) if ca is not None
              else jax.tree.map(lambda _: NamedSharding(mesh, P()), cache_sds))

    def prefill(p, batch):
        with SH.use_rules(mesh, rules):
            return fam.prefill(p, batch, cfg, S + STEPS)

    def decode(p, c, tok, pos):
        with SH.use_rules(mesh, rules):
            return fam.decode(p, c, tok, pos, cfg)

    def loss(p, b):
        with SH.use_rules(mesh, rules):
            return loss0(p, b)[0]

    prefill = jax.jit(prefill, in_shardings=(pshard, {"tokens": row((B, S))}),
                      out_shardings=(None, cshard))
    decode = jax.jit(decode, in_shardings=(pshard, cshard, row((B, 1)),
                                           NamedSharding(mesh, P())),
                     out_shardings=(None, cshard))
    p = jax.device_put(params, pshard)
    logits, cache = prefill(p, {"tokens": jnp.asarray(toks)})
    gen = []
    for i in range(STEPS):
        out[f"{tag}/logits{i}"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        gen.append(np.asarray(tok[:, 0]))
        logits, cache = decode(p, cache, tok, jnp.int32(S + i))
    out[f"{tag}/logits{STEPS}"] = np.asarray(logits)
    out[f"{tag}/tokens"] = np.stack(gen, 1)
    for i, leaf in enumerate(jax.tree.leaves(cache)):
        out[f"{tag}/cache/{i}"] = np.asarray(leaf)
    value, grads = jax.jit(jax.value_and_grad(loss))(p, {"tokens": jnp.asarray(toks)})
    out[f"{tag}/loss"] = np.asarray(value)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"{tag}/grad/{i}"] = np.asarray(leaf)
np.savez(PATH, **out)
"""


def repro_child_code(inputs: str, path: str, shape) -> str:
    """``REPRO_CHILD`` for every case on a ``shape`` host mesh (four host
    devices or fewer), from ``write_inputs``'s ``inputs``, its results to
    ``path``."""
    subs = {"__INPUTS__": repr(str(inputs)), "__PATH__": repr(str(path)),
            "__CASES__": repr(CASES), "__SHAPE__": repr(tuple(shape)),
            "__BATCH__": str(BATCH), "__SEQ__": str(SEQ), "__STEPS__": str(STEPS),
            "__VOCAB__": str(VOCAB)}
    code = REPRO_CHILD
    for k, v in subs.items():
        code = code.replace(k, v)
    return code
