"""Rank bodies and ``repro``'s child of the meshed-serving tests
(``tests/test_torch_lm_mesh_serve.py``).  No jax and no tests: every rank of
``repro_torch.launch.mesh.spawn`` imports this module, not the test file
that spawns it.

Each body runs on one rank of a gloo mesh on the CPU: it places the params
cast for serving by ``sharding.lm_param_rules``, takes its ``data`` block of
the prompts and runs the port's meshed prefill and greedy decode
(``serve_step.greedy_generate``'s loop), returning the whole logits of its
block, its greedy tokens and its block of the cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.train.serve_step import greedy_generate, serve_family

BATCH, SEQ, STEPS = 4, 16, 4
# the smoke configs' vocabulary cut to 498 tokens, as the meshed training
# tests cut it: neither the padded dense table nor the last Q row is full
VOCAB = 498
# name -> (arch, overrides), fp32 compute
CASES = {
    "dense": ("qwen2-1.5b", dict(embedding_kind="dense")),
    "qr-twolevel": ("qwen2-1.5b", dict(embedding_kind="qr", qr_collision=4,
                                       embedding_exec="twolevel")),
    "moe-qr": ("granite-moe-3b-a800m", dict(embedding_kind="qr", qr_collision=4)),
}


def config(name: str, compute: str = "float32"):
    arch, over = CASES[name]
    return registry.get(arch).smoke.replace(vocab=VOCAB, compute_dtype=compute, **over)


def _place(params, axes, cfg, mesh):
    return SH.shard_tree(params, SH.tree_specs(params, axes, mesh,
                                               SH.lm_param_rules(cfg, mesh, serve=True)),
                         mesh)


def serve_greedy(fam, params, tokens, cfg, steps: int, mesh=None) -> dict:
    """``greedy_generate``'s loop on this rank, every step's logits kept:
    the prefill's and ``steps`` decode steps' whole logits, the greedy
    tokens and the cache."""
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
    return {"logits": [x.float().numpy() for x in out], "tokens": torch.stack(toks, 1).numpy(),
            "generated": gen.numpy(), "cache": {k: v.float().numpy() for k, v in cache.items()}}


def write_inputs(path: str) -> None:
    """Every case's params (the port's draw, seed 0, fp32) and prompts (a
    numpy draw) to an .npz, which ``repro``'s children and the ranks read."""
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


def repro_cases(mesh, path: str) -> dict:
    """Every case of ``CASES`` on this rank from the params and prompts of
    ``write_inputs``'s ``.npz``: ``serve_greedy`` on the mesh, with the
    rank's coordinates and the kv heads of its cache block."""
    arrs = np.load(path)
    out = {"coords": dict(mesh.coords)}
    for name in CASES:
        cfg = config(name)
        binding, params, axes, toks = _from_npz(arrs, name, cfg)
        fam = serve_family(binding.kind)
        local = _place(fam.prepare(params, cfg), axes, cfg, mesh)
        block = synthetic.data_block({"tokens": toks}, mesh)["tokens"]
        out[name] = serve_greedy(fam, local, block, cfg, STEPS, mesh=mesh)
        split = SH.head_split(cfg, mesh)
        out[name]["kv0"] = 0 if split is None else split.kv0
    return out


def world1(mesh) -> dict:
    """Mesh (1, 1): the meshed prefill, cache and decode logits against the
    single card's (no mesh) on the same rank, for the bf16 smoke configs
    (dense, QR ``twolevel``, the MoE), each read for bitwise equality."""
    out = {}
    for name in CASES:
        cfg = config(name, compute="bfloat16")
        binding = registry.get(CASES[name][0])
        fam = serve_family(binding.kind)
        params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
        params = fam.prepare(params, cfg)
        toks = synthetic.lm_batch(cfg, BATCH, SEQ, seed=3)["tokens"]
        one = serve_greedy(fam, params, toks, cfg, STEPS)
        meshed = serve_greedy(fam, _place(params, axes, cfg, mesh), toks, cfg, STEPS, mesh=mesh)
        out[name] = {
            "logits": all(np.array_equal(a, b) for a, b in zip(one["logits"], meshed["logits"])),
            "cache": all(np.array_equal(one["cache"][k], meshed["cache"][k]) for k in "kv"),
            "tokens": np.array_equal(one["generated"], meshed["generated"])}
    return out


def serve_sites(mesh, arch: str, batch: int, seq: int) -> dict:
    """One prefill of ``batch`` x ``seq`` prompts (a cache of ``seq``
    positions) and one decode step against a cache ``seq`` deep at position
    ``seq - 1`` of ``arch``'s smoke config on this rank, as
    ``launch.dryrun.trace_serve`` runs them: the collectives of each,
    ``{"site/axis": [calls, bytes]}``."""
    binding = registry.get(arch)
    cfg = binding.smoke
    fam = serve_family(binding.kind)
    params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
    local = _place(fam.prepare(params, cfg), axes, cfg, mesh)
    toks = synthetic.data_block(synthetic.lm_batch(cfg, batch, seq), mesh)["tokens"]
    res = {}
    with torch.inference_mode():
        collectives.reset_counts()
        fam.prefill(local, {"tokens": toks}, cfg, seq, mesh=mesh)
        res["prefill"] = {f"{s}/{a}": list(v) for (s, a), v in collectives.SITES.items()}
        cache = fam.make_cache(cfg, batch, seq, device="cpu", mesh=mesh)
        collectives.reset_counts()
        fam.decode(local, cache, toks[:, :1], seq - 1, cfg, mesh=mesh)
        res["decode"] = {f"{s}/{a}": list(v) for (s, a), v in collectives.SITES.items()}
    return res


# ---------------------------------------------------------------------------
# repro's side, in a child with four host devices (the tests' mesh_runner)
# ---------------------------------------------------------------------------

# repro's meshed serving as its dry run lowers it (launch/dryrun.py::
# lower_cell: params by PARAM_RULES, the prompts and token by ("batch", None),
# the cache by the family's cache_axes under DEFAULT_RULES, the logits
# replicated; prefill and decode jitted under use_rules), greedy, fp32
# compute, on one mesh, from write_inputs's params and prompts; the results
# to an .npz
REPRO_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh
from repro.train.serve_step import serve_family

INPUTS, PATH, CASES, SHAPES = __INPUTS__, __PATH__, __CASES__, __SHAPES__
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
    for shape in SHAPES:
        tag = f"{name}/{shape[0]}x{shape[1]}"
        mesh = make_mesh(shape, ("data", "model"))
        rules = SH.DEFAULT_RULES
        pshard = SH.shardings_for_tree(mesh, params, axes, SH.PARAM_RULES)
        row = lambda shp: NamedSharding(mesh, SH.resolve_spec(mesh, shp, ("batch", None), rules))
        cache_sds = jax.eval_shape(lambda: fam.make_cache(cfg, B, S + STEPS))
        cshard = SH.shardings_for_tree(mesh, cache_sds, fam.cache_axes(), rules)

        def prefill(p, batch):
            with SH.use_rules(mesh, rules):
                return fam.prefill(p, batch, cfg, S + STEPS)

        def decode(p, c, tok, pos):
            with SH.use_rules(mesh, rules):
                return fam.decode(p, c, tok, pos, cfg)

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
        for k, v in cache.items():
            out[f"{tag}/cache/{k}"] = np.asarray(v)
np.savez(PATH, **out)
"""


def repro_child_code(inputs: str, path: str, shape) -> str:
    """``REPRO_CHILD`` for every case on a ``shape`` host mesh (four host
    devices or fewer), from ``write_inputs``'s ``inputs``, its results to
    ``path``."""
    subs = {"__INPUTS__": repr(str(inputs)), "__PATH__": repr(str(path)),
            "__CASES__": repr(CASES), "__SHAPES__": repr([tuple(shape)]),
            "__BATCH__": str(BATCH), "__SEQ__": str(SEQ), "__STEPS__": str(STEPS),
            "__VOCAB__": str(VOCAB)}
    code = REPRO_CHILD
    for k, v in subs.items():
        code = code.replace(k, v)
    return code
