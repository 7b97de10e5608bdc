"""Rank bodies of the sharded parity tests.  No jax and no tests: every
rank of ``repro_torch.launch.mesh.spawn`` imports this module, not the test
files that spawn it.

Each body runs on one rank of a gloo mesh on the CPU, loads the case's
numpy inputs (written by the test, or by ``repro`` in its child process)
from an ``.npz``, runs the port's sharded path on the rank's pieces and
returns its block of each output as numpy, with the collectives it called.
"""

from __future__ import annotations

import numpy as np
import torch
from torch_one_thread import one_thread  # noqa: F401

from repro_torch import convert
from repro_torch import engine as E
from repro_torch.cache import duplication
from repro_torch.core import embedding_bag as EB
from repro_torch.core import placement
from repro_torch.core import sharded_embedding as SE
from repro_torch.core.embedding_bag import BagConfig
from repro_torch.core.qr_embedding import EmbeddingConfig
from repro_torch.data.synthetic import zipf_trace
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.engine import EngineSpec
from repro_torch.kernels import packed_gather as pg
from repro_torch.kernels import tt_gather as tg

DUP_BUDGETS = (32 * 2**20, 8192)        # comm-free and mixed regimes


def bags_for(kind: str, kw: dict, *, vocab: int = 4096, dim: int = 32, pooling: int = 8,
             num_tables: int = 2, compute=torch.float32) -> list[BagConfig]:
    emb = EmbeddingConfig(vocab=vocab, dim=dim, kind=kind, param_dtype=torch.float32,
                          compute_dtype=compute, **kw)
    return [BagConfig(emb=emb, pooling=pooling) for _ in range(num_tables)]


def save_tables(out: dict, tables, prefix: str = "t") -> None:
    for t, params in enumerate(tables):
        for k, v in params.items():
            out[f"{prefix}{t}.{k}"] = np.asarray(v)


def load_tables(arrs, prefix: str = "t") -> list[dict]:
    tables: dict[int, dict] = {}
    for name in arrs.files:
        head, _, key = name.partition(".")
        if key and head.startswith(prefix) and head[len(prefix):].isdigit():
            tables.setdefault(int(head[len(prefix):]), {})[key] = arrs[name]
    return convert.tables_from_numpy([tables[t] for t in sorted(tables)], "cpu")


def batch_block(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    return SH.local_shard(x, mesh, P(axis))


def _launches() -> int:
    return sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values())


def _run(fn, *args):
    """``fn(*args)`` as fp32 numpy, with the all_reduce calls it made and
    the packed kernels it launched (none on the CPU)."""
    collectives.reset_counts()
    before = _launches()
    out = fn(*args)
    return {"out": out.float().cpu().numpy(), "calls": collectives.CALLS["all_reduce"],
            "bytes": collectives.BYTES["all_reduce"], "launches": _launches() - before}


def several(mesh, calls) -> list:
    """Each ``(name, args)`` of ``calls`` in turn, the function of this
    module called as ``name(mesh, *args)``: one spawn for several checks."""
    return [globals()[name](mesh, *args) for name, args in calls]


def engine_parity(mesh, path: str, kind: str, kw: dict) -> dict:
    """``repro``'s ``test_engine_sharded_parity`` cases on this rank: packed,
    per-table, baseline (not TT, as ``repro``), duplication at both budgets
    (the port plans from the same traces)."""
    arrs = np.load(path)
    bags = bags_for(kind, kw)
    tables = load_tables(arrs)
    idx = batch_block(torch.from_numpy(arrs["idx"]), mesh)
    res = {}
    eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
    local = eng.shard_tables(tables, mesh)
    res["packed"] = _run(eng.gnr(mesh), local, idx)
    engp = E.compile(E.plan(EngineSpec.from_bags(bags, packing="off"), mesh=mesh))
    res["pertable"] = _run(engp.gnr(mesh), local, idx)
    if kind != "tt":
        res["baseline"] = _run(eng.baseline(mesh), local, idx)
    traces = [zipf_trace(4096, 20000, seed=3 + t) for t in range(2)]
    for budget in DUP_BUDGETS:
        spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=budget)
        for packing in ("auto", "off"):
            engd = E.compile(E.plan(spec.replace(packing=packing), mesh=mesh, trace=traces))
            name = f"dup{budget}_{packing}"
            res[name] = _run(engd.gnr(mesh), engd.shard_tables(tables, mesh), idx,
                             engd.hot_tiers(tables))
            res[name]["comm_free"] = list(engd.plan.comm_free)
    return res


def two_level(mesh, path: str) -> dict:
    """``repro``'s ``test_two_level_gnr_matches_oracle``: packed two-level GnR
    over two tables sharing one QR table, then the token path."""
    arrs = np.load(path)
    bag = bags_for("qr", {"collision": 8}, vocab=1024, dim=64, pooling=4, num_tables=1)[0]
    params = load_tables(arrs)[0]
    sp = SE.shard_qr_params(params, bag.emb, mesh)
    eng = E.compile(E.plan(EngineSpec.from_bags((bag, bag)), mesh=mesh))
    idx = batch_block(torch.from_numpy(arrs["idx"]), mesh)
    tok = batch_block(torch.from_numpy(arrs["tok"]), mesh)
    fn2 = SE.build_token_embed(mesh, bag.emb)
    return {"gnr": _run(eng.gnr(mesh), [sp, sp], idx), "token": _run(fn2, sp, tok)}


def hot_tier(mesh, path: str) -> dict:
    """``repro``'s ``test_hot_tier_gnr_matches_oracle``: ``repro``'s hot tier
    (``split_table``'s hot rows and its zeroed cold table) carried over."""
    arrs = np.load(path)
    bag = bags_for("qr", {"collision": 8}, pooling=4, num_tables=1)[0]
    cold = load_tables(arrs, prefix="cold")[0]
    tier = convert.hot_tiers_from_numpy([{"hot_table": arrs["hot_table"],
                                          "hot_slot": arrs["hot_slot"]}], "cpu")
    sp = SE.shard_qr_params(cold, bag.emb, mesh)
    idx = batch_block(torch.from_numpy(arrs["idx"]), mesh)
    eng = E.compile(E.plan(EngineSpec.from_bags((bag,)), mesh=mesh))
    res = {"gnr": _run(eng.gnr(mesh, hot=True), [sp], idx, tier)}
    # the port's own split of the same padded table gives the same tier
    full = load_tables(arrs)[0]
    padded = SE.pad_q_table(full["q"], bag.emb)
    plan = placement.TierPlan(hot_rows=arrs["hot_rows"], hot_slot=arrs["hot_slot"],
                              hot_fraction=0.0, expected_hot_hit=0.0)
    hot, cold_q = placement.split_table(padded, plan)
    res["split_hot"] = hot.numpy()
    res["split_cold"] = cold_q.numpy()
    return res


def compressed(mesh, path: str) -> dict:
    """``repro``'s ``test_compressed_psum_close_to_exact`` on a (4,) mesh
    over axis ``d``: each rank holds one row block of ``x``."""
    x = SH.local_shard(torch.from_numpy(np.load(path)["x"]), mesh, P("d"))
    exact = collectives.psum(x, mesh, "d")
    approx = collectives.compressed_psum(x, mesh, "d")
    r = torch.zeros_like(x)
    g1, r = collectives.ef_step(x, r, mesh, "d")
    g2, r = collectives.ef_step(x, r, mesh, "d")
    return {"exact": exact.numpy(), "approx": approx.numpy(), "ef": (g1 + g2).numpy()}


def overlap_case(mesh) -> dict:
    """``core.overlap.chunked_psum`` against the plain psum over ``model``
    on this rank's (4, 8) block, and its refusal of uneven chunks."""
    from repro_torch.core import overlap

    g = torch.Generator().manual_seed(7 + mesh.axis_index("model"))
    x = torch.randn(4, 8, generator=g)
    try:
        overlap.chunked_psum(x, mesh, "model", chunks=3)
        refused = False
    except ValueError:
        refused = True
    return {"x": x.numpy(), "plain": collectives.psum(x, mesh, "model").numpy(),
            "chunked": overlap.chunked_psum(x, mesh, "model", chunks=4).numpy(),
            "refused": refused}


def dup_gnr(mesh, path: str) -> dict:
    """``repro``'s ``test_dup_gnr_matches_oracle``: a pre-built duplication
    plan adopted by ``plan(dup=...)``, both regimes."""
    arrs = np.load(path)
    bags = bags_for("qr", {"collision": 8})
    tables = load_tables(arrs)
    idx = batch_block(torch.from_numpy(arrs["idx"]), mesh)
    counts = placement.profile_counts(zipf_trace(4096, 20000, seed=1), 4096)
    res = {}
    for budget in DUP_BUDGETS:
        plan = duplication.plan_duplication(bags, [counts] * 2, num_shards=4,
                                            budget_bytes=budget)
        spec = EngineSpec.from_bags(bags, duplication=True)
        eng = E.compile(E.plan(spec, mesh=mesh, dup=plan))
        tiers = SE.make_dup_hot_tiers(tables, bags, plan)
        res[budget] = _run(eng.gnr(mesh), eng.shard_tables(tables, mesh), idx, tiers)
        res[budget]["comm_free"] = plan.comm_free
    return res


def dup_single(mesh, path: str, kind: str, kw: dict) -> dict:
    """``repro``'s ``test_engine_gnr_dup_single_device`` on a (1, 1) mesh."""
    arrs = np.load(path)
    bags = bags_for(kind, kw, vocab=1024)
    tables = load_tables(arrs)
    trace = [zipf_trace(1024, 4000, seed=t) for t in range(2)]
    spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=1 << 24)
    eng = E.compile(E.plan(spec, mesh=mesh, trace=trace))
    res = _run(eng.gnr(mesh), eng.shard_tables(tables, mesh), torch.from_numpy(arrs["idx"]),
               eng.hot_tiers(tables))
    res["comm_free"] = list(eng.plan.comm_free)
    return res


def sharded_dlrm(mesh, path: str, arch: str) -> dict:
    """``repro``'s ``test_sharded_dlrm_matches_single``: the DLRM forward
    under ``use_rules`` on this rank's batch shard and row shards."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import dlrm

    arrs = np.load(path)
    cfg = dataclasses.replace(registry.get_dlrm(arch), compute_dtype="float32")
    tree = {"bottom": [], "top": [], "tables": []}
    for part in tree:
        rows: dict[int, dict] = {}
        for name in arrs.files:
            if name.startswith(part + "/"):
                _p, t, key = name.split("/")
                rows.setdefault(int(t), {})[key] = arrs[name]
        tree[part] = [rows[t] for t in sorted(rows)]
    params = convert.params_from_numpy(tree, "cpu")
    padded = dlrm.pad_tables_for_mesh(params, cfg, mesh.shape["model"])
    local = {**padded, "tables": [SE.shard_qr_params(t, b.emb, mesh) for t, b in
                                  zip(padded["tables"], dlrm.make_bags(cfg))]}
    dense = batch_block(torch.from_numpy(arrs["dense"]), mesh)
    idx = batch_block(torch.from_numpy(arrs["idx"]), mesh)
    with SH.use_rules(mesh, SH.DEFAULT_RULES):
        return _run(dlrm.forward_dlrm, local, dense, idx, cfg)


INVARIANT_KINDS = (("qr", {"collision": 8}), ("dense", {}), ("tt", {"tt_rank": 4}))


def invariant_case(kind: str, kw: dict, dtype: torch.dtype, seed: int = 0):
    """(bags, global tables, global idx, traces) of one invariants case,
    drawn from ``seed``: the same on every rank and in the test."""
    bags = bags_for(kind, kw, compute=dtype)
    g = torch.Generator().manual_seed(seed)
    tables = EB.init_tables(bags, generator=g, device=torch.device("cpu"))
    idx = torch.randint(0, 4096, (8, 2, 8), generator=g, dtype=torch.int32)
    traces = [zipf_trace(4096, 5000, seed=t) for t in range(2)]
    return bags, tables, idx, traces


def invariants(mesh, dtype: torch.dtype, device: str = "cpu") -> dict:
    """The port against itself, no ``repro``: per kind, the packed and
    per-table gnr, the baseline and an all-comm-free duplication plan (packed
    and per-table), each on this rank's pieces of one seeded case."""
    dev = torch.device(device)
    res = {}
    for kind, kw in INVARIANT_KINDS:
        bags, tables, idx, traces = invariant_case(kind, kw, dtype)
        tables = [{k: v.to(dev) for k, v in t.items()} for t in tables]
        idx = batch_block(idx.to(dev), mesh)
        out = res[kind] = {}
        eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
        local = eng.shard_tables(tables, mesh)
        out["packed"] = _run(eng.gnr(mesh), local, idx)
        engp = E.compile(E.plan(EngineSpec.from_bags(bags, packing="off"), mesh=mesh))
        out["pertable"] = _run(engp.gnr(mesh), local, idx)
        out["baseline"] = _run(eng.baseline(mesh), local, idx)
        spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=1 << 26)
        for packing in ("auto", "off"):
            engd = E.compile(E.plan(spec.replace(packing=packing), mesh=mesh, trace=traces))
            name = f"dup_{packing}"
            out[name] = _run(engd.gnr(mesh), engd.shard_tables(tables, mesh), idx,
                             engd.hot_tiers(tables))
            out[name]["comm_free"] = list(engd.plan.comm_free)
    return res


def mesh_layout(mesh) -> dict:
    """The rank's coordinates and the members of its axis groups."""
    import torch.distributed as dist

    return {"rank": dist.get_rank(), "coords": dict(mesh.coords),
            "groups": {ax: sorted(dist.get_process_group_ranks(g))
                       for ax, g in mesh.groups.items()}}


# ---------------------------------------------------------------------------
# the rounding rule for sharded outputs in a narrow compute dtype
# ---------------------------------------------------------------------------

# Roundings to the compute dtype inside one rank's partial, by path and kind.
# Each errs by at most u times a value whose magnitudes sum to at most A
# (below), so the partials of all shards together count once: the packed
# kernel sums in fp32 and rounds its output once; the per-table partials and
# the baseline's pooling round the Q + R add and the sum (QR), the sum
# (dense), the two chained products and the sum (TT).
PARTIAL_ROUNDINGS = {"packed": {"qr": 1, "dense": 1, "tt": 1},
                     "pertable": {"qr": 2, "dense": 1, "tt": 3}}


def rounding_tol(abs_sum: np.ndarray, dtype: torch.dtype, *, combine_adds: int,
                 partial: int, terms: int) -> np.ndarray:
    """Bound on |sharded output - exact fp32 sum| per element.

    ``abs_sum`` (A) is the sum of the magnitudes of every term the output
    adds (|Q row| + |R row| per element for QR, |row| for dense, the
    contraction of |G1|, |G2|, |G3| for TT), so every partial and every
    partial sum of the combine is at most A.  With u the compute dtype's
    unit roundoff (2^-8 for bf16, 2^-24 for fp32): ``partial`` roundings
    inside the partials, ``combine_adds`` (N - 1 for N shards, 0 without a
    combine) additions of the psum, each <= u (1 + u) A; plus the fp32
    accumulation of the kernel and of the reference, ``terms`` additions
    each, <= 2 terms 2^-24 A."""
    u = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
    return ((partial + combine_adds) * u * (1 + u) + 2 * terms * 2.0 ** -24) * abs_sum


def reference(kind: str, kw: dict, dtype: torch.dtype, tables, idx) -> tuple:
    """(S, A) in fp32 for ``invariant_case``'s tables: S the plain
    single-device sum over the tables rounded to the compute dtype (the
    value every path rounds from), A the sum of its terms' magnitudes."""
    bags32 = bags_for(kind, kw)
    rounded = [{k: v.to(dtype).float() for k, v in t.items()} for t in tables]
    s = EB.multi_bag_lookup(rounded, idx, bags32)
    a = EB.multi_bag_lookup([{k: v.abs() for k, v in t.items()} for t in rounded], idx,
                            bags32)
    return s.numpy(), a.numpy()


def terms_of(kind: str, kw: dict, pooling: int = 8) -> int:
    """fp32 additions in one output element's chain: 2K for QR (Q and R
    rows), K for dense, K plus the two rank-long products for TT."""
    return {"qr": 2 * pooling, "dense": pooling}.get(kind, pooling + 2 * kw.get("tt_rank", 0))
