"""Port parity, the sharded two-level GnR: ``repro``'s sharded tests on the
same numpy inputs, ``repro`` on a 4-device host mesh in a child process and
the port on 4 gloo ranks on the CPU (``launch.mesh.spawn``, rank bodies in
``tests/test_torch_sharded_ranks.py``).  Every sharded output is held to
``repro``'s own tolerances (fp32 compute: rtol 1e-4, atol 1e-5,
``tests/test_engine.py``) against ``repro``'s sharded output and the
single-device oracle; the collectives the port called are counted.
``repro``'s references run in one child for the whole file, and the ranks
of one mesh shape in one spawn (module fixtures)."""

import os

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_sharded_ranks as R  # noqa: E402
from repro.core import hashing as j_hashing  # noqa: E402
from repro.core import placement as j_placement  # noqa: E402
from repro.data.synthetic import zipf_trace  # noqa: E402
from repro_torch.core import hashing as t_hashing  # noqa: E402
from repro_torch.core import placement as t_placement  # noqa: E402
from repro_torch.core import tt_embedding as t_tt  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

KINDS = [("dense", {}), ("qr", {"collision": 8}), ("tt", {"tt_rank": 4})]
TOL = dict(rtol=1e-4, atol=1e-5)
SPAWN_S = 240          # each spawn's own limit (4 ranks start in ~4 s here)
CHILD_S = 600          # the repro child's limit (every reference of the file)

_HEAD = r"""
import numpy as np, jax, jax.numpy as jnp
from repro import engine as E
from repro.core import embedding_bag as EB, sharded_embedding as SE, qr_embedding as QE
from repro.core.embedding_bag import BagConfig
from repro.core.qr_embedding import EmbeddingConfig
from repro.data.synthetic import zipf_trace
from repro.engine import EngineSpec
from repro.launch.mesh import make_mesh
out = {}
def save_tables(tables, prefix="t"):
    for t, p in enumerate(tables):
        for k, v in p.items():
            out[f"{prefix}{t}.{k}"] = np.asarray(v)
"""


def _spawn(tmp_path, fn, shape, *args, axes=("data", "model")):
    return M.spawn(fn, shape, axes=axes, args=args, device="cpu", backend="gloo",
                   init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Every ``repro`` reference of this file, from one child with four
    host devices: name -> its .npz."""
    from conftest import run_with_devices

    tmp = tmp_path_factory.mktemp("repro")
    paths = {name: str(tmp / f"{name}.npz")
             for name in [k for k, _ in KINDS] + ["two_level", "hot", "compressed", "dup"]}
    code = [_ENGINE.replace("__KIND__", repr(kind)).replace("__KW__", repr(kw))
            .replace("__PATH__", repr(paths[kind])) for kind, kw in KINDS]
    code += [snippet.replace("__PATH__", repr(paths[name])) for name, snippet in
             (("two_level", _TWO_LEVEL), ("hot", _HOT), ("compressed", _COMPRESSED),
              ("dup", _DUP))]
    run_with_devices("".join(code), n_devices=4, timeout=CHILD_S)
    return paths


def _ranks(tmp_path_factory, shape, calls, **kw) -> list:
    """The ranks of one ``shape`` spawn running each ``(fn, args)`` of
    ``calls`` in turn (``R.several``): per call, its result on every rank."""
    res = _spawn(tmp_path_factory.mktemp("rdv"), R.several, shape, calls, **kw)
    return [[r[i] for r in res] for i in range(len(calls))]


@pytest.fixture(scope="module")
def engine_ranks(refs, tmp_path_factory):
    """(2, 2): ``R.engine_parity`` of every kind."""
    got = _ranks(tmp_path_factory, (2, 2),
                 [("engine_parity", (refs[kind], kind, kw)) for kind, kw in KINDS])
    return {kind: res for (kind, _), res in zip(KINDS, got)}


@pytest.fixture(scope="module")
def row_ranks(refs, tmp_path_factory):
    """(1, 4): the two-level GnR, the hot tier and the adopted duplication
    plan."""
    names = (("two_level", "two_level"), ("hot_tier", "hot"), ("dup_gnr", "dup"))
    got = _ranks(tmp_path_factory, (1, 4), [(fn, (refs[ref],)) for fn, ref in names])
    return dict(zip([fn for fn, _ in names], got))


def _gather(res, shape, key):
    """The global output from the ranks' blocks: data-axis blocks in order,
    every rank of a block holding the same rows."""
    data, model = shape
    blocks = []
    for d in range(data):
        block = res[d * model][key]["out"]
        for m in range(1, model):
            np.testing.assert_array_equal(res[d * model + m][key]["out"], block)
        blocks.append(block)
    return np.concatenate(blocks)


# ---------------------------------------------------------------------------
# test_engine.py::test_engine_sharded_parity on a (2, 2) mesh
# ---------------------------------------------------------------------------

_ENGINE = _HEAD + r"""
kind, kw = __KIND__, __KW__
mesh = make_mesh((2, 2), ("data", "model"))
emb = EmbeddingConfig(vocab=4096, dim=32, kind=kind, param_dtype=jnp.float32,
                      compute_dtype=jnp.float32, **kw)
bags = [BagConfig(emb=emb, pooling=8) for _ in range(2)]
tables = EB.init_tables(jax.random.PRNGKey(0), bags)
idx = jax.random.randint(jax.random.PRNGKey(1), (8, 2, 8), 0, 4096)
save_tables(tables); out["idx"] = np.asarray(idx, np.int32)
out["oracle"] = np.asarray(EB.multi_bag_lookup(tables, idx, bags))
sharded = [SE.shard_qr_params(t, b.emb, mesh) for t, b in zip(tables, bags)]
eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
out["packed"] = np.asarray(eng.gnr(mesh)(sharded, idx))
engp = E.compile(E.plan(EngineSpec.from_bags(bags, packing="off"), mesh=mesh))
out["pertable"] = np.asarray(engp.gnr(mesh)(sharded, idx))
if kind != "tt":
    out["baseline"] = np.asarray(eng.baseline(mesh)(sharded, idx))
trace = [zipf_trace(4096, 20000, seed=3 + t) for t in range(2)]
for budget in (32 * 2**20, 8192):
    for packing in ("auto", "off"):
        spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=budget,
                                    packing=packing)
        engd = E.compile(E.plan(spec, mesh=mesh, trace=trace))
        out[f"dup{budget}_{packing}"] = np.asarray(
            engd.gnr(mesh)(tables, idx, engd.hot_tiers(tables)))
        out[f"cf{budget}_{packing}"] = np.asarray(engd.plan.comm_free)
np.savez(__PATH__, **out)
"""


@pytest.mark.parametrize("kind,kw", KINDS)
def test_engine_sharded_parity(kind, kw, refs, engine_ranks):
    ref = np.load(refs[kind])
    shape = (2, 2)
    res = engine_ranks[kind]
    names = ["packed", "pertable"] + ([] if kind == "tt" else ["baseline"])
    names += [f"dup{b}_{p}" for b in R.DUP_BUDGETS for p in ("auto", "off")]
    for name in names:
        got = _gather(res, shape, name)
        np.testing.assert_allclose(got, ref[name], **TOL, err_msg=name)
        np.testing.assert_allclose(got, ref["oracle"], **TOL, err_msg=name)
    for budget in R.DUP_BUDGETS:
        for packing in ("auto", "off"):
            name = f"dup{budget}_{packing}"
            cf = res[0][name]["comm_free"]
            assert cf == list(ref[f"cf{budget}_{packing}"]), name
            assert all(cf) == (budget > 8192), name
            # comm-free tables skip the combine: none at all when all are
            assert all(r[name]["calls"] == (0 if all(cf) else 1) for r in res), name
    for name in ("packed", "pertable", "baseline"):
        if name in res[0]:
            assert all(r[name]["calls"] == 1 for r in res), name


# ---------------------------------------------------------------------------
# test_engine.py::test_engine_gnr_dup_single_device: a (1, 1) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_device(tmp_path_factory):
    """kind -> ``repro``'s duplication engine on a (1, 1) host mesh (its
    output, the oracle, the comm-free flags) and the port's (1, 1) rank on
    the same tables and indices (one spawn for every kind)."""
    from repro import engine as JE
    from repro.core import embedding_bag as JEB
    from repro.core.embedding_bag import BagConfig
    from repro.core.qr_embedding import EmbeddingConfig
    from repro.engine import EngineSpec
    from repro.launch.mesh import make_mesh

    tmp = tmp_path_factory.mktemp("single")
    mesh = make_mesh((1, 1), ("data", "model"))
    refs, calls = {}, []
    for kind, kw in KINDS:
        emb = EmbeddingConfig(vocab=1024, dim=32, kind=kind, param_dtype=jnp.float32,
                              compute_dtype=jnp.float32, **kw)
        bags = [BagConfig(emb=emb, pooling=8) for _ in range(2)]
        tables = JEB.init_tables(jax.random.PRNGKey(10), bags)
        idx = jax.random.randint(jax.random.PRNGKey(11), (4, 2, 8), 0, 1024)
        oracle = np.asarray(JEB.multi_bag_lookup(tables, idx, bags))
        trace = [zipf_trace(1024, 4000, seed=t) for t in range(2)]
        spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=1 << 24)
        eng = JE.compile(JE.plan(spec, mesh=mesh, trace=trace))
        j_out = np.asarray(eng.gnr(mesh)(tables, idx, eng.hot_tiers(tables)))
        out = {"idx": np.asarray(idx, np.int32)}
        R.save_tables(out, tables)
        path = str(tmp / f"{kind}.npz")
        np.savez(path, **out)
        refs[kind] = (j_out, oracle, list(eng.plan.comm_free))
        calls.append(("dup_single", (path, kind, kw)))
    got = _ranks(tmp_path_factory, (1, 1), calls)
    return {kind: (refs[kind], res[0]) for (kind, _), res in zip(KINDS, got)}


@pytest.mark.parametrize("kind,kw", KINDS)
def test_engine_gnr_dup_single_device(kind, kw, single_device):
    (j_out, oracle, comm_free), res = single_device[kind]
    assert res["comm_free"] == comm_free == [True, True]
    assert res["calls"] == 0
    np.testing.assert_allclose(res["out"], j_out, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["out"], oracle, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# test_distributed.py: two-level GnR + token path, hot tier, compressed psum
# ---------------------------------------------------------------------------

_TWO_LEVEL = _HEAD + r"""
mesh = make_mesh((1, 4), ("data", "model"))
cfg = EmbeddingConfig(vocab=1024, dim=64, kind="qr", collision=8, compute_dtype=jnp.float32)
bag = BagConfig(emb=cfg, pooling=4)
params = QE.init(jax.random.PRNGKey(0), cfg)
idx = jax.random.randint(jax.random.PRNGKey(1), (8, 2, 4), 0, 1024)
out["oracle"] = np.asarray(EB.multi_bag_lookup([params, params], idx, [bag, bag]))
sp = SE.shard_qr_params(params, cfg, mesh)
fn = E.compile(E.plan(EngineSpec.from_bags((bag, bag)), mesh=mesh)).gnr(mesh)
out["gnr"] = np.asarray(fn([sp, sp], idx))
tok = jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0, 1024)
out["token"] = np.asarray(SE.build_token_embed(mesh, cfg)(sp, tok))
out["token_oracle"] = np.asarray(QE.lookup(params, tok, cfg))
save_tables([params]); out["idx"] = np.asarray(idx, np.int32); out["tok"] = np.asarray(tok, np.int32)
np.savez(__PATH__, **out)
"""


def test_two_level_gnr_matches_oracle(refs, row_ranks):
    ref = np.load(refs["two_level"])
    shape = (1, 4)
    res = row_ranks["two_level"]
    gnr = _gather(res, shape, "gnr")
    np.testing.assert_allclose(gnr, ref["gnr"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gnr, ref["oracle"], rtol=1e-5, atol=1e-6)
    token = _gather(res, shape, "token")
    np.testing.assert_allclose(token, ref["token"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(token, ref["token_oracle"], rtol=1e-5, atol=1e-6)
    assert all(r["gnr"]["calls"] == 1 and r["token"]["calls"] == 1 for r in res)


_HOT = _HEAD + r"""
from repro.core import placement, hashing
mesh = make_mesh((1, 4), ("data", "model"))
cfg = EmbeddingConfig(vocab=4096, dim=32, kind="qr", collision=8, compute_dtype=jnp.float32)
bag = BagConfig(emb=cfg, pooling=4)
params = QE.init(jax.random.PRNGKey(0), cfg)
trace = zipf_trace(4096, 20000, seed=3)
q_idx, _ = hashing.qr_decompose(jnp.asarray(trace), 8)
counts = placement.profile_counts(np.asarray(q_idx), cfg.qr_spec.q_rows)
plan = placement.plan_tiers(counts, request_share=0.8)
padded = SE.pad_q_table(params["q"], cfg)
slot = np.pad(plan.hot_slot, (0, padded.shape[0] - plan.hot_slot.size), constant_values=-1)
hot, cold = placement.split_table(padded, placement.TierPlan(
    hot_rows=plan.hot_rows, hot_slot=slot, hot_fraction=plan.hot_fraction,
    expected_hot_hit=plan.expected_hot_hit))
tier = {"hot_table": hot, "hot_slot": jnp.asarray(slot)}
sp = SE.shard_qr_params({"q": cold, "r": params["r"]}, cfg, mesh)
idx = jax.random.randint(jax.random.PRNGKey(1), (8, 1, 4), 0, 4096)
out["oracle"] = np.asarray(EB.multi_bag_lookup([params], idx, [bag]))
fn = E.compile(E.plan(EngineSpec.from_bags((bag,)), mesh=mesh)).gnr(mesh, hot=True)
out["gnr"] = np.asarray(fn([sp], idx, [tier]))
save_tables([params]); save_tables([{"q": cold, "r": params["r"]}], prefix="cold")
out["hot_table"] = np.asarray(hot); out["hot_slot"] = slot.astype(np.int32)
out["hot_rows"] = np.asarray(plan.hot_rows); out["idx"] = np.asarray(idx, np.int32)
np.savez(__PATH__, **out)
"""


def test_hot_tier_gnr_matches_oracle(refs, row_ranks):
    ref = np.load(refs["hot"])
    shape = (1, 4)
    res = row_ranks["hot_tier"]
    got = _gather(res, shape, "gnr")
    np.testing.assert_allclose(got, ref["gnr"], **TOL)
    np.testing.assert_allclose(got, ref["oracle"], **TOL)
    # the port's split_table of the same plan is repro's, exactly
    np.testing.assert_array_equal(res[0]["split_hot"], ref["hot_table"])
    np.testing.assert_array_equal(res[0]["split_cold"], ref["cold0.q"])


_COMPRESSED = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import compressed_psum, ef_step
from repro.distributed.jax_compat import shard_map
from repro.launch.mesh import make_mesh
mesh = make_mesh((4,), ("d",))
x = jax.random.normal(jax.random.PRNGKey(0), (4, 128))
sm = lambda f: shard_map(f, mesh=mesh, in_specs=P("d"), out_specs=P("d"), check_vma=False)
exact = sm(lambda v: jax.lax.psum(v, "d"))(x)
approx = sm(lambda v: compressed_psum(v, "d"))(x)
def two_steps(v):
    r = jnp.zeros_like(v)
    g1, r = ef_step(v, r, "d")
    g2, r = ef_step(v, r, "d")
    return g1 + g2
np.savez(__PATH__, x=np.asarray(x), exact=np.asarray(exact), approx=np.asarray(approx),
         ef=np.asarray(sm(two_steps)(x)))
"""


def test_compressed_psum_close_to_exact(refs, tmp_path):
    ref = np.load(refs["compressed"])
    res = _spawn(tmp_path, R.compressed, (4,), refs["compressed"], axes=("d",))
    got = {k: np.concatenate([r[k] for r in res]) for k in ("exact", "approx", "ef")}
    exact = got["exact"]
    scale = np.abs(exact).max() + 1e-9
    # repro's own bounds, then the same int8 wire format as repro's
    assert np.abs(exact - got["approx"]).max() / scale < 0.05
    assert np.abs(2 * exact - got["ef"]).max() / scale < 0.08
    for k in ("exact", "approx", "ef"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# test_cache.py::test_dup_gnr_matches_oracle: an adopted duplication plan
# ---------------------------------------------------------------------------

_DUP = _HEAD + r"""
from repro.cache import duplication
from repro.core import placement
emb = EmbeddingConfig(vocab=4096, dim=32, kind="qr", collision=8,
                      param_dtype=jnp.float32, compute_dtype=jnp.float32)
bags = [BagConfig(emb=emb, pooling=8) for _ in range(2)]
tables = EB.init_tables(jax.random.PRNGKey(0), bags)
idx = jax.random.randint(jax.random.PRNGKey(1), (8, 2, 8), 0, 4096)
out["oracle"] = np.asarray(EB.multi_bag_lookup(tables, idx, bags))
counts = placement.profile_counts(zipf_trace(4096, 20000, seed=1), 4096)
mesh = make_mesh((1, 4), ("data", "model"))
for budget in (32 * 2**20, 8192):
    plan = duplication.plan_duplication(bags, [counts] * 2, num_shards=4, budget_bytes=budget)
    spec = EngineSpec.from_bags(bags, duplication=True)
    fn = E.compile(E.plan(spec, mesh=mesh, dup=plan)).gnr(mesh)
    out[f"dup{budget}"] = np.asarray(fn(tables, idx, SE.make_dup_hot_tiers(tables, bags, plan)))
    out[f"cf{budget}"] = np.asarray(plan.comm_free)
save_tables(tables); out["idx"] = np.asarray(idx, np.int32)
np.savez(__PATH__, **out)
"""


def test_dup_gnr_matches_oracle(refs, row_ranks):
    ref = np.load(refs["dup"])
    shape = (1, 4)
    res = row_ranks["dup_gnr"]
    for budget in R.DUP_BUDGETS:
        got = _gather(res, shape, budget)
        np.testing.assert_allclose(got, ref[f"dup{budget}"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, ref["oracle"], rtol=1e-5, atol=1e-5)
        cf = res[0][budget]["comm_free"]
        assert cf == bool(ref[f"cf{budget}"]) == (budget > 8192)
        assert all(r[budget]["calls"] == (0 if cf else 1) for r in res)


# ---------------------------------------------------------------------------
# placement and hashing: the in-process pieces of the sharded scheme
# ---------------------------------------------------------------------------

def test_hot_vector_reduction_curve():
    """The paper's Fig. 12(a), as ``repro`` tests it, and equal to
    ``repro``'s curve."""
    logical = t_placement.profile_counts(zipf_trace(8192, 40_000, seed=1), 8192)
    curve = t_placement.hot_vector_reduction_curve(logical, [1, 4, 16, 64])
    assert curve[4] <= curve[1]
    assert curve[16] <= curve[4]
    assert curve[64] <= curve[16]
    assert curve[64] > curve[1] / 64
    assert curve == j_placement.hot_vector_reduction_curve(logical, [1, 4, 16, 64])


def test_split_table_and_tt_tiers_match_repro():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((256, 16)).astype(np.float32)
    counts = rng.integers(0, 50, size=256)
    plan = t_placement.plan_tiers(counts, request_share=0.6)
    hot, cold = t_placement.split_table(torch.from_numpy(table), plan)
    j_hot, j_cold = j_placement.split_table(jnp.asarray(table), plan)
    np.testing.assert_array_equal(hot.numpy(), np.asarray(j_hot))
    np.testing.assert_array_equal(cold.numpy(), np.asarray(j_cold))
    # hot + cold lookups never double-count: the hot rows are zero in cold
    assert not cold.numpy()[plan.hot_rows].any()

    from repro.core import tt_embedding as j_tt
    from repro.core.qr_embedding import EmbeddingConfig as JCfg
    from repro_torch.core.qr_embedding import EmbeddingConfig as TCfg

    logical = t_placement.profile_counts(zipf_trace(4096, 20_000, seed=2), 4096)
    j_spec = j_tt.spec_for(JCfg(vocab=4096, dim=32, kind="tt", tt_rank=4))
    t_spec = t_tt.spec_for(TCfg(vocab=4096, dim=32, kind="tt", tt_rank=4))
    for kw in ({}, {"sram_budget": 64, "duplication": 4, "request_share": 0.5}):
        jp = j_placement.plan_tt_tiers(logical, j_spec, **kw)
        tp = t_placement.plan_tt_tiers(logical, t_spec, **kw)
        assert (tp.sram_bytes, tp.sram_budget, tp.duplication, tp.sram_fits, tp.num_hot) == (
            jp.sram_bytes, jp.sram_budget, jp.duplication, jp.sram_fits, jp.num_hot)
        np.testing.assert_array_equal(tp.mid_plan.hot_slot, jp.mid_plan.hot_slot)


@pytest.mark.parametrize("rows,shards", [(1000, 4), (4096, 2), (31250, 4), (7, 3)])
def test_row_owners_match_repro(rows, shards):
    idx = np.random.default_rng(rows).integers(0, rows, size=512).astype(np.int32)
    for name in ("row_owner", "local_row"):
        want = np.asarray(getattr(j_hashing, name)(jnp.asarray(idx), rows, shards))
        np.testing.assert_array_equal(getattr(t_hashing, name)(idx, rows, shards), want)
        np.testing.assert_array_equal(
            getattr(t_hashing, name)(torch.from_numpy(idx), rows, shards).numpy(), want)
    assert t_hashing.padded_rows(rows, shards) == j_hashing.padded_rows(rows, shards)
    # logical rows of a QR table with collision 8 over ``rows`` Q rows
    logical = np.random.default_rng(1).integers(0, rows * 8, size=512).astype(np.int32)
    np.testing.assert_array_equal(
        t_hashing.qr_shard_owner(logical, 8, rows, shards),
        np.asarray(j_hashing.qr_shard_owner(jnp.asarray(logical), 8, rows, shards)))


def test_spawn_lays_out_ranks_as_jax_meshes(tmp_path):
    """Rank r of a (2, 2) mesh sits at its row-major coordinates; its data
    group is its column of ranks, its model group its row."""
    res = _spawn(tmp_path, R.mesh_layout, (2, 2))
    for r, got in enumerate(res):
        d, m = divmod(r, 2)
        assert got["rank"] == r and got["coords"] == {"data": d, "model": m}
        assert got["groups"] == {"data": [m, 2 + m], "model": [2 * d, 2 * d + 1]}
    assert not os.path.exists(tmp_path / "rdv")


@pytest.mark.parametrize("kind,kw", KINDS + [("mixed", {})])
def test_duplication_plan_matches_repro_at_every_budget(kind, kw):
    """The planner's one-width count (every packable set) and its scan (bag
    sets of several row widths) give ``repro``'s plan at budgets from none
    to everything."""
    from repro.cache import duplication as j_dup
    from repro.core.embedding_bag import BagConfig as JBag
    from repro.core.qr_embedding import EmbeddingConfig as JCfg
    from repro_torch.cache import duplication as t_dup

    from repro_torch.core.embedding_bag import BagConfig as TBag
    from repro_torch.core.qr_embedding import EmbeddingConfig as TCfg

    def bags(Cfg, Bag):
        if kind == "mixed":   # dense rows of 32 and 64 values, a QR table
            return [Bag(emb=Cfg(vocab=2048, dim=32, kind="dense")),
                    Bag(emb=Cfg(vocab=1024, dim=64, kind="dense")),
                    Bag(emb=Cfg(vocab=4096, dim=32, kind="qr", collision=8))]
        return [Bag(emb=Cfg(vocab=4096, dim=32, kind=kind, **kw)) for _ in range(3)]

    jb, tb = bags(JCfg, JBag), bags(TCfg, TBag)
    counts = [t_placement.profile_counts(zipf_trace(b.emb.vocab, 20_000, seed=t), b.emb.vocab)
              for t, b in enumerate(jb)]
    for budget in (0, 4096, 8192, 1 << 16, 1 << 20, 1 << 22, 1 << 40):
        jp = j_dup.plan_duplication(jb, counts, num_shards=4, budget_bytes=budget)
        tp = t_dup.plan_duplication(tb, counts, num_shards=4, budget_bytes=budget)
        assert [t.hot_plan.num_hot for t in tp.tables] == [
            t.hot_plan.num_hot for t in jp.tables], budget
        assert [t.comm_free for t in tp.tables] == [t.comm_free for t in jp.tables], budget
        assert tp.replicated_bytes == jp.replicated_bytes, budget
        for a, b in zip(tp.tables, jp.tables):
            np.testing.assert_array_equal(a.hot_plan.hot_slot, b.hot_plan.hot_slot)
