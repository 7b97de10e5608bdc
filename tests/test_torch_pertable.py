"""Port parity of the per-table slice: the hashing trick's index math, the
``ops`` bag entry points (K4a ``cached_pooled``, K4b ``cached_qr_pooled``,
K6 ``gnr_pooled``, K7 ``gnr_pooled_dense``, K8 ``qr_lookup``),
``qr_embedding`` for every kind, ``embedding_bag``, the engine's ``lookup``
and ``cached_lookup``, the hashed branches of the planners, and the two
examples.

Inputs are made from a seed with numpy and handed to both packages;
``repro``'s Pallas kernels run in interpret mode, as ``tests/test_kernels.py``
runs them.  Index math is bitwise.  fp32 results agree at rtol = atol =
1e-5 (the plain versions sum in another order).  bf16 results are compared
in fp32 at ``repro``'s own tolerances (``tests/test_kernels.py:29,56``,
``tests/test_cached_gather.py:53``).  On the CPU the wrappers take their
plain versions, so no ``LAUNCHES`` counter moves.  The CUDA kernels are held
against the plain versions on the card in ``test_torch_gpu.py``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import engine as j_engine  # noqa: E402
from repro.cache import duplication as j_dup  # noqa: E402
from repro.cache import intra_gnr as j_gnr  # noqa: E402
from repro.cache.sram_cache import PrefetchScheduler as JSched  # noqa: E402
from repro.core import embedding_bag as j_eb  # noqa: E402
from repro.core import hashing as j_hash  # noqa: E402
from repro.core import qr_embedding as j_qe  # noqa: E402
from repro.core import placement as j_place  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.cache import duplication as t_dup  # noqa: E402
from repro_torch.cache import intra_gnr as t_gnr  # noqa: E402
from repro_torch.cache.sram_cache import PrefetchScheduler as TSched  # noqa: E402
from repro_torch.core import embedding_bag as t_eb  # noqa: E402
from repro_torch.core import hashing as t_hash  # noqa: E402
from repro_torch.core import packed_tables as t_pt  # noqa: E402
from repro_torch.core import qr_embedding as t_qe  # noqa: E402
from repro_torch.examples import cache_plan, quickstart  # noqa: E402
from repro_torch.kernels import cached_gather, gnr_bag, ops as t_ops, qr_gather  # noqa: E402
from repro_torch.kernels import packed_gather, tt_gather  # noqa: E402
import torch_pertable_inputs as pti  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
# repro's bf16 tolerances: test_kernels.py:29 (qr_lookup), :56 (gnr), and
# test_cached_gather.py:53 (cached); the dense bag takes gnr's
BF16_TOL = {"qr_lookup": dict(rtol=2e-2, atol=0.0)}
BF16_POOLED = dict(rtol=3e-2, atol=1e-2)
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _all_launches() -> int:
    return sum(sum(m.LAUNCHES.values())
               for m in (cached_gather, gnr_bag, qr_gather, packed_gather, tt_gather))


def _close(got, expect, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), **tol)


# ---------------------------------------------------------------------------
# the hashing trick, bit for bit
# ---------------------------------------------------------------------------

HASH_IDX = np.concatenate([[0, 1, 2**31 - 1],
                           np.random.default_rng(0).integers(0, 2**31 - 1, 2000)]
                          ).astype(np.int32)


@pytest.mark.parametrize("buckets", [1, 7, 31_250, 2**20])
def test_universal_hash_bitwise(buckets):
    for seed in range(4):
        expect = np.asarray(j_hash.universal_hash(jnp.asarray(HASH_IDX), buckets, seed))
        got_np = t_hash.universal_hash(HASH_IDX, buckets, seed)
        got_t = t_hash.universal_hash(torch.from_numpy(HASH_IDX), buckets, seed)
        assert got_np.dtype == np.int32 and got_t.dtype == torch.int32
        np.testing.assert_array_equal(got_np, expect)
        np.testing.assert_array_equal(got_t.numpy(), expect)


@pytest.mark.parametrize("buckets", [7, 31_250])
def test_k_ary_hash_bitwise(buckets):
    idx = HASH_IDX[:150].reshape(50, 3)
    expect = np.asarray(j_hash.k_ary_hash(jnp.asarray(idx), buckets, 3))
    assert expect.shape == (50, 3, 3)
    np.testing.assert_array_equal(t_hash.k_ary_hash(idx, buckets, 3), expect)
    np.testing.assert_array_equal(
        t_hash.k_ary_hash(torch.from_numpy(idx), buckets, 3).numpy(), expect)


# ---------------------------------------------------------------------------
# the ops entry points against repro's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

LEADS = [(7,), (2, 5), (3, 2, 2)]
POOLED = {
    # name: (repro call, port call, args helper)
    "gnr_pooled": (j_ops.gnr_pooled, t_ops.gnr_pooled, pti.qr_args),
    "gnr_pooled_dense": (j_ops.gnr_pooled_dense, t_ops.gnr_pooled_dense, pti.dense_args),
    "cached_pooled": (j_ops.cached_pooled, t_ops.cached_pooled, pti.cached_args),
    "cached_qr_pooled": (j_ops.cached_qr_pooled, t_ops.cached_qr_pooled, pti.cached_qr_args),
}


@pytest.mark.parametrize("dtype", pti.DTYPES)
@pytest.mark.parametrize("dim", [32, 128, 640])
@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("name", sorted(POOLED))
def test_pooled_entry_points_match_repro(name, k, dim, dtype):
    j_fn, t_fn, args = POOLED[name]
    tol = TOL if dtype == "float32" else BF16_POOLED
    for i, lead in enumerate(LEADS):
        a = pti.pertable_inputs(lead=lead, k=k, dim=dim, seed=i)
        before = _all_launches()
        got = t_fn(*args(a, torch.from_numpy, lambda x: x.to(T_DT[dtype])))
        expect = j_fn(*args(a, jnp.asarray, lambda x: x.astype(J_DT[dtype])))
        assert got.shape == lead + (dim,) and got.dtype == T_DT[dtype]
        _close(got, expect, **tol)
        assert _all_launches() == before          # the plain version ran


@pytest.mark.parametrize("dtype", pti.DTYPES)
@pytest.mark.parametrize("dim", [32, 128, 640])
def test_qr_lookup_matches_repro(dim, dtype):
    tol = TOL if dtype == "float32" else BF16_TOL["qr_lookup"]
    for i, lead in enumerate(LEADS):
        a = pti.pertable_inputs(lead=lead[:-1], k=lead[-1], dim=dim, seed=i)
        got = t_ops.qr_lookup(*pti.qr_args(a, torch.from_numpy,
                                           lambda x: x.to(T_DT[dtype])))
        expect = j_ops.qr_lookup(*pti.qr_args(a, jnp.asarray,
                                              lambda x: x.astype(J_DT[dtype])))
        assert got.shape == lead + (dim,) and got.dtype == T_DT[dtype]
        _close(got, expect, **tol)
    assert qr_gather.LAUNCHES["qr_gather"] == 0


def test_illegal_dim_block_raises_in_both():
    for dim, block in [(96, 128), (13, 13)]:
        a = pti.pertable_inputs(dim=dim)
        for pkg, to in ((j_ops, jnp.asarray), (t_ops, torch.from_numpy)):
            with pytest.raises(ValueError, match=f"not valid for dim {dim}"):
                pkg.gnr_pooled(*pti.qr_args(a, to), dim_block=block)
            with pytest.raises(ValueError, match=f"not valid for dim {dim}"):
                pkg.cached_pooled(*pti.cached_args(a, to), dim_block=block)
    a = pti.pertable_inputs(dim=256)
    _close(t_ops.gnr_pooled_dense(*pti.dense_args(a, torch.from_numpy), dim_block=128),
           j_ops.gnr_pooled_dense(*pti.dense_args(a, jnp.asarray), dim_block=128), **TOL)


# ---------------------------------------------------------------------------
# qr_embedding, every kind
# ---------------------------------------------------------------------------

KINDS = {
    "dense": dict(kind="dense"),
    "hashed": dict(kind="hashed", hashed_rows=50, hashed_k=3),
    "qr_add": dict(kind="qr", collision=8),
    "qr_mul": dict(kind="qr", collision=8, reconstruction="mul"),
    "qr_concat": dict(kind="qr", collision=8, reconstruction="concat"),
    "tt": dict(kind="tt", tt_rank=4),
    "tt_pallas": dict(kind="tt", tt_rank=4, tt_exec="pallas"),
}


def _embs(kind, vocab=300, dim=16, compute="float32", **kw):
    jkw, tkw = dict(KINDS[kind], **kw), dict(KINDS[kind], **kw)
    je = j_qe.EmbeddingConfig(vocab=vocab, dim=dim, param_dtype=jnp.float32,
                              compute_dtype=J_DT[compute], **jkw)
    te = t_qe.EmbeddingConfig(vocab=vocab, dim=dim, param_dtype=torch.float32,
                              compute_dtype=T_DT[compute], **tkw)
    return je, te


def _params(je, seed=0):
    jp = j_qe.init(jax.random.PRNGKey(seed), je)
    return jp, convert.tables_from_numpy([jp], "cpu")[0]


def _idx(shape, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_embedding_matches_repro(kind):
    je, te = _embs(kind)
    assert te.param_count() == je.param_count()
    assert t_qe.param_axes(te) == j_qe.param_axes(je)
    tp = t_qe.init(te, generator=torch.Generator().manual_seed(0), device="cpu")
    jp, cp = _params(je)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    idx = _idx((4, 5), je.vocab)
    _close(t_qe.lookup(cp, torch.from_numpy(idx), te),
           j_qe.lookup(jp, jnp.asarray(idx), je), **TOL)
    _close(t_qe.materialize(cp, te), j_qe.materialize(jp, je), **TOL)
    x = np.random.default_rng(2).standard_normal((3, te.dim)).astype(np.float32)
    _close(t_qe.logits_head(cp, torch.from_numpy(x), te),
           j_qe.logits_head(jp, jnp.asarray(x), je), rtol=1e-4, atol=1e-4)


def test_embedding_bf16_head_and_lookup():
    je, te = _embs("qr_add", compute="bfloat16", head="materialize")
    jp, cp = _params(je)
    idx = _idx((6, 4), je.vocab)
    _close(t_qe.lookup(cp, torch.from_numpy(idx), te),
           j_qe.lookup(jp, jnp.asarray(idx), je), **BF16_TOL["qr_lookup"])
    x = np.random.default_rng(3).standard_normal((2, te.dim)).astype(np.float32)
    _close(t_qe.logits_head(cp, torch.from_numpy(x).to(torch.bfloat16), te),
           j_qe.logits_head(jp, jnp.asarray(x, jnp.bfloat16), je), **BF16_POOLED)


# ---------------------------------------------------------------------------
# embedding_bag
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_bag_lookup_matches_repro(kind, weighted, combiner):
    je, te = _embs(kind)
    jp, cp = _params(je)
    jb, tb = j_eb.BagConfig(emb=je, pooling=6, combiner=combiner), \
        t_eb.BagConfig(emb=te, pooling=6, combiner=combiner)
    idx = _idx((5, 6), je.vocab)
    w = np.random.default_rng(4).random((5, 6)).astype(np.float32) if weighted else None
    got = t_eb.bag_lookup(cp, torch.from_numpy(idx), tb,
                          None if w is None else torch.from_numpy(w))
    expect = j_eb.bag_lookup(jp, jnp.asarray(idx), jb, None if w is None else jnp.asarray(w))
    assert got.dtype == torch.float32
    _close(got, expect, **TOL)
    assert _all_launches() == 0


def test_multi_bag_lookup_and_axes_match_repro():
    kinds = ["dense", "hashed", "qr_add", "tt_pallas"]
    pairs = [_embs(k, vocab=200 + 50 * i) for i, k in enumerate(kinds)]
    jbags = [j_eb.BagConfig(emb=je, pooling=4) for je, _ in pairs]
    tbags = [t_eb.BagConfig(emb=te, pooling=4) for _, te in pairs]
    jt = j_eb.init_tables(jax.random.PRNGKey(5), jbags)
    tt = convert.tables_from_numpy(jt, "cpu")
    idx = _idx((3, 4, 4), 200)
    w = np.random.default_rng(6).random((3, 4, 4)).astype(np.float32)
    for wt in (None, w):
        _close(t_eb.multi_bag_lookup(tt, torch.from_numpy(idx), tbags,
                                     None if wt is None else torch.from_numpy(wt)),
               j_eb.multi_bag_lookup(jt, jnp.asarray(idx), jbags,
                                     None if wt is None else jnp.asarray(wt)), **TOL)
    assert t_eb.table_axes(tbags) == j_eb.table_axes(jbags)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_traffic_model_matches_repro(kind):
    je, te = _embs(kind, vocab=4096, dim=128)
    for bpe in (2, 4):
        assert t_eb.traffic_model(t_eb.BagConfig(emb=te), bpe) == \
            j_eb.traffic_model(j_eb.BagConfig(emb=je), bpe)


# ---------------------------------------------------------------------------
# the engine: engine_for, cached_lookup, lookup
# ---------------------------------------------------------------------------

def _bags(kind, num_tables=3, vocab=1024, dim=32, pooling=8, compute="float32", **kw):
    je, te = _embs(kind, vocab=vocab, dim=dim, compute=compute, **kw)
    return ([j_eb.BagConfig(emb=je, pooling=pooling) for _ in range(num_tables)],
            [t_eb.BagConfig(emb=te, pooling=pooling) for _ in range(num_tables)])


def test_engine_for_is_memoised():
    _, tb = _bags("dense")
    spec = t_engine.EngineSpec.from_bags(tb)
    assert t_engine.engine_for(spec) is t_engine.engine_for(spec)
    assert t_engine.engine_for(spec) is not t_engine.engine_for(spec, num_shards=2)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("kind", ["dense", "qr_add", "tt_pallas", "hashed"])
def test_cached_lookup_matches_repro(kind, combiner):
    jb, tb = _bags(kind, num_tables=1)
    jb = [dataclasses.replace(jb[0], combiner=combiner)]
    tb = [dataclasses.replace(tb[0], combiner=combiner)]
    emb = jb[0].emb
    jp = j_eb.init_tables(jax.random.PRNGKey(6), jb)[0]
    tp = convert.tables_from_numpy([jp], "cpu")[0]
    idx = _idx((6, 8), 1024, seed=7)
    _name, rows = j_engine.big_subtable(emb)
    assert t_engine.big_subtable(tb[0].emb) == (_name, rows)
    js, ts = JSched(rows, 16), TSched(rows, 16)
    r = j_engine.big_rows(idx, emb)
    np.testing.assert_array_equal(t_engine.big_rows(idx, tb[0].emb), r)
    js.prefetch(r)
    ts.prefetch(r)
    slot = ts.slots_for(r)
    np.testing.assert_array_equal(slot, js.slots_for(r))
    np.testing.assert_array_equal(ts.cache_rows(), js.cache_rows())
    if kind in ("dense", "qr_add"):
        assert (slot >= 0).any() and (slot < 0).any()
    j_eng = j_engine.engine_for(j_engine.EngineSpec.from_bags(jb))
    t_eng = t_engine.engine_for(t_engine.EngineSpec.from_bags(tb))
    rows_t = torch.from_numpy(ts.cache_rows())
    slot_t = torch.from_numpy(slot) if slot.shape == idx.shape else None
    got = t_eng.cached_lookup(tp, torch.from_numpy(idx), 0, cache_rows=rows_t, slot=slot_t)
    expect = j_eng.cached_lookup(jp, jnp.asarray(idx), 0,
                                 cache_rows=jnp.asarray(js.cache_rows()),
                                 slot=None if slot_t is None else jnp.asarray(slot))
    assert got.shape == (6, 32)
    _close(got, expect, **TOL)
    # the cache mirrors the table, so the cached bag is the plain bag
    _close(got, t_eb.bag_lookup(tp, torch.from_numpy(idx), tb[0]), **TOL)
    assert _all_launches() == 0


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["dense", "qr_add", "tt"])
def test_lookup_packed_matches_repro(kind, compute):
    jb, tb = _bags(kind, compute=compute)
    jt = j_eb.init_tables(jax.random.PRNGKey(0), jb)
    tt = convert.tables_from_numpy(jt, "cpu")
    idx = _idx((5, 3, 8), 1024)
    j_eng = j_engine.compile(j_engine.plan(j_engine.EngineSpec.from_bags(jb)))
    t_eng = t_engine.compile(t_engine.plan(t_engine.EngineSpec.from_bags(tb)))
    assert t_eng.plan.packed and j_eng.plan.packed
    got = t_eng.lookup(tt, torch.from_numpy(idx))
    expect = j_eng.lookup(jt, jnp.asarray(idx))
    assert got.dtype == T_DT[compute] and got.shape == (5, 3, 32)
    _close(got, expect, **(TOL if compute == "float32" else BF16_POOLED))
    assert _all_launches() == 0


@pytest.mark.parametrize("set_", ["hashed", "mixed_vocab", "forced_off"])
def test_lookup_per_table_matches_repro(set_):
    if set_ == "hashed":
        jb, tb = _bags("hashed", vocab=1024)
    elif set_ == "mixed_vocab":
        pairs = [_embs("qr_add", vocab=v, dim=32) for v in (512, 1024, 700)]
        jb = [j_eb.BagConfig(emb=je, pooling=8) for je, _ in pairs]
        tb = [t_eb.BagConfig(emb=te, pooling=8) for _, te in pairs]
    else:
        jb, tb = _bags("qr_add")
    kw = dict(packing="off") if set_ == "forced_off" else {}
    jt = j_eb.init_tables(jax.random.PRNGKey(1), jb)
    tt = convert.tables_from_numpy(jt, "cpu")
    idx = _idx((4, 3, 8), 512)
    j_eng = j_engine.compile(j_engine.plan(j_engine.EngineSpec.from_bags(jb, **kw)))
    t_eng = t_engine.compile(t_engine.plan(t_engine.EngineSpec.from_bags(tb, **kw)))
    assert t_eng.plan.backend == j_eng.plan.backend == "pertable"
    _close(t_eng.lookup(tt, torch.from_numpy(idx)), j_eng.lookup(jt, jnp.asarray(idx)), **TOL)
    with pytest.raises(NotImplementedError, match="ragged"):
        t_eng.lookup(tt, torch.from_numpy(idx), lengths=torch.ones((4, 3), dtype=torch.int32))


@pytest.mark.parametrize("kind", ["dense", "qr_add", "tt"])
def test_lookup_ragged_matches_repro(kind):
    jb, tb = _bags(kind)
    jb = [dataclasses.replace(b, combiner=c) for b, c in zip(jb, ("sum", "mean", "mean"))]
    tb = [dataclasses.replace(b, combiner=c) for b, c in zip(tb, ("sum", "mean", "mean"))]
    jt = j_eb.init_tables(jax.random.PRNGKey(2), jb)
    tt = convert.tables_from_numpy(jt, "cpu")
    idx = _idx((4, 3, 8), 1024)
    lengths = np.array([[8, 3, 0], [1, 8, 5], [0, 0, 2], [4, 7, 8]], np.int32)
    j_eng = j_engine.compile(j_engine.plan(j_engine.EngineSpec.from_bags(jb)))
    t_eng = t_engine.compile(t_engine.plan(t_engine.EngineSpec.from_bags(tb)))
    got = t_eng.lookup(tt, torch.from_numpy(idx), lengths=torch.from_numpy(lengths))
    _close(got, j_eng.lookup(jt, jnp.asarray(idx), lengths=jnp.asarray(lengths)), **TOL)
    assert float(got[2, 0].abs().max()) == 0.0          # an empty bag pools to zero


def test_lookup_on_cpu_keeps_autograd():
    """On the CPU the plain versions are torch ops: gradients reach the
    tables (on the card ``lookup`` refuses tables that require grad)."""
    _, tb = _bags("qr_add")
    tt = t_eb.init_tables(tb, generator=torch.Generator().manual_seed(0), device="cpu")
    for t in tt:
        t["q"].requires_grad_(True)
    eng = t_engine.engine_for(t_engine.EngineSpec.from_bags(tb))
    eng.lookup(tt, torch.from_numpy(_idx((2, 3, 8), 1024))).square().sum().backward()
    assert all(float(t["q"].grad.abs().max()) > 0 for t in tt)


# ---------------------------------------------------------------------------
# the hashed branches of the planners
# ---------------------------------------------------------------------------

def test_hashed_planners_match_repro():
    je, te = _embs("hashed", vocab=4096, dim=32, hashed_rows=300, hashed_k=2)
    trace = j_syn.zipf_trace(4096, 4_000, seed=3).reshape(-1, 8)
    jt, tt = j_gnr.subtable_traces(trace, je), t_gnr.subtable_traces(trace, te)
    assert jt.keys() == tt.keys() == {"table"}
    np.testing.assert_array_equal(tt["table"][0], np.asarray(jt["table"][0]))
    assert tt["table"][1:] == jt["table"][1:]
    jl, tl = j_gnr.analyze_table(trace, je)["table"], t_gnr.analyze_table(trace, te)["table"]
    np.testing.assert_array_equal(tl.touches, jl.touches)
    np.testing.assert_array_equal(tl.bags, jl.bags)
    assert tl.mean_intra_reuse == jl.mean_intra_reuse
    counts = j_place.profile_counts(trace.reshape(-1), 4096)
    for budget in (0, 20_000, 2**20):
        jp = j_dup.plan_duplication([j_eb.BagConfig(emb=je)], [counts], num_shards=4,
                                    budget_bytes=budget)
        tp = t_dup.plan_duplication([t_eb.BagConfig(emb=te)], [counts], num_shards=4,
                                    budget_bytes=budget)
        assert tp.replicated_bytes == jp.replicated_bytes
        a, b = tp.tables[0], jp.tables[0]
        assert (a.hot_plan.num_hot, a.comm_free, a.local_share) == \
            (b.hot_plan.num_hot, b.comm_free, b.local_share)
    jb, tb = _bags("hashed", vocab=4096, hashed_rows=300)
    traces = [j_syn.zipf_trace(4096, 2_000, seed=t) for t in range(3)]
    jplan = j_engine.plan(j_engine.EngineSpec.from_bags(jb, cache_slots=16,
                                                        duplication=True),
                          num_shards=2, trace=traces)
    tplan = t_engine.plan(t_engine.EngineSpec.from_bags(tb, cache_slots=16,
                                                        duplication=True),
                          traces, num_shards=2)
    assert tplan.summary() == jplan.summary()


# ---------------------------------------------------------------------------
# the examples, on the CPU
# ---------------------------------------------------------------------------

def test_quickstart_runs_on_cpu(capsys):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "(63.7x compression" in out and "quickstart done." in out
    assert res["summary"]["backend"] == "packed"
    assert _all_launches() == 0


def test_cache_plan_matches_repro_pipeline():
    """The example's scheduler numbers equal ``repro``'s scheduler on the
    same traces (``examples/cache_plan.py``'s steps, run with ``repro``'s
    modules)."""
    res = cache_plan.main(["--device", "cpu"])
    emb = j_qe.EmbeddingConfig(vocab=65_536, dim=128, kind="qr", collision=32,
                               param_dtype=jnp.float32, compute_dtype=jnp.float32)
    trace = j_syn.zipf_trace(emb.vocab, 64_000, alpha=1.05, seed=0)
    locs = j_gnr.analyze_table(trace.reshape(-1, 16), emb)
    assert res["reuse"] == {k: round(v.mean_intra_reuse, 2) for k, v in locs.items()}
    plan = j_dup.plan_duplication([j_eb.BagConfig(emb=emb, pooling=16)],
                                  [j_place.profile_counts(trace, emb.vocab)],
                                  num_shards=8, budget_bytes=2**20)
    assert res["replicated_bytes"] == plan.tables[0].replicated_bytes
    assert res["hot_rows"] == plan.tables[0].hot_plan.num_hot
    sched = JSched(emb.qr_spec.q_rows, num_slots=512, value=locs["q"].prefetch_value())
    batches = [j_syn.zipf_trace(emb.vocab, 64 * 16, seed=1, step=s).reshape(-1, 16)
               for s in range(4)]
    sched.prefetch(batches[0] // 32)
    for s, idx in enumerate(batches):
        sched.slots_for(idx // 32)
        if s + 1 < len(batches):
            sched.prefetch(batches[s + 1] // 32)
    st = sched.stats
    assert (res["batches"], res["hit_rate"], res["staged_per_batch"]) == \
        (st.batches, st.hit_rate, st.staged_per_batch)
    assert res["traffic"] == st.traffic_bytes(128 * 4)
    assert _all_launches() == 0
