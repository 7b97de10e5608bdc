"""Port parity, host side: traces, QR index math, packed layout and streams,
the offline plan and the prefetch schedulers equal ``repro``'s bit for bit;
the port's batch sampler follows ``repro``'s law; entry points need a card
unless the caller asks for the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core import hashing as j_hashing  # noqa: E402
from repro.core import packed_tables as j_pt  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.engine import EngineSpec as JSpec  # noqa: E402
from repro.engine import plan as j_plan  # noqa: E402
from repro.launch import serve_rec as j_serve  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import hashing as t_hashing  # noqa: E402
from repro_torch.core import packed_tables as t_pt  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.engine import EngineSpec as TSpec  # noqa: E402
from repro_torch.engine import plan as t_plan  # noqa: E402
from repro_torch.launch import serve_rec as t_serve  # noqa: E402
from repro_torch.models import dlrm as t_dlrm  # noqa: E402

ARCHS = ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"]


def _cfgs(arch):
    return j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)


def _traces(cfg, seed=0, n=5_000):
    return [j_syn.zipf_trace(cfg.vocab_per_table, n, seed=seed + 7 + t)
            for t in range(cfg.num_tables)]


# ---------------------------------------------------------------------------
# configs, traces, QR index math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["dlrm-qr", "dlrm-dense", "dlrm-tt", *ARCHS])
def test_configs_match(arch):
    jc, tc = _cfgs(arch)
    for f in dataclasses.fields(jc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.pdtype == torch.float32 and tc.cdtype == torch.bfloat16


def test_hashed_kind_still_raises():
    """Hashed tables have only a per-table path: packing them still raises,
    as ``repro``'s ``packable`` refuses them, while init, the locality trace
    and the duplication planner now serve them (their numbers against
    ``repro``'s are in ``test_torch_pertable.py``)."""
    from repro_torch.cache import duplication, intra_gnr
    from repro_torch.core import embedding_bag, qr_embedding

    emb = qr_embedding.EmbeddingConfig(vocab=1000, dim=8, kind="hashed")
    bags = [embedding_bag.BagConfig(emb=emb)]
    assert not t_pt.packable(bags)
    with pytest.raises(ValueError, match="not uniform enough to pack"):
        t_pt.build_layout(bags)
    params = qr_embedding.init(emb, generator=torch.Generator(), device="cpu")
    assert params["table"].shape == (128, 8)                 # 15 rows, padded
    trace, rows, _rb = intra_gnr.subtable_traces(np.zeros((2, 4), np.int32), emb)["table"]
    assert trace.shape == (2, 8) and rows == 15              # k = 2 rows per index
    plan = duplication.plan_duplication(bags, [np.ones(1000, np.int64)])
    assert plan.tables[0].hot_plan.num_hot == 15             # every row fits the budget


def test_zipf_probs_and_trace_bitwise():
    np.testing.assert_array_equal(t_syn.zipf_probs(4096, 1.05), j_syn.zipf_probs(4096, 1.05))
    a = t_syn.zipf_trace(4096, 3000, alpha=1.2, seed=3, step=2)
    b = j_syn.zipf_trace(4096, 3000, alpha=1.2, seed=3, step=2)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_qr_spec_and_decompose_bitwise():
    for vocab, c in [(4096, 8), (2_000_000, 64), (1000, 7)]:
        js, ts = j_hashing.QRSpec(vocab, c, 32), t_hashing.QRSpec(vocab, c, 32)
        assert (ts.q_rows, ts.r_rows, ts.compression, ts.lut_bytes()) == (
            js.q_rows, js.r_rows, js.compression, js.lut_bytes())
    idx = np.random.default_rng(0).integers(0, 2_000_000, (5, 4, 8)).astype(np.int32)
    jq, jr = (np.asarray(a) for a in j_hashing.qr_decompose(jnp.asarray(idx), 64))
    nq, nr = t_hashing.qr_decompose(idx, 64)
    tq, tr = t_hashing.qr_decompose(torch.from_numpy(idx), 64)
    for a in (nq, tq.numpy()):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, jq)
    for a in (nr, tr.numpy()):
        np.testing.assert_array_equal(a, jr)


# ---------------------------------------------------------------------------
# packed layout and streams
# ---------------------------------------------------------------------------

LAYOUT_PROPS = ("row_offsets", "total_rows", "zero_row", "big_width", "small_offsets",
                "total_small", "small_zero_row", "slot_offsets", "total_slots")


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_layout_fields_bitwise(arch):
    jc, tc = _cfgs(arch)
    budgets = [5, 9, 3, 7]
    jl = j_pt.build_layout(j_dlrm.make_bags(jc), budgets)
    tl = t_pt.build_layout(t_dlrm.make_bags(tc), budgets)
    for f in dataclasses.fields(jl):
        assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    for p in LAYOUT_PROPS:
        assert getattr(tl, p) == getattr(jl, p), p


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("ragged", [False, True])
def test_pack_streams_bitwise(arch, ragged):
    jc, tc = _cfgs(arch)
    budgets = [5, 9, 3, 7]
    jl = j_pt.build_layout(j_dlrm.make_bags(jc), budgets)
    tl = t_pt.build_layout(t_dlrm.make_bags(tc), budgets)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, jc.vocab_per_table, (6, 4, 8)).astype(np.int32)
    lengths = rng.integers(0, 9, (6, 4)).astype(np.int32) if ragged else None
    js = j_pt.pack_indices(jnp.asarray(idx), jl,
                           lengths=None if lengths is None else jnp.asarray(lengths))
    ts = t_pt.pack_indices(torch.from_numpy(idx), tl,
                           lengths=None if lengths is None else torch.from_numpy(lengths))
    assert sorted(js) == sorted(ts)
    for k in js:
        assert ts[k].dtype == torch.int32
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
    slot = rng.integers(-1, 3, (6, 4, 8)).astype(np.int32)
    np.testing.assert_array_equal(
        t_pt.global_slots(torch.from_numpy(slot), tl).numpy(),
        np.asarray(j_pt.global_slots(jnp.asarray(slot), jl)))
    rows = [rng.integers(0, 50, b).astype(np.int32) for b in budgets]
    np.testing.assert_array_equal(t_pt.packed_cache_rows(rows, tl),
                                  j_pt.packed_cache_rows(rows, jl))
    np.testing.assert_array_equal(t_pt.miss_slots(torch.from_numpy(idx)).numpy(),
                                  np.asarray(j_pt.miss_slots(jnp.asarray(idx))))
    np.testing.assert_array_equal(t_pt.dummy_cache(tl, torch.float32, "cpu").numpy(),
                                  np.asarray(j_pt.dummy_cache(jl, jnp.float32)))


# ---------------------------------------------------------------------------
# offline plan and prefetch schedulers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plan_and_schedulers_bitwise(arch):
    jc, tc = _cfgs(arch)
    traces = _traces(jc)
    jp = j_plan(JSpec.from_dlrm(jc, serving=True), num_shards=4, trace=traces)
    tp = t_plan(TSpec.from_dlrm(tc, serving=True), traces, num_shards=4)
    assert tp.slot_budgets == jp.slot_budgets
    assert tp.comm_free == jp.comm_free
    assert tp.summary() == jp.summary()
    assert tp.dup.replicated_bytes == jp.dup.replicated_bytes
    for a, b in zip(tp.values, jp.values):
        np.testing.assert_array_equal(a, b)

    js, ts = jp.fresh_schedulers(), tp.fresh_schedulers()
    emb_j, emb_t = jp.bags[0].emb, tp.bags[0].emb
    for step in range(4):
        idx = np.asarray(j_syn.dlrm_batch(jc, 8, seed=0, step=step)["idx"])
        for t in range(jc.num_tables):
            rj = j_serve.big_rows(idx[:, t], emb_j)
            rt = t_serve.big_rows(idx[:, t], emb_t)
            np.testing.assert_array_equal(rt, rj)
            assert ts[t].prefetch(rt) == js[t].prefetch(rj)
            np.testing.assert_array_equal(ts[t].slots_for(rt), js[t].slots_for(rj))
            np.testing.assert_array_equal(ts[t].cache_rows(), js[t].cache_rows())
    for a, b in zip(ts, js):
        assert dataclasses.asdict(a.stats) == dataclasses.asdict(b.stats)


@pytest.mark.parametrize("arch", ARCHS)
def test_planner_pieces_bitwise(arch):
    """The host planners outside plan()'s default path equal repro's too."""
    from repro.cache import intra_gnr as j_gnr
    from repro.core import placement as j_place
    from repro_torch.cache import intra_gnr as t_gnr
    from repro_torch.core import placement as t_place

    jc, tc = _cfgs(arch)
    trace = _traces(jc, seed=3)[0][: 4096].reshape(-1, jc.pooling)
    emb_j, emb_t = j_dlrm.make_bags(jc)[0].emb, t_dlrm.make_bags(tc)[0].emb
    jl, tl = j_gnr.analyze_table(trace, emb_j), t_gnr.analyze_table(trace, emb_t)
    assert sorted(jl) == sorted(tl)
    for name in jl:
        for f in ("touches", "bags"):
            np.testing.assert_array_equal(getattr(tl[name], f), getattr(jl[name], f))
        assert tl[name].mean_intra_reuse == jl[name].mean_intra_reuse
        np.testing.assert_array_equal(t_gnr.rank_prefetch(tl[name]),
                                      j_gnr.rank_prefetch(jl[name]))
    values = [tl[n].prefetch_value() for n in sorted(tl)]
    assert t_gnr.split_slot_budget(values, 100) == j_gnr.split_slot_budget(values, 100)
    counts = t_place.profile_counts(trace, jc.vocab_per_table)
    np.testing.assert_array_equal(counts, j_place.profile_counts(trace, jc.vocab_per_table))
    share = t_place.bandwidth_balanced_fraction(counts=counts)
    assert share == j_place.bandwidth_balanced_fraction(counts=counts)
    for kw in ({"request_share": share}, {"hot_fraction": 0.1}, {"max_hot_rows": 7}):
        a, b = t_place.plan_tiers(counts, **kw), j_place.plan_tiers(counts, **kw)
        np.testing.assert_array_equal(a.hot_rows, b.hot_rows)
        np.testing.assert_array_equal(a.hot_slot, b.hot_slot)
        assert (a.hot_fraction, a.expected_hot_hit) == (b.hot_fraction, b.expected_hot_hit)


# ---------------------------------------------------------------------------
# the port's batch sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,alpha", [(4096, 1.05), (2_000_000, 1.05), (50_000, 1.3)])
def test_zipf_from_uniform_follows_repro(vocab, alpha):
    shape = (64, 26, 32)
    u = jax.random.uniform(j_syn._key(5, 3, 2), shape, jnp.float32, 1e-6, 1.0)
    expect = np.asarray(j_syn.zipf_batch_jax(vocab, shape, alpha=alpha, seed=5, step=3))
    got = t_syn.zipf_from_uniform(torch.from_numpy(np.array(u)), vocab, alpha).numpy()
    assert got.dtype == np.int32 and got.shape == shape
    assert got.min() >= 0 and got.max() < vocab
    assert (got == expect).mean() >= 0.999


def test_dlrm_batch_shapes_range_and_determinism():
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    a = t_syn.dlrm_batch(cfg, 16, seed=2, step=1)
    b = t_syn.dlrm_batch(cfg, 16, seed=2, step=1)
    c = t_syn.dlrm_batch(cfg, 16, seed=2, step=2)
    assert a["dense"].shape == (16, cfg.num_dense) and a["dense"].dtype == torch.float32
    assert a["idx"].shape == (16, cfg.num_tables, cfg.pooling)
    assert a["idx"].dtype == torch.int32
    assert int(a["idx"].min()) >= 0 and int(a["idx"].max()) < cfg.vocab_per_table
    assert set(a["labels"].unique().tolist()) <= {0.0, 1.0}
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["idx"], c["idx"])


# ---------------------------------------------------------------------------
# entry points need the card unless asked for the CPU
# ---------------------------------------------------------------------------

def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    calls = [
        lambda: t_dlrm.init_dlrm(cfg),
        lambda: t_serve.build_serve_state(cfg, shards=4, alpha=1.05, seed=0),
        lambda: t_serve.run_pipeline(cfg, batch=2, batches=2),
        lambda: t_serve.main(["--arch", "dlrm-qr", "--smoke"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert t_dlrm.init_dlrm(cfg, device="cpu")["tables"][0]["q"].device.type == "cpu"
