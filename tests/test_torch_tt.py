"""Port parity of the TT slice: the TT index math and specs, the TT layout
and planner pieces, the TT-bag kernel modules (K2 ``packed_tt_bag``, K5
``tt_bag``) and ``tt_embedding.lookup``.

Host-side numbers (specs, factors, streams, plans) equal ``repro``'s bit for
bit.  On the CPU the kernel wrappers take their plain versions, held
against ``repro``'s Pallas kernels in interpret mode at fp32 rtol = atol =
1e-5 (the products round in another order), with cores at the init scale.
The bf16 lookup is held at the bf16 tolerance of ``test_torch_serve.py``.
The CUDA kernels are held against the plain versions on the card in
``test_torch_gpu.py``."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.core import packed_tables as j_pt  # noqa: E402
from repro.core import placement as j_place  # noqa: E402
from repro.core import qr_embedding as j_qe  # noqa: E402
from repro.core import tt_embedding as j_tt  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.engine import EngineSpec as JSpec  # noqa: E402
from repro.engine import plan as j_plan  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import packed_gather as j_pg  # noqa: E402
from repro.kernels import tt_gather as j_tg  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import packed_tables as t_pt  # noqa: E402
from repro_torch.core import placement as t_place  # noqa: E402
from repro_torch.core import qr_embedding as t_qe  # noqa: E402
from repro_torch.core import tt_embedding as t_tt  # noqa: E402
from repro_torch.engine import EngineSpec as TSpec  # noqa: E402
from repro_torch.engine import plan as t_plan  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import packed_gather as t_pg  # noqa: E402
from repro_torch.kernels import tt_gather as t_tg  # noqa: E402
from repro_torch.models import dlrm as t_dlrm  # noqa: E402
from torch_tt_inputs import (  # noqa: E402
    CASES, DLRM_DIMS, SMOKE_DIMS, packed_tt_args, packed_tt_inputs, tt_args, tt_inputs,
)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)          # as in test_torch_serve.py
TT_ARCHS = ["dlrm-tt", "dlrm-tt-smoke"]
SPEC_PROPS = ("v1", "v2", "v3", "d1", "d2", "d3", "padded_vocab", "g1_width",
              "g2_width", "g3_width", "g2_rows_padded", "compression")


def _embs(arch):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    return j_dlrm.make_bags(jc)[0].emb, t_dlrm.make_bags(tc)[0].emb


def _same_spec(ts, js):
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    for p in SPEC_PROPS:
        assert getattr(ts, p) == getattr(js, p), p
    assert ts.param_count() == js.param_count()
    assert ts.sram_bytes() == js.sram_bytes()
    assert ts.streamed_bytes_per_lookup() == js.streamed_bytes_per_lookup()


# ---------------------------------------------------------------------------
# specs and index math, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TT_ARCHS)
def test_config_tt_spec_bitwise(arch):
    je, te = _embs(arch)
    _same_spec(te.tt_spec, je.tt_spec)
    assert te.param_count() == je.param_count()
    if arch == "dlrm-tt":
        assert te.tt_spec.vocab_factors == (38, 1386, 38)
        assert te.tt_spec.dims == (4, 8, 4, 16) and te.tt_spec.g2_width == 2048


@pytest.mark.parametrize("vocab,dim,rank", [(4096, 32, 4), (2_000_000, 128, 16),
                                            (1000, 24, 8), (51_866, 64, 16),
                                            (97, 12, 2)])
def test_factors_and_spec_bitwise(vocab, dim, rank):
    assert t_tt.vocab_factors3(vocab) == j_tt.vocab_factors3(vocab)
    assert t_tt.dim_factors3(dim) == j_tt.dim_factors3(dim)
    je = j_qe.EmbeddingConfig(vocab=vocab, dim=dim, kind="tt", tt_rank=rank)
    te = t_qe.EmbeddingConfig(vocab=vocab, dim=dim, kind="tt", tt_rank=rank)
    _same_spec(t_tt.spec_for(te), j_tt.spec_for(je))


def test_spec_rejects_what_repro_rejects():
    for kw in (dict(vocab_factors=(2, 2, 2), dim_factors=(2, 2, 2)),    # 8 < vocab
               dict(vocab_factors=(4, 4, 4), dim_factors=(2, 2, 3))):   # 12 != dim
        with pytest.raises(ValueError):
            j_tt.TTSpec(vocab=10, dim=8, rank=2, **kw)
        with pytest.raises(ValueError):
            t_tt.TTSpec(vocab=10, dim=8, rank=2, **kw)


def test_tt_decompose_bitwise():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2_000_000, (5, 4, 8)).astype(np.int32)
    spec = _embs("dlrm-tt")[1].tt_spec
    expect = [np.asarray(a) for a in j_tt.tt_decompose_factors(jnp.asarray(idx), 1386, 38)]
    for got in (t_tt.tt_decompose_factors(idx, 1386, 38),
                t_tt.tt_decompose_factors(idx.astype(np.int64), 1386, 38),
                [a.numpy() for a in t_tt.tt_decompose_factors(torch.from_numpy(idx), 1386, 38)],
                [a.numpy() for a in t_tt.tt_decompose(torch.from_numpy(idx).long(), spec)]):
        for a, b in zip(got, expect):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", TT_ARCHS)
def test_tt_layout_and_pack_params_bitwise(arch):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    budgets = list(range(3, 3 + jc.num_tables))
    jl = j_pt.build_layout(j_dlrm.make_bags(jc), budgets)
    tl = t_pt.build_layout(t_dlrm.make_bags(tc), budgets)
    for f in dataclasses.fields(jl):
        assert getattr(tl, f.name) == getattr(jl, f.name), f.name
    assert tl.big_width == jl.big_width and tl.zero_row == jl.zero_row
    if arch == "dlrm-tt":
        assert tl.total_rows == 36_608 and tl.big_width == 2048
        return
    params, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(2), jc)
    tables_np = jax.tree.map(np.asarray, params["tables"])
    tp = convert.params_from_numpy({"bottom": [], "top": [], "tables": tables_np}, "cpu")
    jpk = j_pt.pack_params(params["tables"], jl)
    tpk = t_pt.pack_params(tp["tables"], tl)
    assert sorted(tpk) == sorted(jpk) == ["g1", "g2", "g3"]
    for k in jpk:
        assert tpk[k].dtype == torch.float32
        np.testing.assert_array_equal(tpk[k].numpy(), np.asarray(jpk[k]))
    assert not tpk["g2"][-1].any()


# ---------------------------------------------------------------------------
# planner pieces and the offline plan, dlrm-tt at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width_traces():
    cfg = j_registry.get_dlrm("dlrm-tt")
    return [j_syn.zipf_trace(cfg.vocab_per_table, 4_096, seed=7 + t)
            for t in range(cfg.num_tables)]


def test_fold_counts_tt_bitwise(full_width_traces):
    je, te = _embs("dlrm-tt")
    counts = t_place.profile_counts(full_width_traces[0], te.vocab)
    got = t_place.fold_counts_tt(counts, te.tt_spec)
    np.testing.assert_array_equal(got, j_place.fold_counts_tt(counts, je.tt_spec))
    assert got.shape == (1386,) and got.sum() == 4_096


@pytest.mark.parametrize("arch", TT_ARCHS)
def test_tt_plan_summary_and_duplication_bitwise(arch, full_width_traces):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    traces = (full_width_traces if arch == "dlrm-tt" else
              [j_syn.zipf_trace(jc.vocab_per_table, 4_096, seed=7 + t)
               for t in range(jc.num_tables)])
    jp = j_plan(JSpec.from_dlrm(jc, serving=True), num_shards=4, trace=traces)
    tp = t_plan(TSpec.from_dlrm(tc, serving=True), traces, num_shards=4)
    assert tp.summary() == jp.summary()
    assert tp.slot_budgets == jp.slot_budgets
    if arch == "dlrm-tt":
        assert sum(tp.slot_budgets) == 1024          # 8 MiB of 8 KiB G2 rows
    for tt_, jt in zip(tp.dup.tables, jp.dup.tables):
        assert (tt_.big, tt_.touches_per_lookup, tt_.cache_slots) == (
            jt.big, jt.touches_per_lookup, jt.cache_slots)
        assert [dataclasses.asdict(d) for d in tt_.decisions] == [
            dataclasses.asdict(d) for d in jt.decisions]
        np.testing.assert_array_equal(tt_.hot_plan.hot_rows, jt.hot_plan.hot_rows)
        assert tt_.local_share == jt.local_share
    for a, b in zip(tp.values, jp.values):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# K2 and K5 modules against repro's Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dims", [SMOKE_DIMS, DLRM_DIMS])
def test_packed_tt_bag_matches_repro(case, dims):
    shape = dict(g=12, k=8) if dims == SMOKE_DIMS else dict(g=4, k=5)
    a = packed_tt_inputs(case, dims=dims, seed=len(case), **shape)
    t_pg.reset_launches()
    got = t_pg.packed_tt_bag(*packed_tt_args(a, torch.from_numpy), dims=dims)
    expect = j_pg.packed_tt_bag(*packed_tt_args(a, jnp.asarray), dims=dims,
                                interpret=True)
    assert got.dtype == torch.float32 and got.shape == (shape["g"], dims[0] * dims[1] * dims[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    assert t_pg.LAUNCHES["packed_tt_bag"] == 0      # the plain version ran


@pytest.mark.parametrize("dims,k", [(SMOKE_DIMS, 8), (DLRM_DIMS, 3), (SMOKE_DIMS, 1)])
def test_tt_bag_matches_repro(dims, k):
    a = tt_inputs(dims=dims, k=k, b=10 if dims == SMOKE_DIMS else 3, seed=k)
    t_tg.reset_launches()
    got = t_tg.tt_bag(*tt_args(a, torch.from_numpy), dims=dims)
    expect = j_tg.tt_bag(*tt_args(a, jnp.asarray), dims=dims, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)
    assert t_tg.LAUNCHES["tt_bag"] == 0
    # the ops entries: K5 through tt_pooled_auto, and the plain version
    for mode in ("pallas", "jnp"):
        out = t_ops.tt_pooled_auto(*tt_args(a, torch.from_numpy), dims=dims, exec_mode=mode)
        np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_tt_lookup_matches_repro():
    a = tt_inputs(dims=SMOKE_DIMS, b=3, k=4, seed=4)
    i = [a[n].reshape(2, 6) for n in ("i1", "i2", "i3")]
    got = t_ops.tt_lookup(*(torch.from_numpy(x) for x in [a["g1"], a["g2"], a["g3"], *i]),
                          dims=SMOKE_DIMS)
    expect = j_ops.tt_lookup(*(jnp.asarray(x) for x in [a["g1"], a["g2"], a["g3"], *i]),
                             dims=SMOKE_DIMS, interpret=True)
    assert got.shape == (2, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


# ---------------------------------------------------------------------------
# tt_embedding: init, lookup, materialize
# ---------------------------------------------------------------------------

def _tt_cfgs(compute):
    kw = dict(vocab=4096, dim=32, kind="tt", tt_rank=4, tt_exec="pallas")
    return (j_qe.EmbeddingConfig(**kw, compute_dtype=getattr(jnp, compute)),
            t_qe.EmbeddingConfig(**kw, compute_dtype=getattr(torch, compute)))


def test_init_shapes_and_scale_match_repro():
    jcfg, tcfg = _tt_cfgs("bfloat16")
    g = torch.Generator().manual_seed(0)
    tp = t_qe.init(tcfg, generator=g, device=torch.device("cpu"))
    jp = j_qe.init(jax.random.PRNGKey(0), jcfg)
    scale = (32 * 4 ** 2) ** (-1.0 / 6.0)
    for k in ("g1", "g2", "g3"):
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32
        assert abs(float(tp[k].std()) - scale) < 0.15 * scale


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_lookup_matches_repro_kernel(compute):
    """Against what ``repro`` computes on the TPU: its Pallas kernel (here
    in interpret mode) cast to the compute dtype."""
    jcfg, tcfg = _tt_cfgs(compute)
    params = j_qe.init(jax.random.PRNGKey(5), jcfg)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    idx = np.random.default_rng(6).integers(0, 4096, (3, 7)).astype(np.int32)
    spec = jcfg.tt_spec
    i1, i2, i3 = j_tt.tt_decompose(jnp.asarray(idx), spec)
    expect = j_ops.tt_pooled_auto(
        params["g1"], params["g2"], params["g3"],
        i1.reshape(-1, 1), i2.reshape(-1, 1), i3.reshape(-1, 1),
        dims=(spec.d1, spec.d2, spec.d3, spec.rank), exec_mode="pallas", interpret=True,
    ).reshape(3, 7, 32).astype(jcfg.compute_dtype)
    got = t_tt.lookup(tparams, torch.from_numpy(idx), tcfg)
    assert got.dtype == tcfg.compute_dtype and got.shape == (3, 7, 32)
    tol = TOL if compute == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), **tol)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_lookup_and_materialize_match_repro_cpu(compute):
    """Against ``repro``'s CPU lookup, which contracts in the compute dtype."""
    jcfg, tcfg = _tt_cfgs(compute)
    params = j_qe.init(jax.random.PRNGKey(7), jcfg)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    idx = np.random.default_rng(8).integers(0, 4096, (9, 8)).astype(np.int32)
    tol = TOL if compute == "float32" else BF16_TOL
    got = t_tt.lookup(tparams, torch.from_numpy(idx), tcfg)
    expect = j_tt.lookup(params, jnp.asarray(idx), jcfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), **tol)
    full = t_tt.materialize(tparams, tcfg)
    assert full.shape == (4096, 32)
    np.testing.assert_allclose(full.float().numpy(),
                               np.asarray(j_tt.materialize(params, jcfg), np.float32), **tol)
