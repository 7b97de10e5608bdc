"""Port parity of the tuner slice: ``sram_cache.simulate``, the knob space,
the cost model's features, the trace profile, ``Tuner`` ranking, ``fit``
and its wiring into ``engine.plan`` and ``build_serve_state``.

The same numpy traces go through ``repro`` and the port.  Exact: the knob
space (as ``describe()`` dicts), slot budgets, ``TraceProfile`` fields and
hit statistics, ``simulate``'s statistics, plan summaries.  The features
and a tuner's predictions agree to rtol 1e-12 (the same float64 sums in
the same order; 1e-12 leaves room for a library's summation order).
``repro``'s fitted models (its ``hlo`` mode) are carried across through
``describe()`` JSON, so both tuners rank with the same coefficients.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

from repro import engine as j_engine  # noqa: E402
from repro import tune as j_tune  # noqa: E402
from repro.cache import sram_cache as j_sram  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch import tune as t_tune  # noqa: E402
from repro_torch.cache import sram_cache as t_sram  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data.synthetic import zipf_trace  # noqa: E402
from repro_torch.launch import serve_rec as t_serve  # noqa: E402
from repro_torch.tune import tuner as t_tuner  # noqa: E402

ARCHS = ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"]
RTOL = 1e-12


def _specs(arch, **kw):
    """The serving spec of ``arch`` in both packages (duplication on)."""
    j = j_engine.EngineSpec.from_dlrm(j_registry.get_dlrm(arch), serving=True)
    t = t_engine.EngineSpec.from_dlrm(t_registry.get_dlrm(arch), serving=True)
    return (j.replace(**kw), t.replace(**kw)) if kw else (j, t)


def _traces(spec, n=4096):
    return [zipf_trace(b.emb.vocab, n, seed=t) for t, b in enumerate(spec.bags)]


def _described(space):
    return [k.describe() for k in space]


# ---------------------------------------------------------------------------
# simulate, knob space, budgets, features, profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots,value", [(16, False), (64, True), (1, True)])
def test_simulate_equals_repro(slots, value):
    rng = np.random.default_rng(slots)
    batches = [zipf_trace(512, 64, seed=s).reshape(-1) for s in range(6)]
    v = rng.random(512) if value else None
    a = j_sram.simulate(batches, 512, slots, v)
    b = t_sram.simulate(batches, 512, slots, v)
    assert (a.accesses, a.hits, a.batches, a.staged_rows, a.kept_rows) == (
        b.accesses, b.hits, b.batches, b.staged_rows, b.kept_rows)
    assert a.hit_rate == b.hit_rate and a.staged_per_batch == b.staged_per_batch


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("packable", [True, False])
@pytest.mark.parametrize("dup", [True, False])
def test_knob_space_equals_repro(arch, packable, dup):
    js, ts = _specs(arch, duplication=dup)
    a = j_tune.knob_space(js, packable=packable)
    b = t_tune.knob_space(ts, packable=packable)
    assert _described(a) == _described(b)
    assert b[0] == t_tune.default_knobs(ts, packable=packable)
    assert len(set(b)) == len(b)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_budgets_equal_repro(arch):
    js, ts = _specs(arch)
    values = [np.arange(40, dtype=np.float64) * (t + 1) % 7
              for t in range(js.num_tables)]
    for jk, tk in zip(j_tune.knob_space(js, packable=True),
                      t_tune.knob_space(ts, packable=True)):
        for v in (None, values):
            assert (j_tune.slot_budgets(js, jk, v)
                    == t_tune.slot_budgets(ts, tk, v))


@pytest.fixture(scope="module", params=ARCHS)
def profiles(request):
    """Both packages' trace profiles of one smoke config, 1 and 4 shards."""
    js, ts = _specs(request.param)
    traces = _traces(js)
    out = {"arch": request.param, "specs": (js, ts), "traces": traces}
    for shards in (1, 4):
        out[shards] = (
            j_tune.TraceProfile.from_trace(js, traces, batch=16, num_shards=shards),
            t_tune.TraceProfile.from_trace(ts, traces, batch=16, num_shards=shards),
        )
    return out


def test_trace_profile_equals_repro(profiles):
    jp, tp = profiles[4]
    assert (jp.batch, jp.num_shards, jp.dim) == (tp.batch, tp.num_shards, tp.dim)
    for a, b in zip(jp.tables, tp.tables):
        assert (a.rows, a.row_bytes, a.width_elems, a.accesses_per_batch) == (
            b.rows, b.row_bytes, b.width_elems, b.accesses_per_batch)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.values, b.values)
        assert len(a.batches) == len(b.batches)
        for x, y in zip(a.batches, b.batches):
            np.testing.assert_array_equal(x, y)
    for t in range(len(jp.tables)):
        for slots in (0, 1, 8, 64, 1000):
            assert jp.hit_stats(t, slots) == tp.hit_stats(t, slots)


@pytest.mark.parametrize("shards", [1, 4])
def test_plan_features_equal_repro(profiles, shards):
    js, ts = profiles["specs"]
    jp, tp = profiles[shards]
    for jk, tk in zip(j_tune.knob_space(js, packable=True),
                      t_tune.knob_space(ts, packable=True)):
        a = j_tune.plan_features(js, jk, jp)
        b = t_tune.plan_features(ts, tk, tp)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0)


def test_plan_features_track_knobs(profiles):
    _js, ts = profiles["specs"]
    _jp, prof = profiles[1]
    base = t_tune.default_knobs(ts, packable=True)
    f_base = t_tune.plan_features(ts, base, prof)
    assert f_base[0] == 1.0
    pt = t_tune.plan_features(ts, dataclasses.replace(base, backend="pertable"), prof)
    assert pt[0] == ts.num_tables
    none = t_tune.plan_features(ts, dataclasses.replace(base, cache_slots=0), prof)
    assert none[1] > f_base[1]


# ---------------------------------------------------------------------------
# plan(): knobs, tuner, summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_plan_summary_with_knobs_equals_repro(arch):
    js, ts = _specs(arch)
    traces = _traces(js)
    for jk, tk in list(zip(j_tune.knob_space(js, packable=True),
                           t_tune.knob_space(ts, packable=True)))[::3]:
        a = j_engine.plan(js, traces, num_shards=4, knobs=jk).summary()
        b = t_engine.plan(ts, traces, num_shards=4, knobs=tk).summary()
        assert a == b


def test_positional_trace_and_knob_identity():
    _js, ts = _specs("dlrm-qr-smoke", duplication=False)
    traces = _traces(ts)
    assert t_engine.plan(ts, traces) == t_engine.plan(ts, trace=traces)
    base = t_tune.default_knobs(ts, packable=True)
    halved = dataclasses.replace(base, cache_slots=base.cache_slots // 2)
    assert t_engine.plan(ts, traces, knobs=base) != t_engine.plan(ts, traces, knobs=halved)
    assert t_engine.plan(ts) == t_engine.plan(ts, knobs=base)
    # the plan keeps the trace's popularity counts (the re-planner pins on them)
    p = t_engine.plan(ts, traces)
    assert len(p.counts) == ts.num_tables and p.counts[0].sum() == traces[0].size


def test_packed_knobs_on_unpackable_spec_rejected():
    _js, ts = _specs("dlrm-qr-smoke", duplication=False)
    bags = (ts.bags[0],) + tuple(
        dataclasses.replace(b, emb=dataclasses.replace(b.emb, vocab=b.emb.vocab + 8))
        for b in ts.bags[1:])
    with pytest.raises(ValueError, match="not packable"):
        t_engine.plan(ts.replace(bags=bags),
                      knobs=t_tune.Knobs(dim_block=32, cache_slots=128, backend="packed"))
    p = t_engine.plan(ts, knobs=t_tune.Knobs(dim_block=32, backend="pertable"))
    assert not p.packed and p.layout is None


# ---------------------------------------------------------------------------
# Tuner ranking on repro's fitted models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_fit():
    """``repro``'s tuner (hlo mode) on dlrm-qr-smoke with duplication on and
    4 shards, and a port Tuner holding the same models (through their JSON
    form) against the port's own profile of the same traces."""
    js, ts = _specs("dlrm-qr-smoke")
    traces = _traces(js)
    jt = j_tune.fit(js, traces, mode="hlo", batch=8, num_shards=4, max_samples=3)
    models = {b: t_tune.KernelCostModel.from_json(json.loads(json.dumps(m.describe())))
              for b, m in jt.models.items()}
    tt = t_tune.Tuner(models=models,
                      profile=t_tune.TraceProfile.from_trace(ts, traces, batch=8,
                                                             num_shards=4),
                      source="analytic", metadata=t_tune.run_metadata("cpu"))
    return jt, tt, js, ts, traces


def test_tuner_rank_choose_predict_equal_repro(repro_fit):
    jt, tt, js, ts, traces = repro_fit
    for packable in (True, False):
        for backend in (None, "packed", "pertable"):
            if backend == "packed" and not packable:
                continue
            a = jt.rank(js, packable=packable, backend=backend)
            b = tt.rank(ts, packable=packable, backend=backend)
            assert _described(k for k, _ in a) == _described(k for k, _ in b)
            np.testing.assert_allclose([p for _, p in b], [p for _, p in a],
                                       rtol=RTOL, atol=0)
            assert (jt.choose(js, packable=packable, backend=backend).describe()
                    == tt.choose(ts, packable=packable, backend=backend).describe())
    for jk, tk in zip(j_tune.knob_space(js, packable=True),
                      t_tune.knob_space(ts, packable=True)):
        np.testing.assert_allclose(tt.predict(ts, tk), jt.predict(js, jk), rtol=RTOL)
    # the tuned plans agree
    assert (j_engine.plan(js, traces, num_shards=4, tuner=jt).summary()
            == t_engine.plan(ts, traces, num_shards=4, tuner=tt).summary())


def test_spec_digest_stable_and_distinct():
    _js, ts = _specs("dlrm-qr-smoke")
    assert t_tune.spec_digest(ts) == t_tune.spec_digest(ts)
    assert t_tune.spec_digest(ts) != t_tune.spec_digest(
        ts.replace(cache_slots=ts.cache_slots * 2))


# ---------------------------------------------------------------------------
# fit on the CPU: analytic mode, memo cache, mode errors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def analytic_fit(tmp_path_factory):
    _js, ts = _specs("dlrm-qr-smoke", duplication=False)
    traces = _traces(ts)
    cache = str(tmp_path_factory.mktemp("tuner") / "cache.json")
    tuner = t_tune.fit(ts, traces, mode="analytic", batch=8, max_samples=4,
                       cache_path=cache, device="cpu")
    return tuner, ts, traces, cache


def test_analytic_fit_models_and_choice(analytic_fit):
    tuner, ts, traces, _ = analytic_fit
    assert set(tuner.models) == {"packed", "pertable"}
    assert tuner.source == "analytic" and tuner.samples and not tuner.from_cache
    for m in tuner.models.values():
        assert any(c > 0 for c in m.coef)
    assert tuner.digest == t_tune.spec_digest(ts)
    assert tuner.metadata["device_kind"] == "cpu"
    assert {"backend", "device_kind", "torch_version", "cuda_version"} <= set(tuner.metadata)
    space = t_tune.knob_space(ts, packable=True)
    choice = tuner.choose(ts)
    assert choice in space
    p = t_engine.plan(ts, traces, tuner=tuner)
    assert p.knobs == choice
    assert tuner.choose(ts, backend="packed").backend == "packed"
    preds = [s for _k, s in tuner.rank(ts, packable=True)]
    assert preds == sorted(preds) and len(preds) == len(space)
    # every sample is a bound plus the launch overhead of its dispatches
    for s in tuner.samples:
        n = 1 if s.knobs.backend == "packed" else ts.num_tables
        assert s.measured_s > n * t_tuner.DISPATCH_OVERHEAD_S


def test_fit_memo_cache_roundtrip(analytic_fit):
    tuner, ts, traces, cache = analytic_fit
    again = t_tune.fit(ts, traces, mode="analytic", batch=8, max_samples=4,
                       cache_path=cache, device="cpu")
    assert again.from_cache and not again.samples
    for b in tuner.models:
        assert again.models[b].coef == pytest.approx(tuner.models[b].coef)
    assert (t_engine.plan(ts, traces, tuner=again).knobs
            == t_engine.plan(ts, traces, tuner=tuner).knobs)
    with open(cache) as f:
        keys = list(json.load(f))
    assert keys == [f"{tuner.digest}:cpu:analytic"]


def test_fit_modes():
    _js, ts = _specs("dlrm-qr-smoke", duplication=False)
    traces = _traces(ts, n=1024)
    with pytest.raises(ValueError, match="analytic"):
        t_tune.fit(ts, traces, mode="hlo", device="cpu")
    with pytest.raises(ValueError, match="unknown tuner mode"):
        t_tune.fit(ts, traces, mode="xla", device="cpu")
    assert t_tuner.resolve_mode("auto", torch.device("cpu")) == "analytic"
    assert t_tuner.resolve_mode("auto", torch.device("cuda", 0)) == "measure"
    auto = t_tune.fit(ts, traces, mode="auto", batch=8, max_samples=2, device="cpu")
    assert auto.source == "analytic"
    assert t_tune.device_kind("cpu") == "cpu"


def test_measure_mode_on_the_cpu_times_the_calls():
    _js, ts = _specs("dlrm-qr-smoke", duplication=False)
    traces = _traces(ts, n=1024)
    t = t_tune.fit(ts, traces, mode="measure", batch=8, max_samples=2, repeats=1,
                   device="cpu")
    assert t.source == "measure" and len(t.samples) == 4
    assert all(s.measured_s > 0 for s in t.samples)


def test_analytic_bytes_count_the_packed_streams():
    """A one-table dense plan without cache: the unique rows, one index and
    one slot stream, and the output — counted by hand."""
    _js, ts = _specs("dlrm-dense-smoke", duplication=False, cache_slots=0)
    spec = ts.replace(bags=ts.bags[:1])
    eng = t_engine.compile(t_engine.plan(spec, knobs=t_tune.default_knobs(spec, packable=True)))
    idx = np.array([[[1, 2, 2]], [[5, 1, 7]]], dtype=np.int32)       # (B=2, T=1, K=3)
    nbytes, flops = t_tuner.analytic_bytes_flops(eng, idx)
    dim = spec.bags[0].emb.dim
    assert nbytes == 4 * dim * 4 + 2 * 6 * 4 + 2 * dim * 4
    assert flops == 6 * dim


# ---------------------------------------------------------------------------
# build_serve_state(tuner=) arms the drift monitor; the example
# ---------------------------------------------------------------------------

def test_build_serve_state_with_tuner_arms_the_drift_monitor(analytic_fit):
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    spec = t_engine.EngineSpec.from_dlrm(cfg, serving=True)
    traces = [zipf_trace(cfg.vocab_per_table, 2048, seed=7 + t)
              for t in range(cfg.num_tables)]
    tuner = t_tune.fit(spec, traces, mode="analytic", batch=8, max_samples=3,
                       num_shards=4, device="cpu")
    state = t_serve.build_serve_state(cfg, shards=4, alpha=1.05, seed=0,
                                      device="cpu", tuner=tuner)
    knobs = tuner.choose(spec, backend="packed")
    assert state.eplan.knobs == knobs and state.eplan.packed
    assert state.predicted_s == tuner.predict(spec, knobs)
    assert state.drift is not None and state.drift.n == 0
    res = t_serve.run_pipeline(cfg, batch=8, batches=4, mode="sequential",
                               state=state, device="cpu")
    assert state.drift.n == 3 and res["drift"]["observations"] == 3
    # without a tuner nothing is armed; explicit knobs win over a tuner
    plain = t_serve.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device="cpu")
    assert plain.predicted_s is None and plain.drift is None
    default = t_tune.default_knobs(spec, packable=True)
    pinned = t_serve.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device="cpu",
                                       tuner=tuner, knobs=default)
    assert pinned.eplan.knobs == default and pinned.drift is None


def test_autotune_example_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import autotune_plan

    cache = str(tmp_path / "memo.json")
    out = autotune_plan.main(["--device", "cpu", "--cache", cache])
    assert out["source"] == "analytic" and not out["from_cache"] and out["samples"] > 0
    again = autotune_plan.main(["--device", "cpu", "--cache", cache])
    assert again["from_cache"] and again["knobs"] == out["knobs"]
    assert "no-trace plan == heuristic-knobs plan: OK" in capsys.readouterr().out
