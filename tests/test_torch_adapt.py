"""Port parity of online adaptation: sketches, drift schedules, pinned
residency, the re-planning controller and the adaptive serving session.

The host-side pieces are numpy in both packages and must agree exactly:
count-min and space-saving state and estimates, ``FrequencySketch``
windows, ``DriftSchedule`` / ``drifting_zipf_batches``, ``PinnedCache``
swaps and ``incremental_update``, the plan's pinned residency, and the
controller's events on a rotating stream.  The serving session is held to
``repro``'s own contracts: a stationary adaptive session is bitwise equal
to the port's ``run_pipeline`` on the same batches, and a drifting session
re-pins in place (one engine, one packed buffer set: the kernel is launched,
never rebuilt).  Against ``repro`` the session's events, hit-rate and
staging series are equal (the logits are the pipeline's, held against
``repro``'s by ``tests/test_torch_serve.py``).
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

from repro import adapt as j_adapt  # noqa: E402
from repro import obs as j_obs  # noqa: E402
from repro.adapt import loop as j_loop  # noqa: E402
from repro.adapt import replan as j_replan  # noqa: E402
from repro.adapt import sketch as j_sketch  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.launch import serve_rec as j_rec  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch import adapt as t_adapt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch.adapt import loop as t_loop  # noqa: E402
from repro_torch.adapt import replan as t_replan  # noqa: E402
from repro_torch.adapt import sketch as t_sketch  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data.synthetic import zipf_trace  # noqa: E402
from repro_torch.launch import serve_rec as t_rec  # noqa: E402

POLICY = dict(check_every=4, min_batches=8, min_gain=0.05, cooldown_batches=4)
SKETCH = dict(window_batches=4, windows=4, decay=0.3)


@pytest.fixture(scope="module")
def served():
    """dlrm-qr-smoke in both packages, one shard (the adapt tests' state)."""
    jc, tc = j_registry.get_dlrm("dlrm-qr-smoke"), t_registry.get_dlrm("dlrm-qr-smoke")
    jp, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return {"repro": (jc, jp, j_rec.build_serve_state(jc, shards=1, alpha=1.05, seed=0)),
            "port": (tc, tp, t_rec.build_serve_state(tc, shards=1, alpha=1.05, seed=0,
                                                     device="cpu"))}


@pytest.fixture
def metrics():
    """A fresh port telemetry session per test, always disabled after."""
    t_obs.enable(reset=True)
    try:
        yield
    finally:
        t_obs.disable()


# ---------------------------------------------------------------------------
# sketches and schedules
# ---------------------------------------------------------------------------

def _stream(n_chunks=20, size=1000, vocab=2048, seed=3):
    return zipf_trace(vocab, n_chunks * size, alpha=1.05, seed=seed).reshape(n_chunks, size)


@pytest.mark.parametrize("width,depth,seed", [(1024, 4, 1), (300, 2, 7), (4096, 1, 0)])
def test_count_min_equals_repro(width, depth, seed):
    a = j_sketch.CountMinSketch(width=width, depth=depth, seed=seed)
    b = t_sketch.CountMinSketch(width=width, depth=depth, seed=seed)
    for chunk in _stream():
        a.update(chunk)
        b.update(chunk)
    assert a.width == b.width and a.total == b.total
    np.testing.assert_array_equal(a.table, b.table)
    keys = np.arange(2048)
    np.testing.assert_array_equal(a.estimate(keys), b.estimate(keys))


@pytest.mark.parametrize("capacity", [4, 64])
def test_space_saving_equals_repro(capacity):
    a, b = j_sketch.SpaceSaving(capacity), t_sketch.SpaceSaving(capacity)
    for i, chunk in enumerate(_stream(size=200)):
        a.update(chunk)
        b.update(chunk)
        if i % 5 == 4:
            a.scale(0.5)
            b.scale(0.5)
    assert a.top() == b.top() and a.errors == b.errors


@pytest.mark.parametrize("kw", [{}, dict(windows=2, window_batches=2, decay=0.5, topk=16),
                                dict(width=512, depth=3, seed=4)])
def test_frequency_sketch_equals_repro(kw):
    a = j_sketch.FrequencySketch(2048, **kw)
    b = t_sketch.FrequencySketch(2048, **kw)
    for chunk in _stream(n_chunks=40, size=300):
        a.update(chunk)
        b.update(chunk)
        assert a.total == b.total
    np.testing.assert_array_equal(a.estimate_all(), b.estimate_all())
    np.testing.assert_array_equal(a.top_rows(32), b.top_rows(32))
    assert a.batches == b.batches


def test_drift_schedule_and_batches_equal_repro():
    for text in ("period=2,frac=0.25,seed=9", "period=0", "period=3.5,frac=0.4,seed=1"):
        a, b = j_adapt.DriftSchedule.parse(text), t_adapt.DriftSchedule.parse(text)
        assert a.describe() == b.describe() and a.stationary == b.stationary
        for t in (0, 1, 2, 3.6, 7, 11.9):
            assert a.offset_at(t, 1024) == b.offset_at(t, 1024)
            assert a.rotations_before(t) == b.rotations_before(t)
        x = j_adapt.drifting_zipf_batches(1024, 6, 128, schedule=a, seed=9)
        y = t_adapt.drifting_zipf_batches(1024, 6, 128, schedule=b, seed=9)
        assert x.dtype == y.dtype and np.array_equal(x, y)
        z = t_adapt.drifting_zipf_batches(1024, 6, 128, schedule=b, alpha=1.2)
        assert np.array_equal(z, j_adapt.drifting_zipf_batches(1024, 6, 128, schedule=a,
                                                               alpha=1.2))
    with pytest.raises(ValueError, match="unknown --drift key"):
        t_adapt.DriftSchedule.parse("bogus=1")


# ---------------------------------------------------------------------------
# pinned residency and incremental re-planning
# ---------------------------------------------------------------------------

def _cache_state(c):
    return (c.slot_rows.tolist(), c.slot_map.tolist(), c.swaps,
            dataclasses.astuple(c.stats), c.pinned_rows().tolist(), c.cache_rows().tolist())


def test_pinned_cache_equals_repro():
    rng = np.random.default_rng(0)
    pins = [rng.integers(0, 64, size=n) for n in (8, 12, 3, 20, 0, 9)]
    a, b = j_replan.PinnedCache(64, 10), t_replan.PinnedCache(64, 10)
    for rows in pins:
        assert a.pin(rows) == b.pin(rows)
        q = rng.integers(0, 64, size=(4, 5))
        np.testing.assert_array_equal(a.slots_for(q), b.slots_for(q))
        assert _cache_state(a) == _cache_state(b)
    assert a.prefetch(q) == b.prefetch(q) == 0


def test_incremental_update_equals_repro():
    rng = np.random.default_rng(1)
    est = [rng.random(50) * (t + 1) for t in range(3)]
    budgets = (5, 1, 12)
    a = j_replan.incremental_update(est, budgets)
    b = t_replan.incremental_update(est, budgets)
    assert a.predicted_hit == b.predicted_hit
    for x, y in zip(a.rows + a.values, b.rows + b.values):
        np.testing.assert_array_equal(x, y)
    ca = [j_replan.PinnedCache(50, n) for n in budgets]
    cb = [t_replan.PinnedCache(50, n) for n in budgets]
    assert a.apply(ca) == b.apply(cb)
    assert [_cache_state(c) for c in ca] == [_cache_state(c) for c in cb]
    np.testing.assert_array_equal(
        t_replan.fold_to_big(np.arange(4.0), np.array([[0], [1], [0], [2]]), 3),
        j_replan.fold_to_big(np.arange(4.0), np.array([[0], [1], [0], [2]]), 3))
    assert t_replan.coverage(est[0], b.rows[0]) == j_replan.coverage(est[0], a.rows[0])


def test_pinned_from_plan_equals_repro(served):
    a = j_replan.pinned_from_plan(served["repro"][2].eplan)
    b = t_replan.pinned_from_plan(served["port"][2].eplan)
    assert [_cache_state(c) for c in a] == [_cache_state(c) for c in b]
    emb = served["port"][2].eplan.bags[0].emb
    np.testing.assert_array_equal(t_replan.big_id_map(emb),
                                  j_replan.big_id_map(served["repro"][2].eplan.bags[0].emb))


def test_sampled_traces_equal_repro(served):
    def feed(mod, eplan):
        ctl = mod.AdaptController(eplan, sketch_kw=SKETCH, seed=0)
        for b in range(6):
            ctl.observe(_rotating_batch(b, period=3))
        return mod.sampled_traces(ctl.sketches, n=500, seed=2)

    a = feed(j_adapt, served["repro"][2].eplan)
    b = feed(t_adapt, served["port"][2].eplan)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def _rotating_batch(b, *, period, cfg=None, batch=64):
    cfg = cfg or t_registry.get_dlrm("dlrm-qr-smoke")
    sched = t_adapt.DriftSchedule(period=float(period), fraction=0.3, seed=0)
    return np.stack([
        t_adapt.drifting_zipf_batches(cfg.vocab_per_table, b + 1, batch * cfg.pooling,
                                      schedule=sched, seed=7 + t)[b].reshape(batch, cfg.pooling)
        for t in range(cfg.num_tables)], axis=1)


@pytest.mark.parametrize("period", [0, 8, 5])
def test_controller_events_equal_repro(served, period):
    pol_kw = dict(POLICY, min_gain=0.08)
    events = {}
    for pkg, mod in (("repro", j_adapt), ("port", t_adapt)):
        eplan = served[pkg][2].eplan
        ctl = mod.AdaptController(eplan, policy=mod.AdaptPolicy(**pol_kw),
                                  sketch_kw=SKETCH, seed=0)
        caches = ctl.fresh_caches()
        evals = []
        for b in range(24):
            ctl.observe(_rotating_batch(b, period=period))
            ctl.step(caches)
            if b % 6 == 5:
                ev = ctl.evaluate(caches)
                evals.append((ev["predicted_hit"], ev["current_hit"], ev["gain"]))
        events[pkg] = (json.loads(json.dumps(ctl.events)), ctl.summary(),
                       [_cache_state(c) for c in caches], evals)
    assert events["port"] == events["repro"]
    if period == 0:
        assert events["port"][0] == []
    else:
        assert any(e["kind"] == "replan" for e in events["port"][0])


# ---------------------------------------------------------------------------
# the adaptive serving session
# ---------------------------------------------------------------------------

def test_stationary_session_is_bitwise_the_pipeline(served, metrics):
    cfg, params, state = served["port"]
    batch, batches = 8, 4
    ref = t_rec.run_pipeline(cfg, batch=batch, batches=batches, seed=0, mode="sequential",
                             state=state, params=params, device="cpu")
    idx = [_port_idx(cfg, batch, t) for t in range(batches)]
    res = t_loop.serve_adaptive(cfg, batch=batch, batches=batches, seed=0, state=state,
                                params=params, idx_override=idx)
    assert res["events"] == []
    for t in range(batches):
        assert ref["logits"][t].dtype == res["logits"][t].dtype
        assert np.array_equal(ref["logits"][t], res["logits"][t]), f"batch {t}"


def _port_idx(cfg, batch, step):
    """The index batch the port's ``run_pipeline`` draws (its own
    ``synthetic.dlrm_batch``), as numpy."""
    from repro_torch.data import synthetic

    return synthetic.dlrm_batch(cfg, batch, seed=0, step=step)["idx"].numpy()


def test_drift_session_replans_without_rebuilding(served, metrics):
    cfg, params, state = served["port"]
    engine_before = state.engine
    ctl = t_adapt.AdaptController(state.eplan, policy=t_adapt.AdaptPolicy(**POLICY),
                                  sketch_kw=SKETCH, seed=0)
    res = t_loop.serve_adaptive(cfg, batch=16, batches=20, seed=0, state=state,
                                params=params, controller=ctl,
                                schedule=t_adapt.DriftSchedule(period=6.0, fraction=0.3))
    assert "replan" in [e["kind"] for e in res["events"]]
    counters = t_obs.snapshot().counters
    assert counters.get("serve/adapt/replan", 0) >= 1
    # every swap reused the same engine and packed buffers
    assert state.engine is engine_before
    assert counters.get("engine/dispatch/pack", 0) == 1
    assert counters.get("engine/dispatch/serve_gather", 0) == 20
    assert counters.get("engine/compile/serve_gather", 0) <= 1
    names = [e.get("name") for e in t_obs.tracer().events]
    assert "adapt_replan" in names
    assert any(s > 0 for s in res["staged_series"])


@pytest.fixture(scope="module")
def drift_sessions(served):
    """The same drifting session in both packages.  The index stream is the
    shared numpy drift law, so events and series must be exact; the dense
    features are each package's own draw, so the logits are not compared."""
    out = {}
    for pkg, mod, loop in (("repro", j_adapt, j_loop), ("port", t_adapt, t_loop)):
        cfg, params, state = served[pkg]
        ctl = mod.AdaptController(state.eplan, policy=mod.AdaptPolicy(**POLICY),
                                  sketch_kw=SKETCH, seed=0)
        out[pkg] = loop.serve_adaptive(cfg, batch=16, batches=20, seed=0, state=state,
                                       params=params, controller=ctl,
                                       schedule=mod.DriftSchedule(period=6.0, fraction=0.3))
    return out


def test_drift_session_series_equal_repro(drift_sessions):
    a, b = drift_sessions["repro"], drift_sessions["port"]
    assert json.loads(json.dumps(a["events"])) == json.loads(json.dumps(b["events"]))
    assert a["hit_series"] == b["hit_series"]
    assert a["staged_series"] == b["staged_series"]
    assert a["hit_rate"] == b["hit_rate"] and a["served"] == b["served"]
    assert a["adapt"] == b["adapt"]


def test_refit_replans_mid_serve(served, metrics):
    cfg, params, state = served["port"]
    state = dataclasses.replace(state)             # don't poison the module
    state.drift = t_obs.DriftMonitor()
    for i in range(12):
        state.drift.observe(1.0, 1.0 if i % 2 else 2.0)
    state.predicted_s = 1.0
    assert state.drift.refit_recommended
    engine_before = state.engine
    res = t_loop.serve_adaptive(cfg, batch=8, batches=5, seed=0, state=state, params=params,
                                refit=True, refit_kw=dict(max_samples=2, repeats=1))
    ev = next(e for e in res["events"] if e["kind"] == "refit")
    assert "drift" in ev and "knobs" in ev and ev["predicted_s"] > 0
    assert state.engine is not engine_before
    assert state.drift.n < 12
    counters = t_obs.snapshot().counters
    assert counters.get("serve/adapt/refit", 0) == 1
    assert counters.get("engine/dispatch/pack", 0) == 2     # the new plan's buffers
    assert "adapt_refit" in [e.get("name") for e in t_obs.tracer().events]


def test_make_refit_hook_defaults_to_auto():
    import inspect

    assert inspect.signature(t_loop.make_refit_hook).parameters["mode"].default == "auto"


def test_frontend_with_adaptation_uses_pinned_residency(served):
    from repro_torch import serve

    cfg, params, state = served["port"]
    ctl = t_adapt.AdaptController(state.eplan, policy=t_adapt.AdaptPolicy(**POLICY),
                                  sketch_kw=SKETCH, seed=0)
    fe = serve.Frontend(cfg, serve.FrontendConfig(batch_size=8, service_mode="fixed",
                                                  residency="pinned"),
                        state, params, adapt=ctl)
    rep = fe.run(serve.generate(serve.ArrivalSpec(rate_rps=400, horizon_s=1.0, seed=3,
                                                  drift_period_s=0.3), cfg))
    assert rep["requests"]["unaccounted"] == 0
    assert isinstance(fe.scheds[0], t_replan.PinnedCache)
    assert rep["adapt"]["batches"] == ctl.batch_i > 0


def test_cli_adapt_record_equals_repro(tmp_path):
    argv = ["--arch", "dlrm-qr", "--smoke", "--adapt", "--drift", "period=8,frac=0.25",
            "--batches", "24"]
    recs = {}
    for pkg, mod, extra in (("repro", j_rec, []), ("port", t_rec, ["--device", "cpu"])):
        path = tmp_path / f"{pkg}.json"
        try:
            assert mod.main(argv + extra + ["--json", str(path)]) == 0
        finally:
            for facade in (j_obs, t_obs):
                facade.disable()
        (rec,) = json.loads(path.read_text())
        recs[pkg] = {k: rec[k] for k in ("events", "hit_first", "hit_last", "hit_rate",
                                         "staged_series", "served", "schedule")}
    assert recs["port"] == recs["repro"]
    assert [e["kind"] for e in recs["port"]["events"]] == ["replan", "replan"]
