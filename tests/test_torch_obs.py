"""Port parity of the telemetry modules (``repro_torch.obs``,
``repro_torch.tune.cost_model``), and ``repro``'s behavioural telemetry
cases run on the port's modules.

Parity: the same numpy inputs go through ``repro.obs.X`` and
``repro_torch.obs.X``.  Histograms, snapshots, merges, their JSON, the SLO
parse and alerts, the drift summary, the recorder's dumps and the report's
keys are equal exactly (both packages run the same numpy code); the cost
model's fit and prediction to rtol 1e-12 (one lstsq, one summation order on
one machine; 1e-12 leaves room only for a different BLAS path); the
attribution's stage rows, basis and bytes exactly, its modeled seconds to
rtol 1e-12, with the port's card constants patched to ``repro``'s.

Behaviour: the cases of ``tests/test_obs.py`` and
``tests/test_observatory.py`` on the port (histogram math against numpy,
span nesting, burn-rate windows against hand-computed budgets, the flight
recorder, the disabled path).  The serving-loop cases live in
``tests/test_torch_obs_serve.py``.
"""

import json
import types

import pytest

jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.cache import sram_cache as j_cache  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.obs import attribution as JA  # noqa: E402
from repro.obs import drift as JD  # noqa: E402
from repro.obs import metrics as JM  # noqa: E402
from repro.obs import recorder as JR  # noqa: E402
from repro.obs import report as JP  # noqa: E402
from repro.obs import slo as JS  # noqa: E402
from repro.obs.tracer import Tracer as JTracer  # noqa: E402
from repro.obs import traffic as JF  # noqa: E402
from repro.tune import cost_model as JC  # noqa: E402
from repro.tune import knobs as JK  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.cache import sram_cache as t_cache  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.obs import attribution as A  # noqa: E402
from repro_torch.obs import drift as D  # noqa: E402
from repro_torch.obs import metrics as M  # noqa: E402
from repro_torch.obs import recorder as R  # noqa: E402
from repro_torch.obs import report as P  # noqa: E402
from repro_torch.obs import slo as S  # noqa: E402
from repro_torch.obs.tracer import Tracer  # noqa: E402
from repro_torch.obs import traffic as F  # noqa: E402
from repro_torch.tune import cost_model as C  # noqa: E402
from repro_torch.tune import knobs as K  # noqa: E402


def _wipe(facade):
    facade.disable()
    facade.registry().reset()
    facade.tracer().reset()
    facade.install_observatory()


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' telemetry disabled and
    wiped (the facades are process-global)."""
    for facade in (obs, j_obs):
        _wipe(facade)
    yield
    for facade in (obs, j_obs):
        _wipe(facade)


def _lognormal(seed, n=500, mean=-6.0):
    return np.random.default_rng(seed).lognormal(mean=mean, sigma=1.5, size=n)


def _snap_equal(a, b):
    assert (a.name, a.unit) == (b.name, b.unit)
    np.testing.assert_array_equal(a.bounds, b.bounds)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.samples, b.samples)


# ---------------------------------------------------------------------------
# parity: metrics, tracer, drift, slo, recorder, cost model, attribution,
# report
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop_samples", [False, True])
def test_histogram_snapshots_merge_json_match_repro(drop_samples):
    a, b = _lognormal(0), _lognormal(1, n=300, mean=-4.0)
    snaps = {}
    for name, mod in (("repro", JM), ("port", M)):
        reg1, reg2 = mod.MetricRegistry(), mod.MetricRegistry()
        for v in a:
            reg1.histogram("lat").record(v)
        for v in b:
            reg2.histogram("lat").record(v)
        reg1.counter("n").inc(3)
        reg2.counter("n").inc(4)
        reg2.counter("m").inc(1)
        reg1.gauge("g").set(2.5)
        reg1.attach("plan", {"backend": "packed"})
        s1, s2 = reg1.snapshot(), reg2.snapshot()
        h = s1.histograms["lat"].merge(s2.histograms["lat"], drop_samples=drop_samples)
        snaps[name] = (s1, s1.merge(s2), h)
    (j1, jm, jh), (t1, tm, th) = snaps["repro"], snaps["port"]
    _snap_equal(th, jh)
    _snap_equal(t1.histograms["lat"], j1.histograms["lat"])
    for q in (50, 90, 95, 99, 99.9):
        assert th.percentile(q) == jh.percentile(q)
        assert th.bucket_percentile(q) == jh.bucket_percentile(q)
    assert th.describe() == jh.describe()
    assert tm.to_json() == jm.to_json()
    assert json.dumps(tm.to_json()) == json.dumps(jm.to_json())
    np.testing.assert_array_equal(M.log_bounds(1e-3, 1e0, per_decade=2),
                                  JM.log_bounds(1e-3, 1e0, per_decade=2))
    assert M.latency_percentiles(a) == JM.latency_percentiles(a)
    assert M.exact_percentile([], 99) == JM.exact_percentile([], 99) == 0.0


def _trace_events(tracer_cls):
    tr = tracer_cls()
    with tr.span("outer", args={"mode": "sequential"}):
        for b in (1, 2):
            with tr.span("inner", args={"batch": b}):
                with tr.span("leaf", cat="offline"):
                    pass
        with tr.span("inner2"):
            pass
    tr.instant("marker", args={"why": "test"})
    tr.counter("hit_rate", {"v": 0.5})
    return tr.to_chrome(metadata={"run": "test"})


def test_tracer_events_schema_and_nesting_match_repro():
    jd, td = _trace_events(JTracer), _trace_events(Tracer)
    assert set(td) == set(jd) and td["otherData"] == jd["otherData"]
    assert td["displayTimeUnit"] == jd["displayTimeUnit"]
    assert len(td["traceEvents"]) == len(jd["traceEvents"])
    for te, je in zip(td["traceEvents"], jd["traceEvents"]):
        assert set(te) == set(je)
        for key in ("name", "cat", "ph"):
            assert te.get(key) == je.get(key)
        if te["ph"] == "M":
            assert te["args"] == {"name": "repro_torch.serve"}
        else:
            assert te["args"] == je["args"]          # depth, batch, values
    json.dumps(td)


def test_drift_summary_matches_repro():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0.005, 0.05, size=40)
    meas = pred * np.r_[np.full(20, 1.1), np.full(20, 2.3)] * rng.uniform(0.95, 1.05, 40)
    mons = [JD.DriftMonitor(window=8, min_points=8), D.DriftMonitor(window=8, min_points=8)]
    for m in mons:
        for p, x in zip(pred, meas):
            m.observe(p, x)
    assert mons[1].summary() == mons[0].summary()
    np.testing.assert_array_equal(mons[1].residuals(), mons[0].residuals())
    pairs = list(zip(pred[:12], meas[:12]))
    assert D.rank_agreement(pairs) == JD.rank_agreement(pairs)


SLO_SPECS = [
    "p99_ms=50,hit=0.5,qps=100,objective=0.95,fast_window=4,slow_window=16,name=prod",
    "p99_ms=10,objective=0.9,fast_window=2,slow_window=4",
    "p99_s=0.01,page_burn=5,ticket_burn=1.5",
]


@pytest.mark.parametrize("text", SLO_SPECS)
def test_slo_parse_and_alerts_match_repro(text):
    js, ts = JS.SLOSpec.parse(text), S.SLOSpec.parse(text)
    assert ts.describe() == js.describe()
    rng = np.random.default_rng(4)
    # good stretch, a burning stretch, a slow leak
    lats = np.r_[rng.uniform(0.001, 0.009, 20), rng.uniform(0.02, 0.1, 12),
                 np.where(np.arange(24) % 4 == 0, 0.2, 0.005)]
    je, te = JS.SLOEngine(js), S.SLOEngine(ts)
    for v in lats:
        assert te.observe(v) == je.observe(v)
    assert te.finalize(hit_rate=0.4, qps=120.0) == je.finalize(hit_rate=0.4, qps=120.0)
    assert te.state() == je.state()
    for bad in ("p99ms=50", "p99_ms", "fast_window=8,slow_window=4"):
        with pytest.raises(ValueError) as je_err:
            JS.SLOSpec.parse(bad)
        with pytest.raises(ValueError) as te_err:
            S.SLOSpec.parse(bad)
        assert str(te_err.value) == str(je_err.value)


def test_recorder_dumps_match_repro(tmp_path):
    lats = np.r_[np.full(8, 0.010) + 1e-5 * np.arange(8), 0.050, 0.011, 0.012]
    docs = {}
    for name, mod in (("repro", JR), ("port", R)):
        out = tmp_path / name
        rec = mod.FlightRecorder(capacity=6, out_dir=str(out), min_history=8, max_dumps=3)
        infos = []
        for t, lat in enumerate(lats):
            alerts = [{"severity": "page", "at_batch": t}] if t == 10 else []
            r = mod.BatchRecord(batch=t, mode="overlap", latency_s=float(lat),
                                stages={"prefetch": 1e-3 * t}, counters={"c": 1},
                                traffic={"hit_rate": 0.5})
            info = rec.observe(r, alerts=alerts)
            infos.append(None if info is None else {k: v for k, v in info.items()
                                                    if k != "path"})
        docs[name] = (infos, [json.loads(p.read_text()) for p in sorted(out.iterdir())],
                      rec.anomaly_threshold())
    assert docs["port"] == docs["repro"]
    assert len(docs["port"][1]) == 2          # the MAD breach and the page


def _samples(knobs_cls, sample_cls, rng):
    x = rng.uniform(0, 1, size=(12, 4)) * np.array([26, 1e9, 1e6, 1e7])
    coef = np.array([5e-6, 3e-13, 2e-10, 0.0])
    y = x @ coef + rng.normal(0, 1e-6, 12)
    return [sample_cls(knobs=knobs_cls(cache_slots=i), features=tuple(map(float, f)),
                       measured_s=float(v)) for i, (f, v) in enumerate(zip(x, y))]


def test_cost_model_fit_and_predict_match_repro():
    jm = JC.fit_cost_model(_samples(JK.Knobs, JC.CostSample, np.random.default_rng(5)),
                           backend="packed")
    tm = C.fit_cost_model(_samples(K.Knobs, C.CostSample, np.random.default_rng(5)),
                          backend="packed")
    np.testing.assert_allclose(tm.coef, jm.coef, rtol=1e-12, atol=0)
    assert all(c >= 0 for c in tm.coef)
    feats = (1.0, 2.5e8, 4e5, 0.0)
    np.testing.assert_allclose(tm.predict(feats), jm.predict(feats), rtol=1e-12)
    assert C.KernelCostModel.from_json(tm.describe()) == tm
    assert set(tm.describe()) == set(jm.describe()) and C.FEATURES == JC.FEATURES
    s = _samples(K.Knobs, C.CostSample, np.random.default_rng(5))[0]
    assert s.describe() == _samples(JK.Knobs, JC.CostSample,
                                    np.random.default_rng(5))[0].describe()
    with pytest.raises(ValueError, match="at least one sample"):
        C.fit_cost_model([], backend="packed")


# one hand-made fenced session: batch 0 (warm-up, skipped) and two steady
# batches; durations in us
_EVENTS = [
    {"name": n, "ph": "X", "dur": d, "args": {"batch": b}}
    for b, spans in ((0, {"prefetch": 900.0, "dispatch": 5000.0}),
                     (1, {"prefetch": 120.0, "pack": 40.0, "h2d": 9.0, "dispatch": 30.0,
                          "device_compute": 250.0, "interact": 20.0, "device_head": 12.0,
                          "block": 1.0, "batch": 500.0}),
                     (2, {"prefetch": 110.0, "pack": 44.0, "h2d": 11.0, "dispatch": 28.0,
                          "device_compute": 245.0, "interact": 22.0, "device_head": 10.0,
                          "block": 1.5, "batch": 480.0}))
    for n, d in spans.items()
] + [{"name": "tail_sync", "ph": "X", "dur": 3.0, "args": {"mode": "overlap"}},
     {"name": "serve/x/hit_rate", "ph": "C", "args": {"hit_rate": 0.5}}]


def _session(pkg):
    """A traffic report and a plan stand-in for one package: per-table
    counts priced by its own ``cache_traffic``, its own duplication plan."""
    cache_mod, traffic_mod = (j_cache, JF) if pkg == "repro" else (t_cache, F)
    from repro.cache import duplication as jdup
    from repro_torch.cache import duplication as tdup

    dup_mod = jdup if pkg == "repro" else tdup
    tables = []
    for t in range(3):
        st = cache_mod.CacheStats(accesses=4096 + t, hits=3000 - 7 * t, staged_rows=90 + t,
                                  kept_rows=40, batches=4)
        tables.append(traffic_mod.cache_traffic(st, 512))
    comm_free = types.SimpleNamespace(comm_free=True)
    sharded = types.SimpleNamespace(comm_free=False)
    dup = dup_mod.DuplicationPlan(tables=(comm_free, sharded, comm_free), num_shards=4,
                                  budget_bytes=1 << 20)
    report = traffic_mod.TrafficReport(tables=tables, batches=4,
                                       comm=dup.ici_bytes_per_batch(64, 128))
    emb = types.SimpleNamespace(dim=128)
    plan = types.SimpleNamespace(packed=True, bags=[types.SimpleNamespace(emb=emb)] * 3,
                                 dim_block=128, slot_budgets=(100, 120, 80), dup=dup)
    return report, plan


def test_attribute_matches_repro(monkeypatch):
    for name in ("HBM_BW", "ICI_BW_PER_LINK", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(t_mesh, name, getattr(j_mesh, name))
    coef = (2e-5, 1 / 3e12, 1e-9, 1 / 1e11)
    out = {}
    for pkg, cm, att_mod in (("repro", JC, JA), ("port", C, A)):
        report, plan = _session(pkg)
        model = cm.KernelCostModel(coef=coef, source="fit", num_samples=3)
        out[pkg] = att_mod.attribute(_EVENTS, report, plan, batch=64, model=model,
                                     fenced=True)
        out[pkg, "report"] = report
    j, t = out["repro"], out["port"]
    assert out["port", "report"].describe() == out["repro", "report"].describe()
    assert [r.stage for r in t.rows] == [r.stage for r in j.rows]
    for tr, jr in zip(t.rows, j.rows):
        assert (tr.basis, tr.bytes_per_batch, tr.measured_s, tr.share) == \
            (jr.basis, jr.bytes_per_batch, jr.measured_s, jr.share)
        if jr.modeled_s is None:
            assert tr.modeled_s is None
        else:
            np.testing.assert_allclose(tr.modeled_s, jr.modeled_s, rtol=1e-12)
    assert (t.bottleneck, t.total_s, t.fenced) == (j.bottleneck, j.total_s, j.fenced)
    assert t.features == j.features
    np.testing.assert_allclose(t.modeled_total_s(), j.modeled_total_s(), rtol=1e-12)
    assert t.largest_residual["stage"] == j.largest_residual["stage"]
    td, jd = t.describe(), j.describe()
    assert set(td) == set(jd) and td["schema"] == jd["schema"]
    assert t.format_table().splitlines()[:2] == j.format_table().splitlines()[:2]


def test_model_terms_match_repro(monkeypatch):
    """One pricing of bytes and flops: with the port's constants patched to
    ``repro``'s, the roofline terms and their rows are ``repro``'s."""
    for name in ("HBM_BW", "ICI_BW_PER_LINK", "PEAK_FLOPS_BF16"):
        monkeypatch.setattr(t_mesh, name, getattr(j_mesh, name))
    kw = dict(flops=4e12, hbm_bytes=8e9, wire_bytes=1e9)
    shared = A.model_terms(**kw)
    assert shared == JA.model_terms(**kw)
    assert A.term_rows(shared, hbm_bytes=8e9, wire_bytes=1e9) == \
        JA.term_rows(shared, hbm_bytes=8e9, wire_bytes=1e9)


def test_report_build_keys_match_repro():
    docs = {}
    for pkg, mods in (("repro", (JM, JS, JC, JA, JP)), ("port", (M, S, C, A, P))):
        m, s, cm, am, pm = mods
        reg = m.MetricRegistry()
        reg.counter("engine/dispatch/serve_gather").inc(4)
        reg.histogram("serve/sequential/batch_latency_s").record(0.01)
        eng = s.SLOEngine(s.SLOSpec(p99_latency_s=1e-3, fast_window=1, slow_window=1))
        eng.observe(0.01)
        report, plan = _session(pkg)
        att = am.attribute(_EVENTS, report, plan, batch=64, fenced=True,
                           model=cm.KernelCostModel(coef=(1e-5, 1e-12, 0.0, 1e-11)))
        rep = pm.build(snapshot=reg.snapshot(), slo_state=eng.state(), attribution=att,
                       traffic=report.describe(), results={"sequential": {
                           "qps": 1.0, "lat_p50_s": 0.01, "lat_p95_s": 0.01,
                           "lat_p99_s": 0.01, "compile_s": 0.1}},
                       flight_dumps=[{"reason": "slo_burn:page", "records": 1,
                                      "trigger_batch": 0}],
                       meta={"config": "dlrm-qr-smoke"})
        docs[pkg] = (rep, pm.render_markdown(rep))
    (jrep, jmd), (trep, tmd) = docs["repro"], docs["port"]
    assert set(trep) == set(jrep) and trep["schema"] == jrep["schema"]
    for key in ("slo", "attribution", "traffic", "metrics"):
        assert set(trep[key]) == set(jrep[key]), key
    assert tmd.splitlines()[0] == jmd.splitlines()[0]
    assert [ln for ln in tmd.splitlines() if ln.startswith("#")] == \
        [ln for ln in jmd.splitlines() if ln.startswith("#")]
    assert P.json_twin_path("a/report.md") == JP.json_twin_path("a/report.md")


def test_ici_bytes_per_batch_matches_repro():
    jr, _ = _session("repro")
    tr, _ = _session("port")
    assert tr.comm == jr.comm
    assert tr.comm["saved"] == tr.comm["baseline"] - tr.comm["duplicated"] > 0


# ---------------------------------------------------------------------------
# behaviour on the port (repro's tests/test_obs.py and test_observatory.py)
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy():
    samples = _lognormal(0)
    h = M.Histogram("lat")
    for s in samples:
        h.record(s)
    for q in (50, 90, 95, 99, 99.9):
        assert h.percentile(q) == pytest.approx(np.percentile(samples, q))
    snap = h.snapshot()
    assert snap.count == 500
    for q in (50, 95, 99):
        assert snap.percentile(q) == pytest.approx(np.percentile(samples, q))


def test_bucketize_edges_and_clipping():
    bounds = M.log_bounds(1e-3, 1e0, per_decade=1)            # 1ms,10ms,0.1s,1s
    counts = M.bucketize(np.array([1e-6, 1e-3, 5e-3, 0.5, 1e3]), bounds)
    assert counts.tolist() == [3, 0, 2]    # under/overflow clip to edge buckets


def test_bucket_percentile_interpolation_bounds():
    """After a lossy merge the interpolated quantile lands inside the bucket
    that holds the true quantile."""
    samples = np.random.default_rng(1).lognormal(mean=-4.0, sigma=1.0, size=2000)
    h = M.Histogram("lat")
    for s in samples:
        h.record(s)
    lossy = h.snapshot().merge(h.snapshot(), drop_samples=True)
    assert lossy.samples.size == 0 and lossy.count == 4000
    for q in (50, 95, 99):
        exact = np.percentile(samples, q)
        b = np.searchsorted(lossy.bounds, exact, side="right") - 1
        assert lossy.bounds[b] <= lossy.percentile(q) <= lossy.bounds[b + 1]


def test_histogram_merge_rejects_mismatched_buckets():
    h1 = M.Histogram("lat")
    h1.record(0.001)
    other = M.Histogram("lat", bounds=M.log_bounds(1e-3, 1e0, per_decade=2))
    with pytest.raises(ValueError, match="different buckets"):
        h1.snapshot().merge(other.snapshot())


def test_span_nesting_and_chrome_schema():
    doc = _trace_events(Tracer)
    ev = doc["traceEvents"]
    assert ev[0]["ph"] == "M"
    spans = [e for e in ev if e["ph"] == "X"]
    for e in spans:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
    outer = next(e for e in spans if e["name"] == "outer")
    inner = [e for e in spans if e["name"] == "inner"]
    assert outer["args"]["depth"] == 0 and all(e["args"]["depth"] == 1 for e in inner)
    for e in inner:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert [e["args"]["batch"] for e in inner] == [1, 2]
    assert any(e["ph"] == "i" for e in ev) and any(e["ph"] == "C" for e in ev)


def test_tracer_write_roundtrip(tmp_path):
    tr = Tracer()
    with tr.span("s"):
        pass
    path = tmp_path / "trace.json"
    tr.write(str(path), metadata={"device": "cpu"})
    doc = json.loads(path.read_text())
    assert any(e["ph"] == "X" and e["name"] == "s" for e in doc["traceEvents"])
    assert doc["otherData"] == {"device": "cpu"}


def test_rank_agreement_noise_floor():
    assert D.rank_agreement([(1.0, 1.0), (2.0, 2.1), (3.0, 3.3)]) == (1.0, 3)
    assert D.rank_agreement([(1.0, 3.0), (2.0, 2.0), (3.0, 1.0)]) == (0.0, 3)
    assert D.rank_agreement([(1.0, 1.0), (2.0, 1.01)]) == (1.0, 0)


def test_drift_monitor_triggers_on_residual_step_not_on_bias():
    mon = D.DriftMonitor(window=8, rel_tol=0.25, min_points=8)
    for _ in range(8):
        mon.observe(0.010, 0.011)
    assert not mon.refit_recommended and mon.drift == pytest.approx(0.0)
    for _ in range(8):
        mon.observe(0.010, 0.020)
    assert mon.drift > 0.25 and mon.refit_recommended
    biased = D.DriftMonitor(window=8, min_points=8)
    rng = np.random.default_rng(2)
    for _ in range(24):
        p = rng.uniform(0.005, 0.05)
        biased.observe(p, 2.0 * p)
    assert not biased.refit_recommended
    assert biased.recent_rank_agreement()[1] > 0


def test_disabled_mode_records_nothing():
    assert not obs.enabled()
    obs.inc("x")
    obs.observe("h", 0.01)
    obs.set_gauge("g", 1.0)
    obs.attach("k", {"v": 1})
    with obs.span("s"):
        pass
    obs.instant("i")
    obs.trace_counter("c", v=1.0)
    assert obs.observe_batch(batch=0, mode="overlap", latency_s=0.01) is None
    snap = obs.snapshot()
    assert snap.counters == {} and snap.histograms == {} and snap.info == {}
    assert obs.tracer().events == []


def test_disabled_observe_batch_bypasses_installed_observatory():
    eng = obs.SLOEngine(obs.SLOSpec(p99_latency_s=1e-9, fast_window=1, slow_window=1))
    rec = obs.FlightRecorder(capacity=4, min_history=1)
    obs.install_observatory(slo=eng, recorder=rec)
    assert obs.observe_batch(batch=0, mode="overlap", latency_s=99.0) is None
    assert eng.n == 0 and len(rec) == 0 and rec.dumps == []


def test_disabled_span_is_shared_singleton():
    assert obs.span("a", batch=1) is obs.span("b", mode="overlap") is obs.NULL_SPAN


def test_enable_records_and_reset_wipes():
    obs.enable()
    obs.inc("x", 2)
    obs.observe("h", 0.01)
    with obs.span("s"):
        pass
    snap = obs.snapshot()
    assert snap.counters["x"] == 2 and snap.histograms["h"].count == 1
    assert any(e["name"] == "s" for e in obs.tracer().events)
    assert not j_obs.enabled()             # the two facades are apart
    obs.enable(reset=True)
    assert obs.snapshot().counters == {} and obs.tracer().events == []


def test_cache_traffic_matches_cachestats():
    from repro_torch.data.synthetic import zipf_trace

    rows = zipf_trace(4096, 6 * 32 * 8, alpha=1.05, seed=3).reshape(6, -1)
    sched = t_cache.PrefetchScheduler(4096, 128)
    for t in range(rows.shape[0]):
        sched.prefetch(rows[t])
        sched.slots_for(rows[t], record=True)
    stats = sched.stats
    tr = F.cache_traffic(stats, row_bytes=512)
    assert (tr["accesses"], tr["hits"], tr["staged_rows"]) == \
        (stats.accesses, stats.hits, stats.staged_rows)
    assert tr["misses"] == stats.accesses - stats.hits
    tb = stats.traffic_bytes(512)
    assert (tr["hbm_baseline_bytes"], tr["hbm_cached_bytes"]) == (tb["baseline"], tb["cached"])
    assert tr["hbm_cached_bytes"] <= tr["hbm_baseline_bytes"]
    assert "hit=" in F.format_cache_traffic(tr)


def test_cache_traffic_agrees_with_cache_sim(capsys):
    """``repro``'s cache benchmark reports a hit rate; the port's traffic
    module, fed the port's ``sram_cache.simulate`` on the same trace (same
    scheduler, same slots), must report the same number."""
    from benchmarks.cache_sim import qr_cache_sweep
    from repro_torch.cache import intra_gnr
    from repro_torch.core.qr_embedding import EmbeddingConfig
    from repro_torch.data.synthetic import zipf_trace

    kw = dict(vocab=16_384, collision=16, pooling=8, batch=64, n_batches=6)
    bench_hit = qr_cache_sweep(slot_sweep=(64, 128), default_slots=128, **kw)
    capsys.readouterr()                    # swallow the emitted rows
    # replay: the trace construction of benchmarks.cache_sim._batches
    trace = zipf_trace(kw["vocab"], kw["n_batches"] * kw["batch"] * kw["pooling"],
                       alpha=1.05, seed=3).reshape(kw["n_batches"], -1)
    cfg = EmbeddingConfig(vocab=kw["vocab"], dim=128, kind="qr", collision=kw["collision"])
    q, q_rows, row_bytes = intra_gnr.subtable_traces(trace, cfg)["q"]
    stats = t_cache.simulate([q[t] for t in range(kw["n_batches"])], q_rows, 128)
    tr = F.cache_traffic(stats, row_bytes)
    assert tr["hit_rate"] == pytest.approx(bench_hit)


def test_slospec_parse_cli_form():
    spec = S.SLOSpec.parse("p99_ms=50,hit=0.5,qps=100,objective=0.95,"
                           "fast_window=4,slow_window=16,name=prod")
    assert spec.p99_latency_s == pytest.approx(0.050)
    assert (spec.hit_rate_floor, spec.qps_floor, spec.objective) == (0.5, 100.0, 0.95)
    assert (spec.fast_window, spec.slow_window, spec.name) == (4, 16, "prod")
    assert spec.budget_fraction == pytest.approx(0.05)
    with pytest.raises(ValueError, match="objective"):
        S.SLOSpec(objective=1.0)


def test_burn_rate_hand_computed():
    eng = S.SLOEngine(S.SLOSpec(p99_latency_s=0.010, objective=0.9,
                                fast_window=4, slow_window=8))
    assert eng.burn_rate(8) == 0.0
    eng.observe(0.020)
    assert eng.burn_rate(8) == pytest.approx(10.0)    # short history: what exists
    for _ in range(7):
        eng.observe(0.005)
    eng.observe(0.020)
    eng.observe(0.020)
    assert eng.burn_rate(4) == pytest.approx(5.0)     # [good, good, bad, bad]
    assert eng.burn_rate(8) == pytest.approx(2.5)     # 6 good, 2 bad
    assert eng.budget_allowed == pytest.approx(1.0)
    assert eng.budget_spent == 3 and eng.breached


def test_page_alert_needs_both_windows_and_is_edge_triggered():
    eng = S.SLOEngine(S.SLOSpec(p99_latency_s=0.010, objective=0.99,
                                fast_window=2, slow_window=4, page_burn=10.0))
    fired = []
    for _ in range(10):
        fired += eng.observe(0.020)
    assert [a["severity"] for a in fired] == ["page"]
    assert fired[0]["at_batch"] == 1 and fired[0]["fast_burn"] == pytest.approx(100.0)


def test_ticket_alert_on_slow_leak():
    eng = S.SLOEngine(S.SLOSpec(p99_latency_s=0.010, objective=0.9, fast_window=4,
                                slow_window=12, page_burn=10.0, ticket_burn=2.0))
    fired = []
    for i in range(24):
        fired += eng.observe(0.020 if i % 4 == 0 else 0.005)
    assert {a["severity"] for a in fired} == {"ticket"}


def test_evaluate_snapshot_streams_without_double_count():
    eng = S.SLOEngine(S.SLOSpec(p99_latency_s=0.010, objective=0.9,
                                fast_window=2, slow_window=4))
    obs.enable()
    for v in (0.005, 0.020, 0.005):
        obs.observe("serve/overlap/batch_latency_s", v)
    eng.evaluate_snapshot(obs.snapshot())
    assert eng.n == 3 and eng.bad_total == 1
    eng.evaluate_snapshot(obs.snapshot())
    assert eng.n == 3
    obs.observe("serve/overlap/batch_latency_s", 0.030)
    eng.evaluate_snapshot(obs.snapshot())
    assert eng.n == 4 and eng.bad_total == 2


def test_finalize_floors_and_state_json():
    eng = S.SLOEngine(S.SLOSpec(p99_latency_s=0.010, hit_rate_floor=0.8,
                                qps_floor=100.0, objective=0.9))
    eng.observe(0.005)
    floors = eng.finalize(hit_rate=0.95, qps=50.0)
    assert not floors["hit_rate"]["breached"] and floors["qps"]["breached"]
    state = eng.state()
    json.dumps(state)
    assert state["breached"] and state["observations"] == 1 and state["bad_events"] == 0


def _record(batch, lat):
    return R.BatchRecord(batch=batch, mode="overlap", latency_s=lat, stages={}, counters={})


def test_ring_is_bounded():
    rec = R.FlightRecorder(capacity=4)
    for t in range(10):
        rec.observe(_record(t, 0.01))
    assert len(rec) == 4 and [r.batch for r in rec.records] == [6, 7, 8, 9]


def test_mad_anomaly_threshold_and_dump(tmp_path):
    rec = R.FlightRecorder(capacity=8, out_dir=str(tmp_path), mad_k=6.0, min_history=8)
    for t in range(8):
        assert rec.observe(_record(t, 0.010 + 1e-5 * t)) is None
    assert 0.010 < rec.anomaly_threshold() < 0.020
    dump = rec.observe(_record(8, 0.050))
    assert dump["reason"] == "latency_anomaly" and rec.records[-1].anomaly
    doc = json.loads(open(dump["path"]).read())
    assert doc["context"]["trigger_batch"] == 8 and len(doc["records"]) == 8


def test_no_anomaly_before_min_history():
    rec = R.FlightRecorder(min_history=8)
    for t in range(5):
        rec.observe(_record(t, 0.010))
    assert rec.anomaly_threshold() is None
    assert rec.observe(_record(5, 10.0)) is None and not rec.records[-1].anomaly


def test_slo_alert_dump_and_max_dumps_cap(tmp_path):
    rec = R.FlightRecorder(capacity=4, out_dir=str(tmp_path), max_dumps=2)
    alert = {"severity": "page", "at_batch": 0}
    assert rec.observe(_record(0, 0.01), alerts=[alert])["reason"] == "slo_burn:page"
    assert rec.observe(_record(1, 0.01), alerts=[alert]) is not None
    assert rec.observe(_record(2, 0.01), alerts=[alert]) is None
    assert sorted(p.name for p in tmp_path.iterdir()) == ["flight_000.json",
                                                          "flight_001.json"]


def test_telemetry_join_stages_and_counter_deltas():
    obs.enable()
    join = R.TelemetryJoin(obs.tracer(), obs.registry())
    for name in ("prefetch", "dispatch", "batch"):
        with obs.span(name, batch=3):
            pass
    with obs.span("pack_tables"):           # no batch arg: ignored
        pass
    obs.inc("engine/dispatch/serve_gather")
    r = join.next_record(batch=3, mode="overlap", latency_s=0.01)
    assert set(r.stages) == {"prefetch", "dispatch"}
    assert r.counters == {"engine/dispatch/serve_gather": 1}
    r2 = join.next_record(batch=4, mode="overlap", latency_s=0.01)
    assert r2.stages == {} and r2.counters == {}


def test_analytic_cost_model_prices_from_card_constants():
    m = A.analytic_cost_model()
    coef = dict(zip(C.FEATURES, m.coef))
    assert coef["dispatches"] == t_mesh.DISPATCH_OVERHEAD_S
    assert coef["hbm_bytes"] == pytest.approx(1.0 / t_mesh.HBM_BW)
    assert coef["comm_bytes"] == pytest.approx(1.0 / (2 * t_mesh.ICI_BW_PER_LINK))
    assert m.source == "analytic"
    # the card's datasheet rates, not the reference's TPU constants
    assert (t_mesh.HBM_BW, t_mesh.PEAK_FLOPS_BF16, t_mesh.PEAK_FLOPS_FP32) == \
        (3.35e12, 989e12, 67e12)
    assert t_mesh.HBM_BW != j_mesh.HBM_BW
