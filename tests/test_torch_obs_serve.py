"""The telemetry slice end to end: the port's serving loop with ``obs`` on,
against ``repro``'s.

Both packages' ``run_pipeline`` serve the same batches (``repro``'s
``synthetic.dlrm_batch``, carried over as numpy) with the same params
(``convert.params_from_numpy``), sequential, telemetry on, fenced and
unfenced, on dlrm-{qr,tt,dense}-smoke.  Equal exactly: the traffic report,
every counter but ``engine/compile/*`` (``repro`` counts jit traces there,
the port the first ``serve_gather`` of a plan), the histograms' sample
counts, and the multiset of span names of each batch.  The logits keep the
tolerances of ``tests/test_torch_serve.py`` (bf16 head: rtol = atol = 8e-3).
Then both CLIs with the five telemetry flags, ``repro``'s observatory cases
on the port's loop, the disabled path, and the port's imports.
"""

import collections
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.launch import serve_rec as j_serve  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro.tune.cost_model import FEATURES  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.launch import serve_rec as t_serve  # noqa: E402
from repro_torch.obs import attribution as A  # noqa: E402
from repro_torch.obs import report as P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"]
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
BATCH_SPANS = {"prefetch", "pack", "h2d", "dispatch", "interact", "block", "batch"}
FENCE_SPANS = {"device_compute", "device_head"}


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


def _repro_batches(jc, batch, batches, seed=0, alpha=1.05):
    return [{k: np.asarray(v) for k, v in
             j_syn.dlrm_batch(jc, batch, seed=seed, step=t, alpha=alpha).items()}
            for t in range(batches)]


def _observed(facade, run):
    facade.enable()
    try:
        res = run()
        return res, facade.snapshot(), list(facade.tracer().events)
    finally:
        _wipe(facade)


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    """Both packages' sequential run_pipeline with telemetry on, unfenced
    and fenced, on one smoke config."""
    arch = request.param
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    jp, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    data = _repro_batches(jc, 4, 4)
    out = {"arch": arch, "cfg": tc}
    for fence in (False, True):
        out["repro", fence] = _observed(j_obs, lambda: j_serve.run_pipeline(
            jc, batch=4, batches=4, mode="sequential", params=jp, fence=fence))
        out["port", fence] = _observed(obs, lambda: t_serve.run_pipeline(
            tc, batch=4, batches=4, mode="sequential", params=tp, data=data,
            device="cpu", fence=fence))
    return out


def _spans_by_batch(events):
    """batch arg -> multiset of span names (spans without one under None)."""
    out: dict = collections.defaultdict(collections.Counter)
    for ev in events:
        if ev.get("ph") == "X":
            out[ev.get("args", {}).get("batch")][ev["name"]] += 1
    return dict(out)


@pytest.mark.parametrize("fence", [False, True])
def test_traffic_report_equals_repro(runs, fence):
    (jr, _, _), (tr, _, _) = runs["repro", fence], runs["port", fence]
    assert tr["traffic"] == jr["traffic"]
    assert tr["traffic_report"].describe() == jr["traffic_report"].describe()
    assert tr["traffic"]["hit_rate"] == pytest.approx(tr["hit_rate"])
    assert len(tr["traffic"]["per_table"]) == runs["cfg"].num_tables
    assert tr["traffic"]["comm_saved_bytes_per_batch"] >= 0.0


@pytest.mark.parametrize("fence", [False, True])
def test_counters_and_histograms_equal_repro(runs, fence):
    (_, js, _), (_, ts, _) = runs["repro", fence], runs["port", fence]
    keep = lambda c: {k: v for k, v in c.items() if not k.startswith("engine/compile/")}
    assert keep(ts.counters) == keep(js.counters)
    assert ts.counters["engine/dispatch/serve_gather"] == 4
    assert {k: h.count for k, h in ts.histograms.items()} == \
        {k: h.count for k, h in js.histograms.items()}
    assert ts.histograms["serve/sequential/batch_latency_s"].count == 3


@pytest.mark.parametrize("fence", [False, True])
def test_span_names_per_batch_equal_repro(runs, fence):
    (_, _, je), (_, _, te) = runs["repro", fence], runs["port", fence]
    jb, tb = _spans_by_batch(je), _spans_by_batch(te)
    assert tb == jb
    for t in (1, 2, 3):
        want = BATCH_SPANS | (FENCE_SPANS if fence else set())
        assert set(tb[t]) == want
    assert set(tb[None]) == {"pack_tables", "compile_warmup"}


def test_record_keys_and_logits(runs):
    for fence in (False, True):
        (jr, _, _), (tr, _, _) = runs["repro", fence], runs["port", fence]
        assert set(jr) <= set(tr) and tr["device"] == "cpu"
        assert tr["drift"] is None and jr["drift"] is None
        for a, b in zip(tr["logits"], jr["logits"]):
            np.testing.assert_allclose(a, np.asarray(b), **BF16_TOL)
    for a, b in zip(runs["port", False][0]["logits"], runs["port", True][0]["logits"]):
        np.testing.assert_array_equal(a, b)         # the fence changes no value


def test_attribution_of_the_port_run_is_complete(runs):
    """``repro``'s attribution checks on the port's fenced run: the cost
    model's stage terms sum to its prediction, every serving stage was
    measured, shares sum to 1."""
    res, _, events = runs["port", True]
    state = t_serve.build_serve_state(runs["cfg"], shards=4, alpha=1.05, seed=0,
                                      device="cpu")
    att = A.attribute(events, res["traffic_report"], state.eplan, batch=4, fenced=True)
    feats = tuple(att.features[f] for f in FEATURES)
    assert att.modeled_total_s() == pytest.approx(att.model.predict(feats), rel=1e-9)
    measured = {r.stage for r in att.rows if r.measured_s is not None}
    assert {"prefetch", "pack", "h2d", "dispatch", "device_compute", "interact"} <= measured
    assert att.bottleneck in measured
    assert sum(r.share for r in att.rows if r.share is not None) == pytest.approx(1.0)
    dc = next(r for r in att.rows if r.stage == "device_compute")
    assert dc.bytes_per_batch > 0 and dc.modeled_gbps > 0
    assert dc.residual_s == pytest.approx(dc.measured_s - dc.modeled_s)
    json.dumps(att.describe())


def test_report_build_render_write(runs, tmp_path):
    res, snap, events = runs["port", True]
    state = t_serve.build_serve_state(runs["cfg"], shards=4, alpha=1.05, seed=0,
                                      device="cpu")
    att = A.attribute(events, res["traffic_report"], state.eplan, batch=4, fenced=True)
    eng = obs.SLOEngine(obs.SLOSpec(p99_latency_s=1e-9, fast_window=1, slow_window=1,
                                    qps_floor=1e9))
    for lat in res["latencies_s"]:
        eng.observe(lat)
    eng.finalize(hit_rate=res["hit_rate"], qps=res["qps"])
    rep = P.build(snapshot=snap, slo_state=eng.state(), attribution=att,
                  traffic=res["traffic"],
                  results={"sequential": {k: v for k, v in res.items()
                                          if k not in t_serve._RECORD_DROP}},
                  flight_dumps=[{"path": "f.json", "reason": "slo_burn:page",
                                 "trigger_batch": 2, "records": 3}],
                  meta={"config": runs["arch"]})
    md_path, jpath = P.write(rep, str(tmp_path / "report.md"), attribution=att)
    md = open(md_path).read()
    assert "**BREACHED**" in md and f"**{att.bottleneck}" in md and "slo_burn:page" in md
    stored = json.load(open(jpath))
    assert stored["attribution"]["bottleneck"] == att.bottleneck
    assert P.render_markdown(stored).rstrip("\n") == md.rstrip("\n")


# ---------------------------------------------------------------------------
# the CLIs, the flight recorder on the loop, the disabled path, the imports
# ---------------------------------------------------------------------------

def _cli_args(out, *extra):
    return ["--arch", "dlrm-qr", "--smoke", "--mode", "both", *extra,
            "--metrics-json", str(out / "metrics.json"), "--trace-out", str(out / "trace.json"),
            "--slo", "p99_ms=50", "--report", str(out / "report.md"),
            "--flight-dir", str(out / "flight")]


def test_cli_telemetry_flags_match_repro(tmp_path, monkeypatch, capsys):
    """Both CLIs with all five flags: every artifact parses, the report has
    ``repro``'s keys, and the attribution rows the same stages, bytes and
    basis (the port's CLI serves ``repro``'s batches)."""
    jc = j_registry.get_dlrm("dlrm-qr-smoke")

    def repro_batch(cfg, batch, *, seed=0, step=0, alpha=1.05, device="cpu"):
        b = j_syn.dlrm_batch(jc, batch, seed=seed, step=step, alpha=alpha)
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    monkeypatch.setattr(t_syn, "dlrm_batch", repro_batch)
    docs = {}
    for pkg, main, extra in (("repro", j_serve.main, ()),
                             ("port", t_serve.main, ("--device", "cpu"))):
        out = tmp_path / pkg
        out.mkdir()
        assert main(_cli_args(out, *extra)) == 0
        printed = capsys.readouterr().out
        assert "[slo] serving:" in printed and "[attribution] bottleneck stage" in printed
        assert "modeled combine traffic/batch" in printed
        docs[pkg] = {name: json.loads((out / name).read_text())
                     for name in ("metrics.json", "trace.json", "report.json")}
        assert (out / "report.md").read_text().startswith("# Serving report")
        for f in (out / "flight").glob("*.json") if (out / "flight").exists() else ():
            json.loads(f.read_text())
        _wipe(j_obs)
        _wipe(obs)
    j, t = docs["repro"], docs["port"]
    assert set(j["report.json"]) <= set(t["report.json"])
    for key in ("attribution", "traffic", "metrics", "slo"):
        assert set(j["report.json"][key]) <= set(t["report.json"][key]), key
    jrows, trows = j["report.json"]["attribution"]["rows"], t["report.json"]["attribution"]["rows"]
    pick = lambda rows: [(r["stage"], r["bytes_per_batch"], r["basis"]) for r in rows]
    assert pick(trows) == pick(jrows)
    assert t["report.json"]["traffic"] == j["report.json"]["traffic"]
    assert t["report.json"]["attribution"]["fenced"] is True
    assert set(j["metrics.json"]) <= set(t["metrics.json"])
    assert {e["name"] for e in t["trace.json"]["traceEvents"]} == \
        {e["name"] for e in j["trace.json"]["traceEvents"]}


def test_cli_without_device_cpu_raises_here(monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_serve.main(_cli_args(tmp_path))
    assert not obs.enabled()                 # refused before telemetry turned on


def test_pipeline_breach_dumps_flight_window_matching_tracer(tmp_path):
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    obs.enable()
    eng = obs.SLOEngine(obs.SLOSpec(p99_latency_s=1e-9, objective=0.99,
                                    fast_window=2, slow_window=4))
    rec = obs.FlightRecorder(capacity=16, out_dir=str(tmp_path))
    obs.install_observatory(slo=eng, recorder=rec)
    res = t_serve.run_pipeline(cfg, batch=4, batches=6, mode="sequential", fence=True,
                               device="cpu")
    assert eng.n == len(res["latencies_s"]) == 5
    assert eng.breached and rec.dumps
    doc = json.load(open(rec.dumps[0]["path"]))
    assert doc["records"], "dump carries the ring"
    spans: dict = {}
    for ev in obs.tracer().events:
        if ev.get("ph") != "X" or ev["name"] == "batch":
            continue
        b = ev.get("args", {}).get("batch")
        if b is None:
            continue
        spans.setdefault(int(b), {}).setdefault(ev["name"], 0.0)
        spans[int(b)][ev["name"]] += ev["dur"] * 1e-6
    for r in doc["records"]:
        assert r["stages"], f"batch {r['batch']} record has no stages"
        assert r["stages"] == pytest.approx(spans[r["batch"]])
        # the first steady-state record's delta also covers the warm-up dispatch
        expect = 2 if r["batch"] == 1 else 1
        assert r["counters"].get("engine/dispatch/serve_gather") == expect
    state = obs.observatory().state()
    assert state["slo"]["breached"] and state["flight_dumps"]


def test_disabled_run_records_nothing():
    cfg = t_registry.get_dlrm("dlrm-tt-smoke")
    res = t_serve.run_pipeline(cfg, batch=4, batches=3, mode="overlap", device="cpu")
    snap = obs.snapshot()
    assert snap.counters == {} and snap.histograms == {} and snap.info == {}
    assert obs.tracer().events == []
    assert obs.span("prefetch", batch=1) is obs.NULL_SPAN
    assert res["traffic"]["batches"] == 3     # the record carries it all the same


def test_serve_rec_percentiles_are_the_shared_helper():
    from repro_torch.obs.metrics import exact_percentile, latency_percentiles

    assert t_serve._percentiles is obs.latency_percentiles
    assert not hasattr(t_serve, "latency_percentiles")
    samples = [0.001, 0.002, 0.003, 0.010, 0.020]
    got = latency_percentiles(samples)
    assert set(got) == {"lat_p50_s", "lat_p95_s", "lat_p99_s"}
    for q in (50, 95, 99):
        assert got[f"lat_p{q:g}_s"] == pytest.approx(np.percentile(samples, q))
    assert exact_percentile([], 99) == 0.0


def test_port_telemetry_imports_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.obs.attribution, repro_torch.obs.report\n"
        "import repro_torch.obs.traffic, repro_torch.tune.cost_model\n"
        "import repro_torch.launch.mesh, repro_torch.engine, repro_torch.launch.serve_rec\n"
        "import repro_torch.tune.tuner, repro_torch.serve, repro_torch.adapt.loop\n"
        "import repro_torch.distributed.elastic, repro_torch.examples.autotune_plan\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_serve_gather_uploads_the_combiner_scale_once(monkeypatch):
    """The first split on the card showed the embedding kernel's time
    inside ``dispatch``: ``serve_gather`` built its (T,) combiner scale from
    a Python list every batch, a blocking copy that waits for the launch
    before it.  The engine now uploads it once per device."""
    from repro_torch.core import packed_tables

    calls = []
    real = packed_tables.combiner_scale
    monkeypatch.setattr(packed_tables, "combiner_scale",
                        lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    res = t_serve.run_pipeline(cfg, batch=4, batches=4, mode="overlap", device="cpu")
    assert len(res["logits"]) == 4 and calls == [torch.device("cpu")]
