"""Port parity of the resilient front end: arrival, faults, the heartbeat,
the degradation ladder and ``Frontend.run``.

The same smoke configs, the same params (``repro``'s init carried across
with ``convert.params_from_numpy``) and the same seeds go through ``repro``
(Pallas kernels in interpret mode) and the port (the kernels' plain
versions).  Exact: the request streams (times, indices, dense features),
the fault injector's latched events and consumption, the ladder's
transitions for a burn sequence, and in ``service_mode="fixed"`` (one
virtual unit a batch, no wall clock) a whole session's counts, transitions
and hit rate, with ``unaccounted == 0``.  Within the port the kernel rungs
(full / nocache / pertable) are bitwise identical (``repro``'s contract).
Across packages the pooled output of each rung keeps the tolerances of
``tests/test_torch_serve.py``: the fp32 kernel rungs rtol = atol = 1e-5, the
bf16 ``baseline`` rung rtol = atol = 8e-3 (one bf16 step at 1.0).
"""

import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro import serve as j_serve  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.distributed import elastic as j_elastic  # noqa: E402
from repro.launch import serve_rec as j_rec  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as t_obs  # noqa: E402
from repro_torch import serve as t_serve  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core import embedding_bag  # noqa: E402
from repro_torch.distributed import elastic as t_elastic  # noqa: E402
from repro_torch.launch import serve_rec as t_rec  # noqa: E402
from repro_torch.serve.degrade import RUNGS  # noqa: E402
from repro_torch.serve.frontend import recovery_times  # noqa: E402

ARCHS = ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"]
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
SLO = "p99_ms=60,objective=0.99,fast_window=4,slow_window=8"


def _served(arch):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    jp, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jc)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js = j_rec.build_serve_state(jc, shards=4, alpha=1.05, seed=0)
    ts = t_rec.build_serve_state(tc, shards=4, alpha=1.05, seed=0, device="cpu")
    return {"repro": (jc, jp, js), "port": (tc, tp, ts)}


@pytest.fixture(scope="module")
def served():
    """dlrm-qr-smoke in both packages (plan + params shared by the module)."""
    return _served("dlrm-qr-smoke")


def _frontend(pkg, served, *, faults=None, **fkw):
    serve_mod, obs_mod = (j_serve, j_obs) if pkg == "repro" else (t_serve, t_obs)
    cfg, params, state = served[pkg]
    fkw.setdefault("batch_size", 8)
    fkw.setdefault("queue_cap", 32)
    fkw.setdefault("service_mode", "fixed")
    slo = obs_mod.SLOEngine(obs_mod.SLOSpec.parse(SLO))
    spec = serve_mod.FaultSpec.parse(faults) if faults else serve_mod.FaultSpec()
    return serve_mod.Frontend(cfg, serve_mod.FrontendConfig(**fkw), state, params,
                              slo=slo, faults=serve_mod.FaultInjector(spec))


def _arrivals(pkg, cfg, **kw):
    mod = j_serve if pkg == "repro" else t_serve
    flash = tuple(mod.FlashEpisode(*ep) for ep in kw.pop("flash", ()))
    return mod.generate(mod.ArrivalSpec(flash=flash, **kw), cfg)


# ---------------------------------------------------------------------------
# arrival, faults, heartbeat
# ---------------------------------------------------------------------------

ARRIVALS = [
    dict(rate_rps=500, horizon_s=1.0, seed=7, drift_period_s=0.3),
    dict(rate_rps=300, horizon_s=2.0, seed=3, flash=((0.5, 1.0, 8.0),)),
    dict(rate_rps=250, horizon_s=1.5, seed=9, alpha=1.1, deadline_s=0.1,
         drift_period_s=0.5, drift_fraction=0.3,
         flash=((0.2, 0.4, 6.0), (0.3, 0.2, 3.0))),
]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("case", range(len(ARRIVALS)))
def test_generate_equals_repro(arch, case):
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    a = _arrivals("repro", jc, **dict(ARRIVALS[case]))
    b = _arrivals("port", tc, **dict(ARRIVALS[case]))
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert (ra.rid, ra.t_arrive_s, ra.deadline_s) == (rb.rid, rb.t_arrive_s, rb.deadline_s)
        assert ra.idx.dtype == rb.idx.dtype and np.array_equal(ra.idx, rb.idx)
        assert ra.dense.dtype == rb.dense.dtype and np.array_equal(ra.dense, rb.dense)


def test_arrival_parse_equals_repro():
    text = ("rate=250,horizon=2,deadline_ms=100,alpha=1.1,"
            "flash=0.5+0.4x6,flash=1.2+0.2x3,drift_s=0.5,drift_frac=0.3,seed=9")
    a, b = j_serve.ArrivalSpec.parse(text), t_serve.ArrivalSpec.parse(text)
    assert a.describe() == b.describe()
    for t in (0.1, 0.6, 1.25, 1.9):
        assert a.rate_at(t) == b.rate_at(t)
    assert a.peak_rate == b.peak_rate
    with pytest.raises(ValueError, match="unknown --arrival key"):
        t_serve.ArrivalSpec.parse("bogus=1")
    with pytest.raises(ValueError, match="flash episode"):
        t_serve.ArrivalSpec.parse("flash=1.0")


FAULTS = [
    "stall@1.0:0.5,drop@1.5,replica@2.0:1.0,gather@3.0:2,retries=2,backoff_ms=10,hosts=3",
    "replica@0.4:0.3,replica@0.5:0.5,stall@0.45:0.1,gather@0.2:3,hb_deadline_ms=20",
    "drop@0.0,drop@0.1,drop@0.1,stall@0.3:0.2,stall@0.3:0.1",
]


def _fault_trace(mod, text):
    """Drive an injector over a fixed time grid; record everything it says."""
    inj = mod.FaultInjector(mod.FaultSpec.parse(text))
    out = []
    for t in np.arange(0.0, 3.6, 0.013):
        due = inj.advance(float(t))
        errs = 0
        while True:
            try:
                inj.check_gather()
                break
            except mod.TransientGatherError:
                errs += 1
        out.append(([e.describe() for e in due], inj.consume_stall_s(),
                    inj.consume_prefetch_drop(), errs, inj.replica_lost(),
                    inj.lost_hosts(), inj.exhausted()))
    return out, inj.injected, inj.spec.describe()


@pytest.mark.parametrize("text", FAULTS)
def test_fault_injector_sequences_equal_repro(text):
    assert _fault_trace(j_serve, text) == _fault_trace(t_serve, text)


def test_fault_parse_errors():
    with pytest.raises(ValueError, match="unknown fault kind"):
        t_serve.FaultSpec.parse("melt@1.0")
    with pytest.raises(ValueError, match="unknown --faults key"):
        t_serve.FaultSpec.parse("bogus=1")
    with pytest.raises(ValueError, match="KIND@T"):
        t_serve.FaultSpec.parse("stall")


def test_heartbeat_equals_repro():
    def drive(mod):
        clock = [0.0]
        hb = mod.Heartbeat(deadline_s=0.5, clock=lambda: clock[0])
        hb.register(7)
        out = []
        for i in range(40):
            clock[0] = i * 0.1
            for h in range(4):
                if not (h == 2 and 10 <= i < 25):
                    hb.beat(h, step=i)
            out.append((hb.failed_hosts(), hb.alive_hosts(), hb.min_step(),
                        hb.failed_hosts(now=clock[0] + 1.0)))
        return out

    assert drive(j_elastic) == drive(t_elastic)


# ---------------------------------------------------------------------------
# the ladder: transitions, rungs
# ---------------------------------------------------------------------------

def _burns(n=120, seed=0):
    rng = np.random.default_rng(seed)
    burn = rng.choice([0.0, 0.5, 2.0, 12.0, 60.0], size=n, p=[0.5, 0.15, 0.1, 0.15, 0.1])
    lost = np.zeros(n, bool)
    lost[30:45] = True
    lost[80:84] = True
    page = rng.random(n) < 0.05
    return burn, lost, page


@pytest.mark.parametrize("policy", [{}, dict(enter_burn=5.0, hysteresis_batches=3,
                                             probe_after=2),
                                    dict(floor_on_replica_loss="baseline")])
def test_ladder_transitions_equal_repro(served, policy):
    burn, lost, page = _burns()
    logs = {}
    for pkg, mod in (("repro", j_serve), ("port", t_serve)):
        _cfg, params, state = served[pkg]
        ladder = mod.DegradationLadder(state, params, mod.DegradePolicy(**policy))
        for i in range(len(burn)):
            alerts = [{"severity": "page"}] if page[i] else []
            ladder.on_batch(batch_i=i, now_s=i * 0.01, alerts=alerts,
                            fast_burn=float(burn[i]), replica_lost=bool(lost[i]))
        logs[pkg] = ladder.describe()
    assert logs["repro"] == logs["port"]
    assert len(logs["port"]["transitions"]) > 4


@pytest.fixture(scope="module", params=ARCHS)
def rung_outputs(request):
    """Every rung's pooled output on one batch, in both packages; the full
    rung with a staged cache (so it takes hits)."""
    both = _served(request.param)
    jc = both["repro"][0]
    idx = np.asarray(j_syn.dlrm_batch(jc, 8, seed=0, step=1)["idx"])
    out = {"arch": request.param, "both": both, "idx": idx}
    for pkg, mod in (("repro", j_serve), ("port", t_serve)):
        cfg, params, state = both[pkg]
        ladder = mod.DegradationLadder(state, params)
        scheds = state.fresh_schedulers()
        fe = mod.Frontend(cfg, mod.FrontendConfig(batch_size=8), state, params)
        rows = fe._rows_for(idx)
        for t in range(cfg.num_tables):
            scheds[t].prefetch(rows[:, t])
        hits = sum(int((scheds[t].slots_for(rows[:, t], record=False) >= 0).sum())
                   for t in range(cfg.num_tables))
        pooled = {}
        for rung in RUNGS[:-1]:
            ladder.rung_i = RUNGS.index(rung)
            p = ladder.pooled(idx, rows, scheds)
            pooled[rung] = (np.asarray(p) if pkg == "repro"
                            else p.float().numpy() if rung == "baseline" else p.numpy())
            pooled[rung + "_dtype"] = str(p.dtype)
        out[pkg] = pooled
        out[pkg + "_hits"] = hits
        out[pkg + "_ladder"] = ladder
    return out


def test_port_kernel_rungs_are_bitwise_identical(rung_outputs):
    p = rung_outputs["port"]
    assert rung_outputs["port_hits"] > 0, "the cache took no hits; the check is vacuous"
    assert p["full_dtype"] == p["nocache_dtype"] == p["pertable_dtype"] == "torch.float32"
    assert np.array_equal(p["full"], p["nocache"])
    assert np.array_equal(p["full"], p["pertable"])


def test_port_baseline_rung_is_the_semantic_loop(rung_outputs):
    cfg, params, state = rung_outputs["both"]["port"]
    p = rung_outputs["port"]
    ref = embedding_bag.multi_bag_lookup(
        params["tables"], torch.from_numpy(rung_outputs["idx"].copy()), list(state.bags))
    assert np.array_equal(p["baseline"], ref.float().numpy())
    np.testing.assert_allclose(p["baseline"], p["full"], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rung", RUNGS[:-1])
def test_rung_outputs_match_repro(rung_outputs, rung):
    a = np.asarray(rung_outputs["repro"][rung], dtype=np.float32)
    b = rung_outputs["port"][rung]
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, **(BF16_TOL if rung == "baseline" else FP32_TOL))
    assert rung_outputs["repro_hits"] == rung_outputs["port_hits"]


def test_pertable_rung_builds_one_engine_per_table(rung_outputs):
    ladder = rung_outputs["port_ladder"]
    paths = ladder._pertable_paths()
    assert len(paths) == len(ladder.state.bags)
    for eng_t, _packed, _zeros in paths:
        assert eng_t.plan.packed and eng_t.spec.num_tables == 1


def test_shedding_rung_refuses_to_dispatch(served):
    _cfg, params, state = served["port"]
    ladder = t_serve.DegradationLadder(state, params)
    ladder.rung_i = RUNGS.index("shed")
    with pytest.raises(RuntimeError, match="shedding"):
        ladder.pooled(np.zeros((2, 4, 32), np.int32), np.zeros((2, 4, 32), np.int64), [])


# ---------------------------------------------------------------------------
# Frontend.run in fixed mode: the same session as repro's
# ---------------------------------------------------------------------------

SESSIONS = {
    "chaos": (dict(rate_rps=300, horizon_s=2.0, deadline_s=0.25, seed=13,
                   flash=((0.4, 0.4, 6.0),)),
              "stall@0.5:0.5,drop@0.6,replica@0.8:0.3,gather@1.2:1,retries=3", {}),
    "reject_new": (dict(rate_rps=300, horizon_s=1.5, deadline_s=0.25, seed=4,
                        flash=((0.4, 0.5, 8.0),)), None,
                   dict(shed_policy="reject_new", queue_cap=16)),
    "drop_oldest": (dict(rate_rps=300, horizon_s=1.5, deadline_s=0.25, seed=4,
                         flash=((0.4, 0.5, 8.0),)), None,
                    dict(shed_policy="drop_oldest", queue_cap=16, queue_order="edf")),
    "abandon": (dict(rate_rps=300, horizon_s=0.5, seed=2), "gather@0.0:10,retries=2", {}),
}


def _session_record(rep):
    return {
        "requests": rep["requests"],
        "transitions": rep["degrade"]["transitions"],
        "batches_at": rep["degrade"]["batches_at"],
        "rung": rep["degrade"]["rung"],
        "hit_rate": rep["hit_rate"],
        "faults_injected": rep["faults_injected"],
        "recoveries_s": rep["recoveries_s"],
        "req_lat_p99_s": rep["req_lat_p99_s"],
        "virtual_end_s": rep["virtual_end_s"],
        "slo_observations": rep["slo"]["observations"],
    }


@pytest.mark.parametrize("name", list(SESSIONS))
def test_frontend_fixed_session_equals_repro(served, name):
    arrival, faults, fkw = SESSIONS[name]
    recs = {}
    for pkg in ("repro", "port"):
        fe = _frontend(pkg, served, faults=faults, **fkw)
        rep = fe.run(_arrivals(pkg, served[pkg][0], **dict(arrival)))
        assert rep["requests"]["unaccounted"] == 0
        assert rep["calibration"]["service_mode"] == "fixed"
        recs[pkg] = _session_record(rep)
    assert recs["port"] == recs["repro"]
    st = recs["port"]["requests"]
    if name == "chaos":
        trs = recs["port"]["transitions"]
        assert any(RUNGS.index(t["to"]) > RUNGS.index(t["from"]) for t in trs)
        assert recs["port"]["rung"] == "full" and recs["port"]["recoveries_s"]
    elif name == "abandon":
        assert st["abandoned"] >= 1
    else:
        assert st["shed_total"] > 0 and st["served"] > 0


def test_a_launch_error_propagates_and_is_not_retried(served, monkeypatch):
    """Only the injector's TransientGatherError is retried: another error
    of the launch surfaces out of Frontend.run, counted as no retry and
    moving no rung."""
    cfg, _params, state = served["port"]
    fe = _frontend("port", served)
    fe.calibrate()

    def broken(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(state.engine, "serve_gather", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fe.run(_arrivals("port", cfg, rate_rps=300, horizon_s=0.3, seed=1))
    assert fe.stats.retries == 0 and fe.stats.abandoned == 0
    assert fe.ladder.rung == "full" and fe.ladder.transitions == []


def test_measured_mode_calibrates_on_wall_time(served):
    fe = _frontend("port", served, service_mode="measured")
    s0 = fe.calibrate()
    assert s0 > 0 and fe._service_s(2 * s0) == pytest.approx(2 * fe.fcfg.service_unit_s)
    rep = fe.run(_arrivals("port", served["port"][0], rate_rps=200, horizon_s=0.3, seed=5))
    assert rep["requests"]["unaccounted"] == 0
    assert rep["calibration"]["s0_wall_s"] == s0


def test_recovery_times_helper():
    trs = [
        {"from": "full", "to": "nocache", "t_s": 1.0},
        {"from": "nocache", "to": "pertable", "t_s": 1.5},
        {"from": "pertable", "to": "nocache", "t_s": 2.0},
        {"from": "nocache", "to": "full", "t_s": 3.0},
        {"from": "full", "to": "nocache", "t_s": 5.0},   # unfinished episode
    ]
    assert recovery_times(trs) == [2.0]
    assert recovery_times([]) == []


def test_cli_frontend_record_equals_repro(tmp_path, capsys):
    argv = ["--arch", "dlrm-qr", "--smoke", "--frontend",
            "--arrival", "rate=400,horizon=1.5,flash=0.4+0.4x6",
            "--faults", "stall@0.5:0.4,drop@0.6,replica@0.7:0.3,gather@0.9:1",
            "--service-mode", "fixed", "--queue-cap", "24"]
    recs = {}
    for pkg, mod, extra in (("repro", j_rec, []), ("port", t_rec, ["--device", "cpu"])):
        path = tmp_path / f"{pkg}.json"
        try:
            assert mod.main(argv + extra + ["--json", str(path)]) == 0
        finally:
            for facade in (j_obs, t_obs):
                facade.disable()
                facade.install_observatory()
        (rec,) = json.loads(path.read_text())
        assert rec["mode"] == "frontend" and rec["requests"]["unaccounted"] == 0
        recs[pkg] = _session_record(rec)
    assert recs["port"] == recs["repro"]
    out = capsys.readouterr().out
    assert "[degrade] final rung" in out and "[frontend]" in out
