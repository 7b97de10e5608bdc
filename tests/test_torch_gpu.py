"""The port's CUDA kernels on the card, and the CPU-side pieces of their build.

Tests marked ``gpu`` hold K1 ``packed_qr_bag``, K3 ``packed_bag``, K2
``packed_tt_bag``, K5 ``tt_bag`` (fp32 and bf16), the per-table kernels
K4a ``cached_bag``, K4b ``cached_qr_bag``, K6 ``gnr_bag``, K7
``gnr_bag_dense`` and K8 ``qr_gather``, and the attention kernel K9
``flash_fwd`` against their plain PyTorch versions on the card (the
redesigned bodies — K9 bf16 on the tensor cores, K2/K5 in sorted runs — also
by the one-rounding rule of ``chip_smoke.py``); hold the
gradients of the training entries (the kernels' forward, the plain
versions' recompute backward) and of ``flash_mha`` against plain autograd;
serve the smoke configs there and run the two per-table examples;
each decides inside the ``cuda`` fixture whether a card exists, and skips
without one.  Run them on the card with
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports no jax:
the machine with the card has none.

Tolerance on the card: rtol = atol = 1e-4 (K fp32 adds of unit-scale rows
in two different orders, and for TT two fp32 products of rank terms each,
fused multiply-adds in the kernel; the dlrm-width error measured by
chip_smoke.py is about 1e-5).  In bf16, kernel and plain version both sum
in fp32 and round once to bf16; the two fp32 sums may straddle a rounding
boundary, so they may differ by one bf16 step: rtol = atol = 1e-2 (a step
is at most 2**-7 of the value).
"""

import dataclasses
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import tt_embedding  # noqa: E402
from repro_torch.core import embedding_bag  # noqa: E402
from repro_torch.engine import EngineSpec, engine_for  # noqa: E402
from repro_torch.examples import cache_plan, quickstart  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import cached_gather as cg  # noqa: E402
from repro_torch.kernels import gnr_bag as gb  # noqa: E402
from repro_torch.kernels import packed_gather as pg  # noqa: E402
from repro_torch.kernels import qr_gather as qg  # noqa: E402
from repro_torch.kernels import tt_gather as tg  # noqa: E402
from repro_torch.launch import serve_rec  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from torch_bag_inputs import CASES, bag_inputs, dense_args, qr_args  # noqa: E402
import torch_pertable_inputs as pti  # noqa: E402
from torch_tt_inputs import (  # noqa: E402
    CASES as TT_CASES, DLRM_DIMS, SMOKE_DIMS, packed_tt_args, packed_tt_inputs,
    tt_args, tt_inputs,
)


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# one bf16 step (2**-7 of the value) between two fp32 sums rounded once each
PT_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


# ---------------------------------------------------------------------------
# the build, on any machine
# ---------------------------------------------------------------------------

def test_build_names_a_library_per_source_and_flags(monkeypatch):
    a = build._target("packed_gather")
    assert a.parent == build.BUILD_DIR and a.name.startswith("libpacked_gather-")
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build._target("packed_gather") != a       # new flags, new library
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["packed_gather"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

GPU_SHAPES = [
    dict(rows=100_000, r_rows=1_665, slots=16_384, g=2048, k=32, dim=128),
    dict(rows=1_000, r_rows=17, slots=50, g=37, k=40, dim=160),   # K > 32, dim > 128
    dict(rows=1_000, r_rows=17, slots=50, g=5, k=3, dim=12),      # dim < 128
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", range(len(GPU_SHAPES)))
def test_gpu_kernels_match_plain(cuda, case, shape):
    a = bag_inputs(case, seed=shape, **GPU_SHAPES[shape])
    to = lambda x: torch.from_numpy(x).to(cuda)
    pg.reset_launches()
    qr = pg.packed_qr_bag(*qr_args(a, to))
    dense = pg.packed_bag(*dense_args(a, to))
    torch.cuda.synchronize()
    assert pg.LAUNCHES == {"packed_qr_bag": 1, "packed_bag": 1, "packed_tt_bag": 0}
    torch.testing.assert_close(qr, ref.packed_qr_bag_ref(*qr_args(a, to)),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(dense, ref.packed_bag_ref(*dense_args(a, to)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gpu_wrappers_raise_on_what_the_kernel_does_not_take(cuda):
    a = bag_inputs("mixed")
    to = lambda x: torch.from_numpy(x).to(cuda)
    args = dense_args(a, to)
    bad = [
        (0, args[0].to(torch.bfloat16), "float32"),
        (2, args[2].to(torch.int64), "int32"),
        (2, args[2][:, :4].contiguous(), "stream shapes"),
        (0, args[0][:, :30].contiguous(), "widths differ"),
        (0, args[0].t().contiguous().t(), "contiguous"),
        (1, args[1].cpu(), "different devices"),
    ]
    pg.reset_launches()
    for i, val, match in bad:
        call = list(args)
        call[i] = val
        with pytest.raises(ValueError, match=match):
            pg.packed_bag(*call)
    assert pg.LAUNCHES["packed_bag"] == 0


TT_SHAPES = [
    dict(dims=DLRM_DIMS, tables=26, v1=38, v2=1408, v3=38, slots=1024, g=1024, k=32),
    dict(dims=DLRM_DIMS, tables=2, v1=5, v2=40, v3=5, slots=16, g=7, k=40),  # K > 32
    dict(dims=SMOKE_DIMS, tables=4, v1=8, v2=64, v3=8, slots=64, g=33, k=8),
    dict(dims=(2, 3, 2, 3), tables=2, v1=4, v2=9, v3=4, slots=5, g=6, k=3),  # width 18
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TT_CASES)
@pytest.mark.parametrize("shape", range(len(TT_SHAPES)))
def test_gpu_tt_kernels_match_plain(cuda, case, shape):
    kw = dict(TT_SHAPES[shape])
    dims = kw["dims"]
    a = packed_tt_inputs(case, seed=shape, **kw)
    to = lambda x: torch.from_numpy(x).to(cuda)
    pg.reset_launches()
    tg.reset_launches()
    got = pg.packed_tt_bag(*packed_tt_args(a, to), dims=dims)
    one = tt_inputs(dims=dims, v1=kw["v1"], v2=kw["v2"], v3=kw["v3"], b=kw["g"],
                    k=kw["k"], seed=shape)
    got5 = tg.tt_bag(*tt_args(one, to), dims=dims)
    torch.cuda.synchronize()
    assert pg.LAUNCHES["packed_tt_bag"] == 1 and tg.LAUNCHES["tt_bag"] == 1
    torch.testing.assert_close(got, ref.packed_tt_bag_ref(*packed_tt_args(a, to), dims=dims),
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got5, ref.tt_bag_ref(*tt_args(one, to), dims=dims),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gpu_tt_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = packed_tt_inputs("mixed", dims=SMOKE_DIMS)
    to = lambda x: torch.from_numpy(x).to(cuda)
    args = packed_tt_args(a, to)
    bad = [
        (1, args[1].to(torch.float16), "float32 or bfloat16"),
        (1, args[1].to(torch.bfloat16), "dtypes differ"),
        (5, args[5].to(torch.int64), "int32"),
        (7, args[7][:, :4].contiguous(), "stream shapes"),
        (3, args[3][:, :32].contiguous(), "width"),
        (0, args[0][:, :8].contiguous(), "width"),
        (2, args[2].cpu(), "different devices"),
    ]
    pg.reset_launches()
    tg.reset_launches()
    for i, val, match in bad:
        call = list(args)
        call[i] = val
        with pytest.raises(ValueError, match=match):
            pg.packed_tt_bag(*call, dims=SMOKE_DIMS)
    with pytest.raises(ValueError, match="exceeds"):
        pg.packed_tt_bag(*args, dims=(8, 8, 32, 1))
    one = tt_args(tt_inputs(dims=SMOKE_DIMS), to)
    for i, val, match in [(0, one[0].to(torch.float16), "float32 or bfloat16"),
                          (3, one[3].to(torch.int64), "int32"),
                          (2, one[2][:, :4].contiguous(), "width")]:
        call = list(one)
        call[i] = val
        with pytest.raises(ValueError, match=match):
            tg.tt_bag(*call, dims=SMOKE_DIMS)
    assert pg.LAUNCHES["packed_tt_bag"] == 0 and tg.LAUNCHES["tt_bag"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", TT_CASES)
@pytest.mark.parametrize("shape", range(len(TT_SHAPES)))
def test_gpu_tt_kernels_bf16_match_plain(cuda, case, shape):
    kw = dict(TT_SHAPES[shape])
    dims = kw["dims"]
    to = lambda x: torch.from_numpy(x).to(cuda)
    half = lambda args: [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
    args = half(packed_tt_args(packed_tt_inputs(case, seed=shape, **kw), to))
    one = half(tt_args(tt_inputs(dims=dims, v1=kw["v1"], v2=kw["v2"], v3=kw["v3"],
                                 b=kw["g"], k=kw["k"], seed=shape), to))
    pg.reset_launches()
    tg.reset_launches()
    got = pg.packed_tt_bag(*args, dims=dims)
    got5 = tg.tt_bag(*one, dims=dims)
    torch.cuda.synchronize()
    assert pg.LAUNCHES["packed_tt_bag"] == 1 and tg.LAUNCHES["tt_bag"] == 1
    assert got.dtype == got5.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref.packed_tt_bag_ref(*args, dims=dims).float(),
                               **PT_TOL[torch.bfloat16])
    torch.testing.assert_close(got5.float(), ref.tt_bag_ref(*one, dims=dims).float(),
                               **PT_TOL[torch.bfloat16])


@pytest.mark.gpu
def test_gpu_tt_lookup_runs_the_kernel(cuda):
    cfg = dlrm.make_bags(registry.get_dlrm("dlrm-tt-smoke"))[0].emb
    params = tt_embedding.init(cfg, generator=torch.Generator(cuda).manual_seed(0),
                               device=cuda)
    idx = torch.randint(0, cfg.vocab, (16, 8), device=cuda, dtype=torch.int32)
    tg.reset_launches()
    got = tt_embedding.lookup(params, idx, cfg)
    assert tg.LAUNCHES["tt_bag"] == 1 and got.dtype == cfg.compute_dtype
    plain = tt_embedding.lookup(params, idx, dataclasses.replace(
        cfg, compute_dtype=torch.float32, tt_exec="jnp"))
    torch.testing.assert_close(got.float(), plain.to(cfg.compute_dtype).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"])
def test_gpu_serving_overlap_matches_sequential(cuda, arch):
    cfg = registry.get_dlrm(arch)
    name = {"qr": "packed_qr_bag", "dense": "packed_bag",
            "tt": "packed_tt_bag"}[cfg.embedding_kind]
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=cuda)
    params = dlrm.init_dlrm(cfg, seed=0, device=cuda)
    res = {}
    for mode in ("sequential", "overlap"):
        pg.reset_launches()
        res[mode] = serve_rec.run_pipeline(cfg, batch=8, batches=4, mode=mode,
                                           state=state, params=params, device=cuda)
        assert pg.LAUNCHES[name] == 4
    for a, b in zip(res["sequential"]["logits"], res["overlap"]["logits"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        assert np.isfinite(a).all()


@pytest.mark.gpu
def test_gpu_serving_telemetry_fenced(cuda):
    """dlrm-qr-smoke served on the card with telemetry on and fenced: every
    span of each steady-state batch, one dispatch counter and one K1 launch
    a batch, and the fence's wait for the embedding layer takes time."""
    from repro_torch import obs

    cfg = registry.get_dlrm("dlrm-qr-smoke")
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=cuda)
    params = dlrm.init_dlrm(cfg, seed=0, device=cuda)
    pg.reset_launches()
    obs.enable()
    try:
        res = serve_rec.run_pipeline(cfg, batch=8, batches=4, mode="sequential",
                                     state=state, params=params, device=cuda, fence=True)
        events = list(obs.tracer().events)
        snap = obs.snapshot()
    finally:
        obs.disable()
        obs.registry().reset()
        obs.tracer().reset()
    assert pg.LAUNCHES["packed_qr_bag"] == 4
    assert snap.counters["engine/dispatch/serve_gather"] == 4
    assert snap.counters["serve/sequential/batches"] == 3
    assert snap.histograms["serve/sequential/batch_latency_s"].count == 3
    spans: dict = {}
    for ev in events:
        b = ev.get("args", {}).get("batch")
        if ev["ph"] == "X" and b is not None:
            spans.setdefault(b, {}).setdefault(ev["name"], []).append(ev["dur"])
    for t in (1, 2, 3):
        assert {"prefetch", "pack", "h2d", "dispatch", "device_compute", "interact",
                "device_head", "block", "batch"} <= set(spans[t])
        assert spans[t]["device_compute"][0] > 0
    assert res["traffic"]["hit_rate"] == res["hit_rate"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-tt-smoke"])
def test_gpu_serve_gather_does_not_wait_for_the_card(cuda, arch):
    """``serve_gather`` only enqueues: behind a ~0.5 s spin on the card the
    host returns from it long before the spin ends (it used to wait for its
    own launch in a blocking upload of the combiner scale, and for earlier
    work in those of the stream offsets)."""
    cfg = registry.get_dlrm(arch)
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=cuda)
    params = dlrm.init_dlrm(cfg, seed=0, device=cuda)
    eng = state.engine
    packed = eng.pack(params["tables"])
    scheds = state.fresh_schedulers()
    idx = np.asarray(serve_rec._host_batch(
        serve_rec.synthetic.dlrm_batch(cfg, 8, seed=0), cuda)["idx"])
    rows = [serve_rec.big_rows(idx[:, t], state.bags[t].emb) for t in range(cfg.num_tables)]
    for s, r in zip(scheds, rows):
        s.prefetch(r)
    slot = np.stack([s.slots_for(r) for s, r in zip(scheds, rows)], axis=1)
    args = [torch.from_numpy(a).to(cuda) for a in (idx, slot, eng.packed_cache_rows(scheds))]
    eng.serve_gather(packed, *args)                  # warm: builds, uploads the scale
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e9))      # ~0.5 s of work ahead in the stream (SM clock ~2 GHz)
    t0 = time.perf_counter()
    out = eng.serve_gather(packed, *args)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    assert total_s > 0.2 and host_s < total_s / 4, (host_s, total_s)
    assert torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# the per-table kernels K4a, K4b, K6, K7, K8
# ---------------------------------------------------------------------------

PT_SHAPES = [
    dict(lead=(2048,), k=32, dim=128, rows=31_360, r_rows=64, slots=1024),  # dlrm-qr
    dict(lead=(37,), k=40, dim=640, rows=500, r_rows=17, slots=50),    # K > 32, dim > 128
    dict(lead=(5, 3), k=3, dim=130, rows=300, r_rows=9, slots=20),     # even, not 4-aligned
    dict(lead=(9,), k=5, dim=13, rows=64, r_rows=5, slots=8),          # odd dim
]


def _pertable_all(a, to, tt):
    """Each per-table wrapper and its plain version on the same inputs."""
    flat = {k: v.reshape(-1) for k, v in a.items() if v.dtype == np.int32}
    flat_args = lambda: [tt(to(a["table"])), tt(to(a["r_lut"])),
                         to(flat["idx"]), to(flat["r_idx"])]
    lead = a["idx"].shape[:-1]
    two = lambda x: {k: (v.reshape(-1, v.shape[-1]) if v.dtype == np.int32 else v)
                     for k, v in x.items()}
    b = two(a)
    return [
        ("cached_bag", cg.cached_bag, ref.cached_bag_ref, pti.cached_args(b, to, tt)),
        ("cached_qr_bag", cg.cached_qr_bag, ref.cached_qr_bag_ref,
         pti.cached_qr_args(b, to, tt)),
        ("gnr_bag", gb.gnr_bag, ref.gnr_bag_ref, pti.qr_args(b, to, tt)),
        ("gnr_bag_dense", gb.gnr_bag_dense, ref.dense_bag_ref, pti.dense_args(b, to, tt)),
        ("qr_gather", qg.qr_gather, ref.qr_lookup_ref, flat_args()),
    ], lead


def _reset_pertable():
    cg.reset_launches()
    gb.reset_launches()
    qg.reset_launches()


def _pertable_launches():
    return {**cg.LAUNCHES, **gb.LAUNCHES, **qg.LAUNCHES}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", range(len(PT_SHAPES)))
def test_gpu_pertable_kernels_match_plain(cuda, dtype, shape):
    a = pti.pertable_inputs(seed=shape, **PT_SHAPES[shape])
    to = lambda x: torch.from_numpy(x).to(cuda)
    cases, _lead = _pertable_all(a, to, lambda x: x.to(dtype))
    _reset_pertable()
    for name, kern, plain, args in cases:
        got = kern(*args)
        torch.cuda.synchronize()
        assert got.dtype == dtype, name
        torch.testing.assert_close(got.float(), plain(*args).float(), **PT_TOL[dtype],
                                   msg=lambda m, n=name: f"{n}: {m}")
    assert _pertable_launches() == {name: 1 for name, *_ in cases}


@pytest.mark.gpu
def test_gpu_pertable_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = pti.pertable_inputs(dim=12)
    to = lambda x: torch.from_numpy(x).to(cuda)
    cases, _lead = _pertable_all(a, to, lambda x: x)
    _reset_pertable()
    for name, kern, _plain, args in cases:
        s = len(args) - 1                             # an index stream
        misaligned = torch.empty(args[0].numel() + 3, device=cuda)[3:]
        misaligned = misaligned.view(args[0].shape).copy_(args[0])   # 12 B past 16
        bad = [
            (0, args[0].to(torch.float16), "float32 or bfloat16"),
            (s, args[s].to(torch.int64), "int32"),
            (s, args[s].t() if args[s].dim() == 2 else args[s][::2], "int32|shapes"),
            (1, args[1].cpu(), "different devices"),
            (0, misaligned, "16-byte aligned"),
        ]
        if args[1].is_floating_point():               # a second buffer
            bad.append((1, args[1].to(torch.bfloat16), "dtypes differ"))
        for i, val, match in bad:
            call = list(args)
            call[i] = val
            with pytest.raises(ValueError, match=match):
                kern(*call)
    assert set(_pertable_launches().values()) == {0}


@pytest.mark.gpu
def test_gpu_examples_launch_their_kernels(cuda):
    pg.reset_launches()
    _reset_pertable()
    quickstart.main(["--device", "cuda"])
    assert gb.LAUNCHES["gnr_bag"] == 1 and pg.LAUNCHES["packed_qr_bag"] == 1
    _reset_pertable()
    res = cache_plan.main(["--device", "cuda"])
    assert cg.LAUNCHES["cached_qr_bag"] == res["batches"] == 4


# ---------------------------------------------------------------------------
# K9: attention
# ---------------------------------------------------------------------------

# fp32: the kernel and the plain version sum the scores, the softmax and p.v
# in different orders (measured ~1e-6); repro's own flash tolerance
FLASH_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: PT_TOL[torch.bfloat16]}
FLASH_SEQS = [(1, 1), (1, 127), (127, 1), (127, 127), (1, 4096), (127, 4096),
              (4096, 127), (4096, 4096)]


def _qkv(cuda, b, h, kh, sq, skv, d, dtype, seed=0):
    g = torch.Generator(cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)
    return mk(b, h, sq, d), mk(b, kh, skv, d), mk(b, kh, skv, d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 80])
@pytest.mark.parametrize("group,kv_heads", [(1, 2), (6, 2), (48, 1)])
def test_gpu_flash_matches_plain(cuda, dtype, d, group, kv_heads):
    fa.reset_launches()
    n = 0
    for sq, skv in FLASH_SEQS:
        for causal in (True, False):
            q, k, v = _qkv(cuda, 1, group * kv_heads, kv_heads, sq, skv, d, dtype, seed=sq)
            got = fa.flash_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            n += 1
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(
                got.float(), ref.flash_fwd_ref(q, k, v, causal=causal).float(),
                **FLASH_TOL[dtype], msg=lambda m: f"Sq {sq} Skv {skv} causal {causal}: {m}")
    assert fa.LAUNCHES["flash_fwd"] == n


@pytest.mark.gpu
def test_gpu_flash_odd_head_dim_and_wide_head(cuda):
    """D % 4 != 0 takes the scalar loads; D 256 the widest bucket."""
    for d, dtype in ((13, torch.float32), (13, torch.bfloat16), (256, torch.float32)):
        q, k, v = _qkv(cuda, 2, 4, 2, 100, 300, d, dtype)
        for causal in (True, False):
            got = fa.flash_fwd(q, k, v, causal=causal)
            torch.testing.assert_close(got.float(),
                                       ref.flash_fwd_ref(q, k, v, causal=causal).float(),
                                       **FLASH_TOL[dtype])


@pytest.mark.gpu
def test_gpu_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 4, 2, 16, 16, 64, torch.float32)
    fa.reset_launches()
    bad = [
        ((q.half(), k.half(), v.half()), "float32 or bfloat16"),
        ((q, k.to(torch.bfloat16), v), "dtypes differ"),
        ((q, k[:, :1].repeat(1, 3, 1, 1), v[:, :1].repeat(1, 3, 1, 1)), "multiple"),
        ((q, k.cpu(), v.cpu()), "different devices"),
        ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), "contiguous"),
        (_qkv(cuda, 1, 2, 1, 4, 4, 260, torch.float32), "exceeds"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            fa.flash_fwd(*args)
    assert fa.LAUNCHES["flash_fwd"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_gpu_flash_mha_grads_match_plain_autograd(cuda, causal):
    q, k, v = _qkv(cuda, 2, 6, 2, 256, 384, 64, torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    w = torch.randn_like(q)
    fa.reset_launches()
    (fa.flash_mha(*leaves, causal) * w).sum().backward()
    assert fa.LAUNCHES["flash_fwd"] == 1
    (ref.flash_fwd_ref(*plain, causal=causal) * w).sum().backward()
    for a, b in zip(leaves, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the redesigned bodies: K9 bf16 on the tensor cores, K2/K5 in sorted runs,
# held as chip_smoke.py holds them (fp32 to 1e-4; bf16 per element within
# one rounding of the plain version computed in fp32 on the same inputs)
# ---------------------------------------------------------------------------

def _rounding_ratio(out: torch.Tensor, plain32: torch.Tensor) -> float:
    """chip_smoke.one_rounding: worst |out - plain32| over 2^-8 |plain32| +
    1e-5 max|plain32|."""
    p = plain32.float()
    d = (out.float() - p).abs()
    atol = max(1e-5 * float(p.abs().max()), 1e-30)
    return float((d / (p.abs() * 2.0 ** -8 + atol)).max())


def _hold(got, plain, args, what):
    if got.dtype == torch.float32:
        err = float((got - plain(*args)).abs().max())
        assert err <= 1e-4, f"{what}: max abs error {err}"
        return
    wide = [a.float() if a.is_floating_point() else a for a in args]
    ratio = _rounding_ratio(got, plain(*wide))
    assert got.dtype == torch.bfloat16 and ratio <= 1.0, f"{what}: {ratio} of one rounding"


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128, 256, 13])
@pytest.mark.parametrize("group,kv_heads", [(1, 2), (6, 2), (48, 1)])
def test_gpu_flash_bf16_tensor_cores_hold_one_rounding(cuda, d, group, kv_heads):
    """The bf16 body: every head dim bucket and an odd D (ordinary loads),
    G 1/6/48, ragged Skv, Sq != Skv, causal and not."""
    fa.reset_launches()
    n = 0
    for sq, skv in ((1, 1), (127, 300), (300, 127), (256, 256), (64, 1000)):
        for causal in (True, False):
            q, k, v = _qkv(cuda, 2, group * kv_heads, kv_heads, sq, skv, d, torch.bfloat16,
                           seed=sq + d)
            got = fa.flash_fwd(q, k, v, causal=causal)
            torch.cuda.synchronize()
            n += 1
            assert got.shape == q.shape
            _hold(got, lambda *a: ref.flash_fwd_ref(*a, causal=causal), (q, k, v),
                  f"D {d} G {group} Sq {sq} Skv {skv} causal {causal}")
    assert fa.LAUNCHES["flash_fwd"] == n


def _stream(case, dims, g, k, seed=0):
    """Packed K2 inputs whose middle-core stream is all hits, all misses,
    one G2 row for every element, or a different G2 row for every element."""
    d1, d2, d3, rank = dims
    a = packed_tt_inputs("all_hit" if case == "all_hit" else "all_miss", dims=dims, tables=1,
                         v1=7, v2=max(g * k, 8), v3=7, slots=16, g=g, k=k, seed=seed)
    if case == "one_row":
        a["i2"][:] = 3
    elif case == "distinct":
        a["i2"] = np.random.default_rng(seed).permutation(g * k).reshape(g, k).astype(np.int32)
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["all_hit", "all_miss", "one_row", "distinct"])
@pytest.mark.parametrize("dims,g,k", [(DLRM_DIMS, 300, 32), (DLRM_DIMS, 1, 50),
                                      (DLRM_DIMS, 777, 1), (SMOKE_DIMS, 100, 8)])
def test_gpu_tt_sorted_runs_hold_the_plain_version(cuda, dtype, case, dims, g, k):
    """K2 and K5 on streams that give the run walk its extremes: every
    element on one middle row (one long run), every element on its own row
    (runs of one), all hits and all misses; G = 1 and K = 1."""
    to = lambda x: torch.from_numpy(x).to(cuda)
    cast = lambda xs: [x.to(dtype) if x.is_floating_point() else x for x in xs]
    a = cast(packed_tt_args(_stream(case, dims, g, k), to))
    one = [a[0], a[1], a[2], a[4], a[5], a[6]]
    if case == "all_hit":
        one[4] = a[7].clone()                       # K5 on the slots as its G2 rows
    pg.reset_launches()
    tg.reset_launches()
    got = pg.packed_tt_bag(*a, dims=dims)
    got5 = tg.tt_bag(*one, dims=dims)
    torch.cuda.synchronize()
    assert pg.LAUNCHES["packed_tt_bag"] == 1 and tg.LAUNCHES["tt_bag"] == 1
    assert got.shape == got5.shape == (g, dims[0] * dims[1] * dims[2])
    _hold(got, lambda *x: ref.packed_tt_bag_ref(*x, dims=dims), a, f"K2 {case}")
    _hold(got5, lambda *x: ref.tt_bag_ref(*x, dims=dims), one, f"K5 {case}")
    # fp32 FMAs in depth order: bitwise the plain version's on the card
    assert torch.equal(got, ref.packed_tt_bag_ref(*a, dims=dims))
    assert torch.equal(got5, ref.tt_bag_ref(*one, dims=dims))


# ---------------------------------------------------------------------------
# gradients: the kernels' forward, the plain versions' recompute backward
# ---------------------------------------------------------------------------

def _bf16_exact(t: torch.Tensor) -> torch.Tensor:
    """A cotangent whose values bf16 holds exactly, so a bf16 output's
    gradient carries no rounding of its own."""
    return t.to(torch.bfloat16).float()


def _bag_cases(a, t2, one, dims):
    """(kernel, entry, plain, buffers, streams, kw) for K1, K3, K2, K5."""
    packed = lambda kind, bufs, streams: (
        lambda *x, **kw: ops.packed_multi_pooled(
            dict(zip(bufs, x[:len(bufs)])), dict(zip(streams, x[len(bufs):])), kind=kind,
            **kw))
    return [
        ("packed_qr_bag", packed("qr", ("q", "cache", "r"), ("q_idx", "slot", "r_idx")),
         ref.packed_qr_bag_ref, a[:3], a[3:], {}),
        ("packed_bag", packed("dense", ("table", "cache"), ("idx", "slot")),
         ref.packed_bag_ref, [a[0], a[1]], [a[3], a[4]], {}),
        ("packed_tt_bag", packed("tt", ("g1", "g2", "g3", "cache"), ("i1", "i2", "i3", "slot")),
         ref.packed_tt_bag_ref, t2[:4], t2[4:], {"dims": dims}),
        ("tt_bag", lambda *x, **kw: ops.tt_pooled_auto(*x, exec_mode="pallas", **kw),
         ref.tt_bag_ref, one[:3], one[3:], {"dims": dims}),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(4))
def test_gpu_bag_kernel_grads_match_plain(cuda, dtype, case):
    """Gradients through K1, K3, K2 and K5 (the ops entries: kernel forward,
    chunked plain-version recompute backward in fp32) equal autograd
    through the plain versions on the same card tensors, in fp32 to 1e-4;
    in bf16 they lie within one bf16 rounding of the exact gradient, plain
    autograd on the buffers widened to fp32 (``_rounding_ratio``).  The
    forward launches the kernel once and the backward launches none."""
    to = lambda x: torch.from_numpy(x).to(cuda)
    cast = lambda xs: [x.to(dtype) if x.is_floating_point() else x for x in xs]
    a = cast(qr_args(bag_inputs("mixed", **GPU_SHAPES[0]), to))
    t2 = cast(packed_tt_args(packed_tt_inputs("mixed", **TT_SHAPES[0]), to))
    one = cast(tt_args(tt_inputs(dims=DLRM_DIMS, v1=38, v2=1408, v3=38, b=512, k=32), to))
    name, fn, plain, bufs, streams, kw = _bag_cases(a, t2, one, DLRM_DIMS)[case]
    lhs = [b.clone().requires_grad_(True) for b in bufs]
    rhs = [b.clone().requires_grad_(True) for b in bufs]
    pg.reset_launches()
    tg.reset_launches()
    out = fn(*lhs, *streams, **kw)
    w = _bf16_exact(torch.randn(out.shape, device=cuda))
    (out.float() * w).sum().backward()
    torch.cuda.synchronize()
    assert {**pg.LAUNCHES, **tg.LAUNCHES}[name] == 1
    assert sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values()) == 1
    if dtype == torch.bfloat16:
        rhs = [b.float().requires_grad_(True) for b in bufs]
    (plain(*rhs, *streams, **kw).float() * w).sum().backward()
    for x, y in zip(lhs, rhs):
        assert x.grad.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(x.grad, y.grad, **PT_TOL[dtype])
        else:
            assert _rounding_ratio(x.grad, y.grad) <= 1.0, name


@pytest.mark.gpu
def test_gpu_tt_lookup_gradients_reach_the_cores(cuda):
    """tt_embedding.lookup with tt_exec="pallas" runs K5 on the card; with
    cores that require grad its gradients equal the plain contraction's
    (before the autograd backward, the kernel's output had no path back to
    the cores and the gradients were silently missing)."""
    emb = dataclasses.replace(dlrm.make_bags(registry.get_dlrm("dlrm-tt-smoke"))[0].emb,
                              tt_exec="pallas")
    params = tt_embedding.init(emb, generator=torch.Generator(cuda).manual_seed(0),
                               device=cuda)
    idx = torch.randint(0, emb.vocab, (16, 8), device=cuda, dtype=torch.int32)
    got = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    tg.reset_launches()
    out = tt_embedding.lookup(got, idx, emb)
    assert tg.LAUNCHES["tt_bag"] == 1 and out.requires_grad
    w = _bf16_exact(torch.randn(out.shape, device=cuda))
    (out.float() * w).sum().backward()
    plain = tt_embedding.lookup(want, idx, dataclasses.replace(
        emb, compute_dtype=torch.float32, tt_exec="jnp"))
    (plain * w).sum().backward()
    for k in params:
        assert got[k].grad is not None and float(got[k].grad.abs().max()) > 0
        torch.testing.assert_close(got[k].grad, want[k].grad, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_training_entries_grads_match_the_cpu(cuda, arch, dtype):
    """engine.lookup (packed_multi_bag_lookup: one launch of K1/K3/K2) and
    multi_bag_lookup (bag_lookup per table; K5 for TT) on the card, in the
    compute dtype ``dtype``, against the same calls on the CPU in fp32,
    where every kernel is its plain version: equal outputs and table
    gradients.  The reference is fp32: the CPU's bf16 scatter-add rounds at
    every add.  Tolerance: fp32 1e-4; bf16 outputs 2e-2 (rounded to bf16
    once), bf16 gradients 2e-2 of each leaf's largest entry (each
    contribution is rounded to bf16 before the sum, and a TT core's
    gradient, bilinear in the other cores, sums terms of both signs)."""
    cfg = registry.get_dlrm(arch)

    def bags_in(dt):
        return [dataclasses.replace(b, emb=dataclasses.replace(b.emb, compute_dtype=dt,
                                                               tt_exec="pallas"))
                for b in dlrm.make_bags(cfg)]

    tables = embedding_bag.init_tables(bags_in(dtype), generator=torch.Generator().manual_seed(0),
                                       device="cpu")
    idx = torch.randint(0, cfg.vocab_per_table, (16, cfg.num_tables, cfg.pooling),
                        generator=torch.Generator().manual_seed(1), dtype=torch.int32)
    w = _bf16_exact(torch.randn((16, cfg.num_tables, cfg.dim),
                                generator=torch.Generator().manual_seed(2)))
    tol = PT_TOL[torch.float32] if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    expect_launches = {"lookup": 1,
                       "multi_bag_lookup": cfg.num_tables if cfg.embedding_kind == "tt" else 0}
    for name, kernel_launches in expect_launches.items():
        res = {}
        for where, dt in (("cpu", torch.float32), (cuda, dtype)):
            bags = bags_in(dt)
            run = (engine_for(EngineSpec.from_bags(bags)).lookup if name == "lookup" else
                   lambda t, i, b=bags: embedding_bag.multi_bag_lookup(t, i, b))
            tabs = [{k: v.detach().to(where).requires_grad_(True) for k, v in t.items()}
                    for t in tables]
            pg.reset_launches()
            tg.reset_launches()
            out = run(tabs, idx.to(where))
            (out.float() * w.to(where)).sum().backward()
            launches = sum(pg.LAUNCHES.values()) + sum(tg.LAUNCHES.values())
            res[str(where)] = (out.float().cpu(), [v.grad.cpu() for t in tabs
                                                   for _k, v in sorted(t.items())], launches)
        (o_cpu, g_cpu, n_cpu), (o_gpu, g_gpu, n_gpu) = res["cpu"], res[str(cuda)]
        assert n_cpu == 0 and n_gpu == kernel_launches, name
        torch.testing.assert_close(o_gpu, o_cpu, **tol, msg=lambda m: f"{name}: {m}")
        for a, b in zip(g_gpu, g_cpu):
            if dtype == torch.float32:
                torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{name} grad: {m}")
            else:
                err, scale = float((a - b).abs().max()), float(b.abs().max())
                assert err <= 2e-2 * scale, f"{name} grad: {err} of {scale}"


# ---------------------------------------------------------------------------
# the bag body's contract, and the TT kernels at rank 64
# ---------------------------------------------------------------------------

def _in_order(rows, k: int, dtype) -> torch.Tensor:
    """The bag body's contract as a plain loop on the card: acc = 0, then for
    k = 0..K-1 in order acc = acc + rows(k) in fp32 (``rows`` widens each
    row exactly and adds the R row to the table row first), rounded once."""
    acc = torch.zeros_like(rows(0))
    for j in range(k):
        acc = acc + rows(j)
    return acc.to(dtype)


def _many_table_inputs(tables=26, per_table=64, k=32, q_rows=500, r_rows=64, slots=256,
                       dim=128, seed=7):
    """Packed streams of ``tables`` tables (bag g of table g % tables, as
    ``pack_indices`` makes them): table t's Q rows at t*q_rows, its R rows
    at t*r_rows, a zero row after each, hits and misses, and ragged tails
    routed to the zero rows."""
    rng = np.random.default_rng(seed)
    g = tables * per_table
    t = (np.arange(g) % tables)[:, None]
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    q = f32(tables * q_rows + 1, dim)
    r = f32(tables * r_rows + 1, dim)
    q[-1] = r[-1] = 0.0
    idx = rng.integers(0, q_rows, (g, k)) + t * q_rows
    r_idx = rng.integers(0, r_rows, (g, k)) + t * r_rows
    slot = rng.integers(-slots, slots, (g, k))
    tail = np.arange(k)[None, :] >= rng.integers(0, k + 1, (g, 1))
    idx = np.where(tail, tables * q_rows, idx)
    r_idx = np.where(tail, tables * r_rows, r_idx)
    slot = np.where(tail, -1, slot)
    return {"table": q, "cache": q[rng.integers(0, tables * q_rows, slots)], "r_lut": r,
            "idx": idx.astype(np.int32), "slot": slot.astype(np.int32),
            "r_idx": r_idx.astype(np.int32)}, tables


# (inputs, table count): the cached full-width shape, K > 32 with dim 160,
# dim 12, a dim that is not a multiple of 4 (one value a lane), and 26
# packed tables with ragged tails
IN_ORDER_CASES = {
    "cached": lambda: (bag_inputs("mixed", seed=0, **GPU_SHAPES[0]), 1),
    "k40_dim160": lambda: (bag_inputs("mixed", seed=1, **GPU_SHAPES[1]), 1),
    "dim12": lambda: (bag_inputs("mixed", seed=2, **GPU_SHAPES[2]), 1),
    "dim10": lambda: (bag_inputs("mixed", seed=3, rows=1_000, r_rows=17, slots=50, g=37, k=40,
                                 dim=10), 1),
    "26_tables_ragged": _many_table_inputs,
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(IN_ORDER_CASES))
def test_gpu_bag_bodies_are_bitwise_the_in_order_sum(cuda, case, dtype):
    """K1 and K3 (through ``ops.packed_multi_pooled`` on (B, T, K) streams,
    so the table count reaches the grid), K4a, K4b, K6 and K7 on the card
    are bitwise equal to ``_in_order``: an fp32 sum taken element by element
    in k order (table or cache row, plus the R row first), rounded once."""
    a, tables = IN_ORDER_CASES[case]()
    to = lambda x: torch.from_numpy(x).to(cuda)
    q, cache, r = (to(a[n]).to(dtype) for n in ("table", "cache", "r_lut"))
    idx, slot, r_idx = (to(a[n]) for n in ("idx", "slot", "r_idx"))
    g, k = idx.shape
    hit = slot >= 0
    row = lambda j: torch.where(hit[:, j, None], cache[slot[:, j].clamp(min=0).long()].float(),
                                q[idx[:, j].long()].float())
    qr = lambda j: row(j) + r[r_idx[:, j].long()].float()
    plain = lambda j: q[idx[:, j].long()].float()
    plain_qr = lambda j: plain(j) + r[r_idx[:, j].long()].float()
    by = lambda s: s.reshape(g // tables, tables, k)
    got = {
        "K1": ops.packed_multi_pooled({"q": q, "cache": cache, "r": r},
                                      {"q_idx": by(idx), "slot": by(slot), "r_idx": by(r_idx)},
                                      kind="qr").reshape(g, -1),
        "K3": ops.packed_multi_pooled({"table": q, "cache": cache},
                                      {"idx": by(idx), "slot": by(slot)},
                                      kind="dense").reshape(g, -1),
        "K4a": cg.cached_bag(q, cache, idx, slot),
        "K4b": cg.cached_qr_bag(q, cache, r, idx, slot, r_idx),
        "K6": gb.gnr_bag(q, r, idx, r_idx),
        "K7": gb.gnr_bag_dense(q, idx),
    }
    torch.cuda.synchronize()
    expect = {"K1": _in_order(qr, k, dtype), "K3": _in_order(row, k, dtype),
              "K6": _in_order(plain_qr, k, dtype), "K7": _in_order(plain, k, dtype)}
    expect["K4a"], expect["K4b"] = expect["K3"], expect["K1"]
    for name, out in got.items():
        assert out.dtype == dtype and out.shape == expect[name].shape, name
        assert torch.equal(out, expect[name]), (
            f"{name}: max |kernel - in-order sum| "
            f"{float((out.float() - expect[name].float()).abs().max())}")


RANK64_DIMS = [(4, 4, 4, 64), (4, 8, 4, 64)]   # dims 64 (train_dlrm's) and 128 at rank 64


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", RANK64_DIMS)
def test_gpu_tt_rank64_holds_the_plain_version(cuda, dims, dtype):
    """K2 and K5 at rank 64, where a middle-core row does not fit a block
    twice (128 KiB of fp32 at dim 128): the wrappers pick the sliced
    staging path (``stage_width`` < d2).  At dim 128 the outputs are bitwise
    the plain version's, as the one-stage body's are.  At dim 64 the plain
    version's second product, (16 x 64) @ (64 x 4) batched, does not sum
    its depth in order on the card (cuBLAS: 77% of its outputs differ from
    an in-order fmaf chain, ``scripts/torch_tt_matmul_order.py``), so there no in-order body is
    bitwise the plain version; the outputs are held to the contract
    (``_hold``: fp32 1e-4, bf16 one rounding), and the sliced path's own
    order by ``test_gpu_tt_sliced_staging_is_bitwise_the_one_stage_body``.
    dlrm-tt's rank 16 keeps the one-stage layout."""
    to = lambda x: torch.from_numpy(x).to(cuda)
    cast = lambda xs: [x.to(dtype) if x.is_floating_point() else x for x in xs]
    a = cast(packed_tt_args(packed_tt_inputs("ragged", dims=dims, tables=3, v1=5, v2=40, v3=5,
                                             slots=16, g=96, k=32), to))
    one = cast(tt_args(tt_inputs(dims=dims, v1=6, v2=50, v3=6, b=80, k=20), to))
    assert tg.staging(dims, dtype) < dims[1]
    assert tg.staging(DLRM_DIMS, dtype) == DLRM_DIMS[1]
    pg.reset_launches()
    tg.reset_launches()
    got = pg.packed_tt_bag(*a, dims=dims)
    got5 = tg.tt_bag(*one, dims=dims)
    torch.cuda.synchronize()
    assert pg.LAUNCHES["packed_tt_bag"] == 1 and tg.LAUNCHES["tt_bag"] == 1
    if dims[1] == 8:
        assert torch.equal(got, ref.packed_tt_bag_ref(*a, dims=dims))
        assert torch.equal(got5, ref.tt_bag_ref(*one, dims=dims))
    _hold(got, lambda *x: ref.packed_tt_bag_ref(*x, dims=dims), a, f"K2 {dims}")
    _hold(got5, lambda *x: ref.tt_bag_ref(*x, dims=dims), one, f"K5 {dims}")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d2s", [1, 2, 4])
def test_gpu_tt_sliced_staging_is_bitwise_the_one_stage_body(cuda, d2s, dtype):
    """The sliced staging path forced at dlrm-tt's dims (rank 16, where the
    one-stage layout fits): staging d2s of the 8 column groups at a time
    gives bitwise the one-stage output, in K2 and K5: the slices change
    what is staged when, not the order of any sum."""
    to = lambda x: torch.from_numpy(x).to(cuda)
    cast = lambda xs: [x.to(dtype) if x.is_floating_point() else x for x in xs]
    a = cast(packed_tt_args(packed_tt_inputs("ragged", **TT_SHAPES[0]), to))
    one = cast(tt_args(tt_inputs(dims=DLRM_DIMS, v1=38, v2=1408, v3=38, b=512, k=32), to))
    g, k = a[4].shape
    b, k5 = one[3].shape
    outs = {}
    for w in (8, d2s):
        outs[w] = (tg.run("packed_tt_bag", pg.LAUNCHES, a[:3], a[3], a[4:7], a[7], DLRM_DIMS,
                          g, k, dtype, w),
                   tg.run("tt_bag", tg.LAUNCHES, one[:3], None, one[3:], None, DLRM_DIMS,
                          b, k5, dtype, w))
    torch.cuda.synchronize()
    assert torch.equal(outs[8][0], outs[d2s][0]) and torch.equal(outs[8][1], outs[d2s][1])
    assert torch.equal(outs[8][0], ref.packed_tt_bag_ref(*a, dims=DLRM_DIMS))


@pytest.mark.gpu
def test_gpu_tt_wrappers_raise_where_even_one_slice_does_not_fit(cuda):
    """Rank 128 at dim 128: the staged outer cores alone exceed 227 KB, so
    the wrapper raises, naming the limit, and launches nothing."""
    dims = (4, 8, 4, 128)
    to = lambda x: torch.from_numpy(x).to(cuda)
    one = tt_args(tt_inputs(dims=dims, v1=3, v2=4, v3=3, b=2, k=2), to)
    tg.reset_launches()
    with pytest.raises(ValueError, match="232448 B"):
        tg.tt_bag(*one, dims=dims)
    assert tg.LAUNCHES["tt_bag"] == 0


# ---------------------------------------------------------------------------
# the serving control plane on the card: ladder rungs, front end, tuner
# ---------------------------------------------------------------------------

PACKED_KERNEL = {"qr": "packed_qr_bag", "dense": "packed_bag", "tt": "packed_tt_bag"}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"])
def test_gpu_kernel_rungs_are_bitwise_identical(cuda, arch):
    """The degradation ladder's kernel rungs on the card: full (staged
    cache, one launch), nocache (all miss, one launch) and pertable (one
    one-table launch per table) give the same bits; baseline (the semantic
    loop) launches no packed kernel and agrees to bf16 tolerance."""
    from repro_torch import serve
    from repro_torch.data import synthetic
    from repro_torch.serve.degrade import RUNGS

    cfg = registry.get_dlrm(arch)
    kernel = PACKED_KERNEL[cfg.embedding_kind]
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=cuda)
    params = dlrm.init_dlrm(cfg, seed=0, device=cuda)
    ladder = serve.DegradationLadder(state, params)
    fe = serve.Frontend(cfg, serve.FrontendConfig(batch_size=8), state, params)
    idx = synthetic.dlrm_batch(cfg, 8, seed=0, step=1)["idx"].numpy()
    rows = fe._rows_for(idx)
    scheds = state.fresh_schedulers()
    for t in range(cfg.num_tables):
        scheds[t].prefetch(rows[:, t])
    assert any((scheds[t].slots_for(rows[:, t], record=False) >= 0).any()
               for t in range(cfg.num_tables))
    ladder.warm(idx, rows, scheds)
    out, launches = {}, {}
    for rung in RUNGS[:-1]:
        ladder.rung_i = RUNGS.index(rung)
        pg.reset_launches()
        out[rung] = ladder.pooled(idx, rows, scheds).float().cpu()
        torch.cuda.synchronize()
        launches[rung] = pg.LAUNCHES[kernel]
    assert launches == {"full": 1, "nocache": 1, "pertable": cfg.num_tables, "baseline": 0}
    assert torch.equal(out["full"], out["nocache"])
    assert torch.equal(out["full"], out["pertable"])
    torch.testing.assert_close(out["baseline"], out["full"], rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
def test_gpu_launch_error_propagates_out_of_the_front_end(cuda, monkeypatch):
    """An error raised inside ``serve_gather`` on the card is not the
    injector's transient fault: it leaves ``Frontend.run`` unretried, and
    the ladder stays on its rung."""
    from repro_torch import serve

    cfg = registry.get_dlrm("dlrm-qr-smoke")
    state = serve_rec.build_serve_state(cfg, shards=4, alpha=1.05, seed=0, device=cuda)
    params = dlrm.init_dlrm(cfg, seed=0, device=cuda)
    fe = serve.Frontend(cfg, serve.FrontendConfig(batch_size=8, service_mode="fixed"),
                        state, params,
                        faults=serve.FaultInjector(serve.FaultSpec.parse("gather@0.0:1")))
    fe.calibrate()
    real = state.engine.serve_gather
    calls = []

    def failing(*a, **k):
        calls.append(1)
        real(*a, **k)                       # the kernel launches, then the error
        raise RuntimeError("CUDA error: unspecified launch failure")

    monkeypatch.setattr(state.engine, "serve_gather", failing)
    reqs = serve.generate(serve.ArrivalSpec(rate_rps=300, horizon_s=0.3, seed=1), cfg)
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        fe.run(reqs)
    # the one injected transient error was retried once; the launch error was not
    assert fe.stats.retries == 1 and len(calls) == 1
    assert fe.stats.abandoned == 0 and fe.ladder.transitions == []


@pytest.mark.gpu
def test_gpu_fit_auto_measures_on_the_card(cuda):
    from repro_torch import engine as engine_mod
    from repro_torch import tune
    from repro_torch.data.synthetic import zipf_trace

    cfg = registry.get_dlrm("dlrm-qr-smoke")
    spec = EngineSpec.from_dlrm(cfg, serving=True).replace(duplication=False)
    traces = [zipf_trace(b.emb.vocab, 4096, seed=t) for t, b in enumerate(spec.bags)]
    pg.reset_launches()
    tuner = tune.fit(spec, traces, mode="auto", batch=16, max_samples=2, repeats=2)
    assert tuner.source == "measure"
    assert tuner.metadata["device_kind"] == torch.cuda.get_device_name(0)
    assert tuner.metadata["cuda_version"] == torch.version.cuda
    assert all(s.measured_s > 0 for s in tuner.samples)
    assert pg.LAUNCHES["packed_qr_bag"] > 0
    p = engine_mod.plan(spec, traces, tuner=tuner)
    assert p.knobs in tune.knob_space(spec, packable=True)
