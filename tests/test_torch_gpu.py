"""The port's CUDA kernels on the card, and the CPU-side pieces of their build.

Tests marked ``gpu`` hold K1 ``packed_qr_bag``, K3 ``packed_bag``, K2
``packed_tt_bag``, K5 ``tt_bag`` and the per-table kernels K4a
``cached_bag``, K4b ``cached_qr_bag``, K6 ``gnr_bag``, K7 ``gnr_bag_dense``
and K8 ``qr_gather`` against their plain PyTorch versions on the card,
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

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import tt_embedding  # noqa: E402
from repro_torch.core import embedding_bag  # noqa: E402
from repro_torch.engine import EngineSpec, engine_for  # noqa: E402
from repro_torch.examples import cache_plan, quickstart  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
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
        (1, args[1].to(torch.bfloat16), "float32"),
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
    for i, val, match in [(0, one[0].to(torch.bfloat16), "float32"),
                          (3, one[3].to(torch.int64), "int32"),
                          (2, one[2][:, :4].contiguous(), "width")]:
        call = list(one)
        call[i] = val
        with pytest.raises(ValueError, match=match):
            tg.tt_bag(*call, dims=SMOKE_DIMS)
    assert pg.LAUNCHES["packed_tt_bag"] == 0 and tg.LAUNCHES["tt_bag"] == 0


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


# ---------------------------------------------------------------------------
# the per-table kernels K4a, K4b, K6, K7, K8
# ---------------------------------------------------------------------------

PT_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
          torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
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
def test_gpu_lookup_raises_when_tables_require_grad(cuda):
    bags = dlrm.make_bags(registry.get_dlrm("dlrm-qr-smoke"))
    gen = torch.Generator(cuda).manual_seed(0)
    tables = embedding_bag.init_tables(bags, generator=gen, device=cuda)
    idx = torch.randint(0, bags[0].emb.vocab, (4, len(bags), bags[0].pooling),
                        device=cuda, dtype=torch.int32)
    eng = engine_for(EngineSpec.from_bags(bags))
    eng.lookup(tables, idx)                            # no grad: the kernel runs
    tables[1]["q"].requires_grad_(True)
    pg.reset_launches()
    with pytest.raises(NotImplementedError, match="training"):
        eng.lookup(tables, idx)
    assert pg.LAUNCHES["packed_qr_bag"] == 0


@pytest.mark.gpu
def test_gpu_examples_launch_their_kernels(cuda):
    pg.reset_launches()
    _reset_pertable()
    quickstart.main(["--device", "cuda"])
    assert gb.LAUNCHES["gnr_bag"] == 1 and pg.LAUNCHES["packed_qr_bag"] == 1
    _reset_pertable()
    res = cache_plan.main(["--device", "cuda"])
    assert cg.LAUNCHES["cached_qr_bag"] == res["batches"] == 4
