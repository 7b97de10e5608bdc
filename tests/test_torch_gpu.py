"""The port's CUDA kernels on the card, and the CPU-side pieces of their build.

Tests marked ``gpu`` hold K1 ``packed_qr_bag`` and K3 ``packed_bag`` against
their plain PyTorch versions on the card and serve the smoke configs there;
each decides inside the ``cuda`` fixture whether a card exists, and skips
without one.  Run them on the card with
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports no jax:
the machine with the card has none.

Tolerance on the card: rtol = atol = 1e-4 (K fp32 adds of unit-scale rows
in two different orders; the dlrm-width error measured by chip_smoke.py is
about 1e-5).
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import packed_gather as pg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import serve_rec  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from torch_bag_inputs import CASES, bag_inputs, dense_args, qr_args  # noqa: E402


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
    assert pg.LAUNCHES == {"packed_qr_bag": 1, "packed_bag": 1}
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


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-dense-smoke"])
def test_gpu_serving_overlap_matches_sequential(cuda, arch):
    cfg = registry.get_dlrm(arch)
    name = "packed_qr_bag" if cfg.embedding_kind == "qr" else "packed_bag"
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
