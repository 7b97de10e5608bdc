"""Port parity of the DLRM head and of the whole serving slice.

The same params (``repro``'s init, carried across with
``convert.params_from_numpy``) and the same batches go through ``repro`` on
the CPU (Pallas kernels in interpret mode, as the serving spec asks) and
through the port on the CPU (the kernels' plain versions).

Tolerances: fp32 head rtol = atol = 1e-5.  For the bf16 head, the logit
difference measured on the CPU (torch 2.13, jax 0.9, both smoke configs,
five parameter seeds of 64 samples, and the whole slice) was exactly 0: both
frameworks round the bf16 products and sums at the same places here.  Other
builds may round one step apart, so the bf16 checks hold rtol = atol = 8e-3,
one bf16 step at 1.0 (2^-7), well inside the 5e-2 ceiling.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.launch import serve_rec as j_serve  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.launch import serve_rec as t_serve  # noqa: E402
from repro_torch.models import dlrm as t_dlrm  # noqa: E402

ARCHS = ["dlrm-qr-smoke", "dlrm-dense-smoke", "dlrm-tt-smoke"]
BF16_TOL = dict(rtol=8e-3, atol=8e-3)


def _params(jc, seed=0):
    params, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(seed), jc)
    return params, convert.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")


def test_interact_pair_order_matches():
    f = 5
    np.testing.assert_array_equal(
        torch.triu_indices(f, f, 1).numpy(), np.stack(jnp.triu_indices(f, k=1)))
    rng = np.random.default_rng(0)
    bottom = rng.standard_normal((3, 8)).astype(np.float32)
    pooled = rng.standard_normal((3, f - 1, 8)).astype(np.float32)
    expect = np.asarray(j_dlrm.interact(jnp.asarray(bottom), jnp.asarray(pooled)))
    got = t_dlrm.interact(torch.from_numpy(bottom), torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_forward_from_pooled_matches(arch, compute):
    jc = dataclasses.replace(j_registry.get_dlrm(arch), compute_dtype=compute)
    tc = t_registry.get_dlrm(arch).replace(compute_dtype=compute)
    jp, tp = _params(jc, seed=1)
    rng = np.random.default_rng(2)
    dense = rng.standard_normal((16, jc.num_dense)).astype(np.float32)
    pooled = rng.standard_normal((16, jc.num_tables, jc.dim)).astype(np.float32)
    expect = np.asarray(j_dlrm.forward_from_pooled(jp, jnp.asarray(dense),
                                                   jnp.asarray(pooled), jc))
    got = t_dlrm.forward_from_pooled(tp, torch.from_numpy(dense),
                                     torch.from_numpy(pooled), tc)
    assert got.dtype == torch.float32 and got.shape == (16,)
    tol = dict(rtol=1e-5, atol=1e-5) if compute == "float32" else BF16_TOL
    np.testing.assert_allclose(got.numpy(), expect, **tol)


@pytest.fixture(scope="module", params=ARCHS)
def slice_runs(request):
    """Both packages' run_pipeline in both modes on one smoke config."""
    arch = request.param
    jc, tc = j_registry.get_dlrm(arch), t_registry.get_dlrm(arch)
    jp, tp = _params(jc)
    data = [j_syn.dlrm_batch(jc, 4, seed=0, step=t) for t in range(4)]
    data = [{"dense": np.asarray(b["dense"]), "idx": np.asarray(b["idx"])} for b in data]
    runs = {}
    for mode in ("sequential", "overlap"):
        runs["repro", mode] = j_serve.run_pipeline(jc, batch=4, batches=4, mode=mode,
                                                   params=jp)
        runs["port", mode] = t_serve.run_pipeline(tc, batch=4, batches=4, mode=mode,
                                                  params=tp, data=data, device="cpu")
    return runs


@pytest.mark.parametrize("mode", ["sequential", "overlap"])
def test_slice_logits_match_repro(slice_runs, mode):
    jr, tr = slice_runs["repro", mode], slice_runs["port", mode]
    assert len(tr["logits"]) == 4
    for a, b in zip(tr["logits"], jr["logits"]):
        assert a.shape == (4,) and np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), **BF16_TOL)
    assert tr["hit_rate"] == jr["hit_rate"]
    assert tr["staged_per_batch"] == jr["staged_per_batch"]
    assert tr["slot_budgets"] == jr["slot_budgets"]
    assert tr["served"] == jr["served"] == 12


def test_slice_overlap_matches_sequential(slice_runs):
    for a, b in zip(slice_runs["port", "sequential"]["logits"],
                    slice_runs["port", "overlap"]["logits"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
