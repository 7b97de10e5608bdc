"""Port parity, the LM trained on a mesh: ``repro``'s launcher path with a
mesh (``repro/launch/train.py::build``: params placed by ``PARAM_RULES``,
the loss under ``use_rules``, ``jax.grad``, AdamW on the sharded state) runs
qwen2-1.5b-smoke (vocabulary 498, fp32 compute) in a child on a (2, 2) and a
(1, 4) host mesh; the port runs on four gloo ranks from the same params and
tokens (numpy).  Three steps' losses agree to rtol 1e-5, the step-1
gradients to rtol 2e-4 / atol 1e-5 (``tests/test_perf_variants.py``'s
bounds).  On (1, 4) ``repro`` cuts each of the 2 kv heads in half at rest
(FSDP and first-fit), the port keeps the kv projections whole: the values
agree all the same.  The port's own ``twolevel`` and ``gspmd`` give the
same loss and gradients on a mesh (``repro``'s
``test_twolevel_embedding_matches_gspmd``)."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import torch_lm_mesh_ranks as R  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=240)


@pytest.mark.parametrize("shape,name", [((2, 2), "qr-twolevel"), ((1, 4), "dense")])
def test_meshed_lm_steps_match_repro(shape, name, mesh_runner, tmp_path):
    ref, path = R.repro_child(mesh_runner, tmp_path, name, "steps", shape)
    res = _spawn(tmp_path, R.repro_steps, shape, path, name)
    steps = range(R.REPRO_STEPS)
    for r in res:
        np.testing.assert_allclose(r["losses"], [float(ref[f"loss{s}"]) for s in steps],
                                   rtol=1e-5)
        np.testing.assert_allclose(r["norms"], [float(ref[f"gnorm{s}"]) for s in steps],
                                   rtol=1e-4)
        assert len(r["grads"]) == len([k for k in ref.files if k.startswith("grad/")])
        for i, got in enumerate(r["grads"]):
            np.testing.assert_allclose(got, ref[f"grad/{i}"], rtol=2e-4, atol=1e-5,
                                       err_msg=f"{name} {shape} gradient {i}")


def test_port_twolevel_matches_gspmd_on_a_mesh(tmp_path):
    for r in _spawn(tmp_path, R.twolevel_vs_gspmd, (2, 2)):
        a, b = r["twolevel"], r["gspmd"]
        assert a["loss"] == b["loss"]
        for x, y in zip(a["grads"], b["grads"]):
            np.testing.assert_array_equal(x, y)
