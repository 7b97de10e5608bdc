"""Port parity, meshed DLRM training: ``repro``'s launcher path with a mesh
(``repro/launch/train.py::build``: params placed by ``PARAM_RULES``, the
loss under ``use_rules``, ``jax.grad``, AdamW on the sharded state) runs in
a child on a (2, 2) host mesh; the port runs on four gloo ranks from the
same params and batches (numpy).  Three steps' losses and gradient norms
agree to 2e-2 (``test_train_steps_match_repro``'s bound, bf16 compute), the
step-1 gradients in fp32 compute to 2e-3 of each leaf's scale (``repro``'s
sharded-forward bound)."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import test_torch_mesh_ranks as R  # noqa: E402

STEPS = R.REPRO_STEPS
LOSS_TOL = 2e-2
GRAD_TOL = 2e-3


@pytest.mark.parametrize("arch", R.ARCHS)
def test_meshed_steps_match_repro(arch, mesh_runner, tmp_path):
    ref = R.repro_child(mesh_runner, tmp_path, arch, "steps")
    res = R.spawn_cpu(tmp_path, R.repro_steps, (2, 2), str(tmp_path / "steps.npz"), arch, STEPS)
    for r in res:
        np.testing.assert_allclose(r["losses"], [float(ref[f"loss{s}"]) for s in range(STEPS)],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(r["norms"], [float(ref[f"gnorm{s}"]) for s in range(STEPS)],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert len(r["grads32"]) == len([k for k in ref.files if k.startswith("grad32/")])
        for i, got in enumerate(r["grads32"]):
            want = ref[f"grad32/{i}"]
            assert got.shape == want.shape
            scale = max(float(np.abs(want).max()), 1e-12)
            assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, (arch, i)
