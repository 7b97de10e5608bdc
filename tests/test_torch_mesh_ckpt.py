"""Checkpoints across the packages and the meshes: one that ``repro``
writes on a (2, 2) host mesh (its launcher's step, in a child) restores in
the port on four gloo ranks as (4, 1), and one the port writes on (2, 2)
restores in ``repro`` on (4, 1); both hold the full logical arrays, and the
next step's loss agrees to 2e-2 (bf16 compute) with the run that did not
stop."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import test_torch_mesh_ranks as R  # noqa: E402

LOSS_TOL = 2e-2


def test_checkpoints_cross_packages_and_meshes(mesh_runner, tmp_path):
    arch = "dlrm-qr-smoke"
    # repro writes on (2, 2); the port restores on (4, 1) and takes step 3
    theirs = tmp_path / "repro_ckpt"
    ref = R.repro_child(mesh_runner, tmp_path, arch, "write", theirs)
    res = R.spawn_cpu(tmp_path, R.restore_and_step, (4, 1), str(theirs),
                      str(tmp_path / "write.npz"), arch, None)
    for r in res:
        assert r["restored_step"] == 2 and r["opt_step"] == 3
        np.testing.assert_allclose(r["next_loss"], float(ref["next_loss"]),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    # the port writes on (2, 2); repro restores on (4, 1) and takes step 3
    ours = tmp_path / "port_ckpt"
    res = R.spawn_cpu(tmp_path, R.restore_and_step, (2, 2), str(ours),
                      str(tmp_path / "write.npz"), arch, 2)
    mine = R.repro_child(mesh_runner, tmp_path, arch, "read", ours)
    assert tuple(mine["q_shape"]) == (512, 32)          # the full logical array
    assert int(mine["next_step"]) == 3
    np.testing.assert_allclose(float(mine["next_loss"]), res[0]["next_loss"],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(float(mine["next_loss"]), float(ref["next_loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
