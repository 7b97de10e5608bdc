"""LM checkpoints across the packages and the meshes: one that ``repro``
writes after two meshed steps on a (2, 2) host mesh (its launcher's step,
in a child) restores in the port on four gloo ranks as (1, 4), and one the
port writes on (2, 2) restores in ``repro`` on (1, 4); both hold the full
logical arrays (qwen2-1.5b-smoke's padded Q table of 128 rows), and the
next step's loss agrees to rtol 1e-5 (fp32 compute) with the run that did
not stop."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import torch_lm_mesh_ranks as R  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

NAME = "qr-twolevel"


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=240)


def test_lm_checkpoints_cross_packages_and_meshes(mesh_runner, tmp_path):
    # repro writes on (2, 2); the port restores on (1, 4) and takes step 3
    theirs = tmp_path / "repro_ckpt"
    ref, path = R.repro_child(mesh_runner, tmp_path, NAME, "write", (2, 2), theirs)
    res = _spawn(tmp_path, R.restore_and_step, (1, 4), str(theirs), path, NAME, None)
    for r in res:
        assert r["restored_step"] == 2 and r["opt_step"] == 3
        np.testing.assert_allclose(r["next_loss"], float(ref["next_loss"]), rtol=1e-5)
    # the port writes on (2, 2); repro restores on (1, 4) and takes step 3
    ours = tmp_path / "port_ckpt"
    res = _spawn(tmp_path, R.restore_and_step, (2, 2), str(ours), path, NAME, 2)
    mine, _ = R.repro_child(mesh_runner, tmp_path, NAME, "read", (1, 4), ours)
    assert tuple(mine["q_shape"]) == (128, 128)          # the full logical array
    assert int(mine["next_step"]) == 3
    np.testing.assert_allclose(float(mine["next_loss"]), res[0]["next_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(mine["next_loss"]), float(ref["next_loss"]), rtol=1e-5)
