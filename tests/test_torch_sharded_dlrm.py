"""Port parity, the sharded DLRM forward: ``repro``'s
``test_dlrm.py::test_sharded_dlrm_matches_single`` and
``test_tt_embedding.py::test_sharded_dlrm_tt_matches_single`` on the same
params and batch.  ``repro`` runs its single-device and its jitted sharded
forward (``use_rules`` on a (2, 2) host mesh) in a child process; the port
runs ``forward_dlrm`` under ``use_rules`` on 4 gloo ranks, each with its
batch shard and its row shards.  Held to ``repro``'s 2e-3 (fp32 compute)."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import test_torch_sharded_ranks as R  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402

_DLRM = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import registry
from repro.data.synthetic import dlrm_batch
from repro.models import dlrm
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh

cfg = dataclasses.replace(registry.get_dlrm(__ARCH__), compute_dtype="float32")
params, _ = dlrm.init_dlrm(jax.random.PRNGKey(0), cfg)
batch = dlrm_batch(cfg, 8, seed=0, step=0)
single = dlrm.forward_dlrm(params, batch["dense"], batch["idx"], cfg)
mesh = make_mesh((2, 2), ("data", "model"))
params_p = dlrm.pad_tables_for_mesh(params, cfg, 2)
with SH.use_rules(mesh, SH.DEFAULT_RULES):
    sharded = jax.jit(lambda p, d, i: dlrm.forward_dlrm(p, d, i, cfg))(
        params_p, batch["dense"], batch["idx"])
out = {"single": np.asarray(single), "sharded": np.asarray(sharded),
       "dense": np.asarray(batch["dense"]), "idx": np.asarray(batch["idx"], np.int32)}
for part in ("bottom", "top", "tables"):
    for i, leaf in enumerate(params[part]):
        for k, v in leaf.items():
            out[f"{part}/{i}/{k}"] = np.asarray(v)
np.savez(__PATH__, **out)
"""


@pytest.mark.parametrize("arch", ["dlrm-qr-smoke", "dlrm-tt-smoke"])
def test_sharded_dlrm_matches_single(arch, mesh_runner, tmp_path):
    path = str(tmp_path / "case.npz")
    mesh_runner(_DLRM.replace("__ARCH__", repr(arch)).replace("__PATH__", repr(path)),
                n_devices=4, timeout=300)
    ref = np.load(path)
    np.testing.assert_allclose(ref["single"], ref["sharded"], rtol=2e-3, atol=2e-3)
    res = M.spawn(R.sharded_dlrm, (2, 2), args=(path, arch), device="cpu", backend="gloo",
                  init_file=tmp_path / "rdv", timeout_s=240)
    logits = np.concatenate([res[0]["out"], res[2]["out"]])
    np.testing.assert_array_equal(res[1]["out"], res[0]["out"])
    np.testing.assert_array_equal(res[3]["out"], res[2]["out"])
    np.testing.assert_allclose(logits, ref["sharded"], rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(logits, ref["single"], rtol=2e-3, atol=2e-3)
    # one psum of pooled vectors per forward: the only model-axis collective
    assert all(r["calls"] == 1 for r in res)
