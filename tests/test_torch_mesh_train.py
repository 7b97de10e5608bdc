"""Meshed DLRM training against the single-rank step, no ``repro`` (this
file runs where jax is absent too): one step on four gloo ranks for the
meshes ``repro``'s launcher trains on, fp32 compute, holds every gathered
gradient, the loss, the gradient norm and the new params to 1e-5 of each
leaf's scale (the largest |x| of the single-rank leaf), elementwise.  A
backward that sums the combine's cotangent over the row axis (N times it)
or forgets the psum of the R LUTs' / TT outer cores' gradients reads near
1 there.  ``forward_partial`` under grad refuses hot tiers and comm-free
tables, and the rest of ``repro``'s ``elastic`` module is ported verbatim."""

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import test_torch_mesh_ranks as R
from repro_torch import engine as E
from repro_torch.distributed import elastic
from repro_torch.engine import EngineSpec
from repro_torch.launch import mesh as M
from repro_torch.models import dlrm

SPAWN_S = 240
SCALE_TOL = 1e-5
BATCH = 16
# (mesh shape, axes): repro's launcher names, the meshes of its elastic drill
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "4x1": ((4, 1), ("data", "model")), "4": ((4,), ("data",)),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}


def _spawn(tmp_path, fn, shape, axes, *args):
    return M.spawn(fn, shape, axes=axes, args=args, device="cpu", backend="gloo",
                   init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


def _hold(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max()) / scale
        assert err <= SCALE_TOL, f"{what} leaf {i}: {err} of its scale"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_meshed_step_matches_the_single_rank_step(mesh, tmp_path):
    shape, axes = MESHES[mesh]
    cases = [(arch, "float32", BATCH, 1) for arch in R.ARCHS]
    if mesh == "2x2":
        cases.append(("dlrm-qr-smoke", "float32", BATCH, 2))      # microbatches
    res = _spawn(tmp_path, R.meshed_steps, shape, axes, cases)
    model = dict(zip(axes, shape)).get("model", 1)
    data = dict(zip(axes, shape)).get("data", 1)
    for i, (arch, compute, batch, mb) in enumerate(cases):
        cfg = R.config(arch, compute)
        params = dlrm.init_dlrm(cfg, seed=0, device="cpu")
        want = R.single_step(cfg, params, R.global_batch(cfg, batch, 0), mb)
        for r in res:
            got = r[i]
            _hold(got["grads"], want["grads"], f"{mesh} {arch} gradient")
            _hold(got["params"], want["params"], f"{mesh} {arch} new params")
            _hold([np.float32(got["loss"])], [np.float32(want["loss"])], "loss")
            _hold([np.float32(got["gnorm"])], [np.float32(want["gnorm"])], "gnorm")
            # a step's collectives: one combine a forward (the row axis in the
            # mesh), the entry ops' psum in the backward (QR, TT), the data
            # mean where data splits the batch, the norm where model splits
            # the tables
            sites = got["sites"]
            combines = mb if "model" in axes else 0
            assert sites.get("combine/model", 0) == combines, sites
            entry = combines if cfg.embedding_kind in ("qr", "tt") else 0
            assert sites.get("entry/model", 0) == entry, sites
            assert sites.get("grad_mean/data", 0) == (1 if data > 1 else 0), sites
            assert sites.get("norm/model", 0) == (1 if model > 1 else 0), sites


def test_pertable_and_packed_partials_are_differentiable_alike(tmp_path):
    """``forward_partial`` under grad on the per-table and the packed plan
    (fp32, (2, 2)): the same pooled output and table gradients, which are
    the single card's (``lookup``) averaged over the data blocks."""
    res = _spawn(tmp_path, R.pertable_grads, (2, 2), ("data", "model"), "dlrm-tt-smoke")
    cfg = R.config("dlrm-tt-smoke", "float32")
    params = dlrm.init_dlrm(cfg, seed=0, device="cpu")
    idx = R.global_batch(cfg, BATCH, 0)["idx"]
    ct = torch.randn((BATCH, cfg.num_tables, cfg.dim), generator=torch.Generator().manual_seed(5))
    leaves = [x.requires_grad_(True) for t in params["tables"] for x in
              (t[k] for k in sorted(t))]
    eng = E.engine_for(EngineSpec.from_bags(dlrm.make_bags(cfg)))
    pooled = eng.lookup(params["tables"], idx)
    # each data block's loss is its own half: the mean of the blocks' gradients
    want = [g.numpy() / 2 for g in torch.autograd.grad(pooled, leaves, ct)]
    for r in res:
        for packing in ("auto", "off"):
            _hold(r[packing]["grads"], want, f"{packing} table gradient")
            assert r[packing]["sites"] == {"combine/model": 1, "entry/model": 1,
                                           "grad_mean/data": 1}
    top = np.concatenate([res[0]["auto"]["pooled"], res[2]["auto"]["pooled"]])
    _hold([top], [pooled.detach().numpy()], "pooled")


def _fake_mesh() -> M.Mesh:
    return M.Mesh(shape={"data": 1, "model": 2}, coords={"data": 0, "model": 0},
                  groups={}, device=torch.device("cpu"), backend="gloo")


def test_forward_partial_under_grad_refuses_hot_tiers_and_comm_free_tables():
    cfg = R.config("dlrm-qr-smoke")
    bags = dlrm.make_bags(cfg)
    mesh = _fake_mesh()
    params = dlrm.init_dlrm(cfg, seed=0, device="cpu")
    idx = R.global_batch(cfg, 4, 0)["idx"]
    eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
    local = [{k: v.requires_grad_(True) for k, v in t.items()}
             for t in eng.shard_tables(params["tables"], mesh)]
    tiers = [{"hot_table": torch.zeros((1, cfg.dim)),
              "hot_slot": torch.full((t["q"].shape[0] * 2,), -1, dtype=torch.int32)}
             for t in local]
    with pytest.raises(NotImplementedError, match="outside the graph"):
        eng.forward_partial(local, idx, mesh=mesh, hot_tiers=tiers)
    from repro_torch.cache import duplication
    from repro_torch.core import placement
    from repro_torch.data.synthetic import zipf_trace

    counts = [placement.profile_counts(zipf_trace(cfg.vocab_per_table, 2000, seed=t),
                                       cfg.vocab_per_table) for t in range(cfg.num_tables)]
    dup = duplication.plan_duplication(bags, counts, num_shards=2, budget_bytes=1 << 40)
    engd = E.compile(E.plan(EngineSpec.from_bags(bags, duplication=True), mesh=mesh, dup=dup))
    assert all(engd.plan.comm_free)
    whole = [{k: v.detach().clone().requires_grad_(True) for k, v in t.items()}
             for t in params["tables"]]
    with pytest.raises(NotImplementedError, match="comm-free"):
        engd.forward_partial(whole, idx, mesh=mesh)
    # without grad both serve as before
    with torch.no_grad():
        assert engd.forward_partial(whole, idx, mesh=mesh).shape == (4, cfg.num_tables,
                                                                     cfg.dim)


def test_reshard_tree_round_trips_across_meshes(tmp_path):
    res = _spawn(tmp_path, R.reshard_round_trip, (2, 2), ("data", "model"))
    # PARAM_RULES: ffn -> model, embed -> data (leaves in flatten order: b, w)
    assert res[0]["specs1"] == [("model",), ("model", "data")]
    assert res[0]["blocks1"] == [(4,), (4, 4)]
    assert res[0]["specs2"] == [("model",), ("model", "data")]
    assert res[0]["blocks2"] == [(8,), (8, 2)]
    for r in res:
        for a, f in zip(r["again"], r["full"]):
            np.testing.assert_array_equal(a, f)


def test_pod_async_state_and_degraded_mesh_shapes():
    """``repro``'s ``test_heartbeat_and_async_policy``, the policy half."""
    st = elastic.PodAsyncState(stale_limit=2, last_sync=0)
    assert st.should_sync(0, pod_slow=True) is False
    assert st.should_sync(2, pod_slow=True) is True     # staleness bound hit
    assert st.should_sync(1, pod_slow=False) is True    # fast path: always sync
    st.mark_synced(2)
    assert st.last_sync == 2 and st.should_sync(3, pod_slow=True) is False
    shapes = elastic.degraded_mesh_shapes(256, 16)
    assert (16, 16) in shapes and shapes[-1][0] >= 1
    assert shapes == [(16, 16), (8, 16), (4, 16), (2, 16), (1, 16)]
    assert elastic.degraded_mesh_shapes(6, 4) == [(1, 4)]
