"""The sharded two-level GnR against itself, no ``repro`` (this file runs
where jax is absent too): shard counts N = 1, 2, 4 give the single-device
result within the rounding rule (``test_torch_sharded_ranks.rounding_tol``,
fp32 and bf16 compute), an all-comm-free plan calls no collective, the padded
big-subtable rows split over every power-of-two shard count, the rank's
local partials sum to the single-card lookup, and the logical-axis rules
resolve as ``repro``'s do (``tests/test_distributed.py``)."""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import test_torch_sharded_ranks as R
from repro_torch import engine as E
from repro_torch.configs import registry
from repro_torch.core import overlap as OV
from repro_torch.core import sharded_embedding as SE
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import P
from repro_torch.engine import EngineSpec
from repro_torch.launch import mesh as M
from repro_torch.models import dlrm

SPAWN_S = 240


def _spawn(tmp_path, fn, shape, *args, axes=("data", "model")):
    return M.spawn(fn, shape, axes=axes, args=args, device="cpu", backend="gloo",
                   init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


def _fake_mesh(shards: int, shard: int) -> M.Mesh:
    """A rank's mesh without process groups: enough for code that calls no
    collective (routing, local partials, shape checks)."""
    return M.Mesh(shape={"data": 1, "model": shards}, coords={"data": 0, "model": shard},
                  groups={}, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_shard_counts_give_the_single_device_result_within_the_rounding_rule(
        shards, tmp_path):
    for dtype in (torch.float32, torch.bfloat16):
        res = _spawn(tmp_path, R.invariants, (1, shards), dtype)
        for kind, kw in R.INVARIANT_KINDS:
            _bags, tables, idx, _tr = R.invariant_case(kind, kw, dtype)
            s, a = R.reference(kind, kw, dtype, tables, idx)
            terms = R.terms_of(kind, kw)
            cases = {  # path -> (roundings in a partial, additions of the combine)
                "packed": (R.PARTIAL_ROUNDINGS["packed"][kind], shards - 1),
                "pertable": (R.PARTIAL_ROUNDINGS["pertable"][kind], shards - 1),
                # one rank's rows arrive summed with zeros: the combine is exact
                "baseline": (R.PARTIAL_ROUNDINGS["pertable"][kind], 0),
                "dup_auto": (R.PARTIAL_ROUNDINGS["packed"][kind], 0),
                "dup_off": (R.PARTIAL_ROUNDINGS["pertable"][kind], 0),
            }
            for name, (partial, adds) in cases.items():
                tol = R.rounding_tol(a, dtype, combine_adds=adds, partial=partial,
                                     terms=terms)
                for r in res:
                    err = np.abs(r[kind][name]["out"] - s)
                    assert (err <= tol).all(), (kind, str(dtype), name, float(
                        (err - tol).max()))
                # every rank holds the same combined output
                assert all(np.array_equal(r[kind][name]["out"], res[0][kind][name]["out"])
                           for r in res)


def test_all_comm_free_plan_calls_no_collective(tmp_path):
    res = _spawn(tmp_path, R.invariants, (1, 2), torch.float32)
    for r in res:
        for kind, _kw in R.INVARIANT_KINDS:
            for name in ("dup_auto", "dup_off"):
                got = r[kind][name]
                assert all(got["comm_free"]), (kind, name)
                assert got["calls"] == 0 and got["bytes"] == 0, (kind, name)
            # the plain plans combine once a call, pooled vectors only
            out = r[kind]["packed"]["out"]
            assert r[kind]["packed"]["calls"] == 1
            assert r[kind]["packed"]["bytes"] == out.size * 4


def test_padded_q_rows_split_over_every_shard_count():
    cfgs = [registry.get_dlrm(n) for n in registry.DLRM_CONFIGS]
    cfgs += [registry.get_dlrm("dlrm-qr").replace(vocab_per_table=v) for v in (1, 999, 10**6 + 7)]
    for cfg in cfgs:
        for bag in dlrm.make_bags(cfg)[:1]:
            rows = SE.padded_q_rows(bag.emb)
            assert rows % SE.ROW_PAD == 0 and rows >= 1
            for n in (1, 2, 4, 8, 16, 32, 64, 128):
                assert rows % n == 0, (cfg.name, rows, n)
                assert SE.ShardPlan(bag.emb, n).rows_per_shard * n == rows


@pytest.mark.parametrize("kind,kw", R.INVARIANT_KINDS)
def test_local_partials_sum_to_the_single_card_lookup(kind, kw):
    """Every rank's routed packed partial and per-table partial, hot tier
    included, summed over the ranks by hand: each access counted once."""
    from repro_torch.data.synthetic import zipf_trace

    bags, tables, idx, traces = R.invariant_case(kind, kw, torch.float32)
    single = E.compile(E.plan(EngineSpec.from_bags(bags))).lookup(tables, idx)
    spec = EngineSpec.from_bags(bags, duplication=True, dup_budget_bytes=4096)
    trace = [zipf_trace(4096, 5000, seed=t) for t in range(2)]
    shards = 4
    eng = E.compile(E.plan(spec, num_shards=shards, trace=trace))
    assert not any(eng.plan.comm_free) and any(
        t.hot_plan.num_hot for t in eng.plan.dup.tables)
    tiers = eng.hot_tiers(tables)
    plans = [SE.ShardPlan(b.emb, shards) for b in bags]
    packed = pertable = 0
    for shard in range(shards):
        mesh = _fake_mesh(shards, shard)
        local = eng.shard_tables(tables, mesh)
        packed = packed + SE.packed_local_partial(local, idx, bags, plans, mesh=mesh,
                                                  hot_tiers=tiers)
        for t, bag in enumerate(bags):
            p = local[t]
            hot = {"hot_table": tiers[t]["hot_table"], "hot_slot": tiers[t]["hot_slot"]}
            if kind == "qr":
                part = SE.qr_bag_partial(p["q"], p["r"], idx[:, t], plans[t], mesh=mesh, **hot)
            elif kind == "tt":
                part = SE.tt_bag_partial(p["g1"], p["g2"], p["g3"], idx[:, t], plans[t],
                                         mesh=mesh, **hot)
            else:
                part = SE.dense_bag_partial(p["table"], idx[:, t], plans[t], mesh=mesh)
            pertable = pertable + torch.nn.functional.pad(
                part[:, None], (0, 0, t, len(bags) - 1 - t))
    torch.testing.assert_close(packed, single, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pertable, single, rtol=1e-5, atol=1e-5)


def test_gnr_refuses_global_tables():
    bags, tables, idx, _tr = R.invariant_case("qr", {"collision": 8}, torch.float32)
    mesh = _fake_mesh(4, 1)
    eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
    assert eng.plan.num_shards == 4
    with pytest.raises(ValueError, match="shard_tables"):
        eng.gnr(mesh)(tables, idx)
    with pytest.raises(ValueError, match="runs on a mesh rank"):
        eng.forward_partial(eng.shard_tables(tables, mesh), idx)


def test_local_shard_takes_the_rank_block_of_each_axis():
    x = torch.arange(48.0).reshape(8, 6)
    mesh = M.Mesh(shape={"data": 2, "model": 2}, coords={"data": 1, "model": 0},
                  groups={}, device=torch.device("cpu"), backend="gloo")
    assert torch.equal(SH.local_shard(x, mesh, P("data")), x[4:])
    assert torch.equal(SH.local_shard(x, mesh, P(None, "model")), x[:, :3])
    assert torch.equal(SH.local_shard(x, mesh, P(("data", "model"))), x[4:6])
    assert SH.local_shard(x, mesh, P()) is x
    blk = SH.local_shard(x, mesh, P("model"))
    assert torch.equal(blk, x[:4]) and blk.data_ptr() != x.data_ptr()   # its own copy
    with pytest.raises(ValueError, match="does not split"):
        SH.local_shard(torch.zeros(5, 2), mesh, P("model"))


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def test_resolve_spec_as_repro():
    """``tests/test_distributed.py``'s four rule tests, on the port."""
    mesh = _FakeMesh({"data": 4, "model": 8})
    rules = {"rows": ("model",), "cols": ("data",)}
    assert SH.resolve_spec(mesh, (64, 16), ("rows", "cols"), rules) == P("model", "data")
    assert SH.resolve_spec(mesh, (63, 16), ("rows", "cols"), rules) == P(None, "data")
    mesh = _FakeMesh({"data": 4, "model": 16})
    rules = {"experts": ("model",), "ffn": ("model",), "embed": ("data",)}
    assert SH.resolve_spec(mesh, (64, 32, 32), ("experts", "embed", "ffn"),
                           rules) == P("model", "data", None)
    assert SH.resolve_spec(mesh, (40, 32, 32), ("experts", "embed", "ffn"),
                           rules) == P(None, "data", "model")
    mesh = _FakeMesh({"pod": 2, "data": 4, "model": 8})
    assert SH.resolve_spec(mesh, (64,), ("embed",), {"embed": ("pod", "data")}) == P(
        ("pod", "data"))
    assert SH.resolve_spec(mesh, (6,), ("embed",), {"embed": ("pod", "data")}) == P("pod")
    assert SH.multi_pod_rules()["batch"] == ("pod", "data")
    assert SH.multi_pod_param_rules()["embed"] == ("pod", "data")


def test_spec_for_and_constrain_under_rules():
    x = torch.zeros(4, 3)
    assert SH.spec_for(("batch", None)) == P() and SH.constrain(x, "batch") is x
    mesh = _fake_mesh(2, 0)
    with SH.use_rules(mesh, SH.DEFAULT_RULES):
        assert SH.current_mesh() is mesh
        assert SH.spec_for(("batch", None)) == P("data", None)
        assert SH.spec_for(("vocab", "ffn")) == P("model", None)   # model used once
        assert SH.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="axes for rank-2"):
            SH.constrain(x, "batch")
    assert SH.current_mesh() is None and SH.current_rules() is None


def test_local_pack_is_built_once_per_set_of_tables():
    """The rank's packed buffer is reused while the same tensors come back
    unmodified, rebuilt after an in-place update or for other tensors, and
    dropped by the (memoisable) engine once its tensors are freed."""
    bags, tables, _idx, _tr = R.invariant_case("qr", {"collision": 8}, torch.float32)
    mesh = _fake_mesh(2, 0)
    eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
    local = eng.shard_tables(tables, mesh)
    pack = eng.local_pack(local, mesh)
    assert eng.local_pack(local, mesh) is pack
    assert torch.equal(pack.buffers["q"][:local[0]["q"].shape[0]], local[0]["q"])
    local[1]["r"].mul_(2.0)                              # an optimizer-like update
    repacked = eng.local_pack(local, mesh)
    assert repacked is not pack
    r_rows = local[0]["r"].shape[0]
    assert torch.equal(repacked.buffers["r"][r_rows:2 * r_rows], local[1]["r"])
    other = [{k: v.clone() for k, v in t.items()} for t in local]
    held = weakref.ref(eng.local_pack(other, mesh))
    assert held() is not repacked
    del repacked, pack
    del other
    gc.collect()
    assert held() is None and eng._local_pack is None


def test_parallel_branches_and_chunked_psum(tmp_path):
    """``core.overlap``: the two branches' results in order, and a chunked
    psum equal to the plain one on 2 gloo ranks (chunks that do not split
    the last dim refused)."""
    assert OV.parallel_branches(lambda a: a + 1, lambda a, b: a * b, (1,), (2, 3)) == (2, 6)
    res = _spawn(tmp_path, R.overlap_case, (1, 2))
    for r in res:
        np.testing.assert_array_equal(r["chunked"], r["plain"])
        assert r["refused"]
    np.testing.assert_array_equal(res[0]["plain"], res[1]["plain"])
    np.testing.assert_array_equal(res[0]["plain"], sum(r["x"] for r in res))


def test_sharded_gnr_refuses_tables_that_need_gradients():
    """Under grad the sharded GnR trains (``test_torch_mesh_train.py``), but
    not through hot tiers: a hot row is a copy made outside the graph, so a
    backward would silently drop its gradient: it refuses instead."""
    bags, tables, idx, _tr = R.invariant_case("dense", {}, torch.float32)
    mesh = _fake_mesh(2, 0)
    eng = E.compile(E.plan(EngineSpec.from_bags(bags), mesh=mesh))
    local = eng.shard_tables(tables, mesh)
    local[0]["table"].requires_grad_(True)
    tiers = [{"hot_table": torch.zeros((1, t["table"].shape[1])),
              "hot_slot": torch.full((t["table"].shape[0] * 2,), -1, dtype=torch.int32)}
             for t in local]
    with pytest.raises(NotImplementedError, match="outside the graph"):
        eng.gnr(mesh, hot=True)(local, idx, tiers)
