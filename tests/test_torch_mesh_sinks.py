"""The meshed backward leaves the zero rows out of its recompute (no jax).

``packed_local_partial`` routes every access a rank does not own to its
packed buffer's zero row, and the R positions of other ranks to ``r_zero``;
their gradients are discarded.  ``ops.packed_multi_pooled(sinks=)`` hands
those rows to ``_KernelRecompute``, whose backward differentiates only the
kept accesses, in their order, as bags of one.  On every rank of a 2- and a
4-shard mesh, for QR, dense and TT tables in fp32 and bf16 compute:

* the plain version the backward recomputes never sees a sink row in the
  stream its group keys on, and the accesses it differentiates are exactly
  the kept ones;
* every table's gradient equals, bit for bit, the one of the full recompute
  over every access (each kept row sums the same terms in the same order;
  the TT outer cores lose only terms that are exact zeros).
"""

import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import test_torch_sharded_ranks as R
from repro_torch.core import sharded_embedding as SE
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as M

PLAIN = {"qr": "packed_qr_bag_ref", "dense": "packed_bag_ref", "tt": "packed_tt_bag_ref"}
KEYED = {"qr": (0, 2), "dense": (0,), "tt": (1,)}      # the streams a sink keys on


def _mesh(shards: int, shard: int) -> M.Mesh:
    return M.Mesh(shape={"data": 1, "model": shards}, coords={"data": 0, "model": shard},
                  groups={}, device=torch.device("cpu"), backend="gloo")


def _grads(bags, tables, idx, plans, mesh, ct):
    local = [{k: v.clone().requires_grad_(True) for k, v in t.items()} for t in tables]
    out = SE.packed_local_partial(local, idx, bags, plans, mesh=mesh)
    out.backward(ct)
    return [{k: v.grad for k, v in t.items()} for t in local]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("kind,kw", R.INVARIANT_KINDS)
def test_recompute_skips_the_sink_rows_and_keeps_every_other_gradient(kind, kw, shards, dtype,
                                                                       monkeypatch):
    bags, tables, idx, _ = R.invariant_case(kind, kw, dtype)
    idx = torch.cat([idx, idx.flip(0)])             # repeated rows: runs of kept accesses
    plans = [SE.ShardPlan(b.emb, shards) for b in bags]
    ct = torch.randn((idx.shape[0], idx.shape[1], bags[0].emb.dim),
                     generator=torch.Generator().manual_seed(7)).to(dtype)
    plain = getattr(ref, PLAIN[kind])
    sunk = 0
    for shard in range(shards):
        mesh = _mesh(shards, shard)
        local = [SE.shard_qr_params(t, b.emb, mesh) for t, b in zip(tables, bags)]
        pack = SE.pack_local(local, bags, plans)
        sinks = {0: pack.zero_row, 1: pack.zero_row, 2: pack.r_zero}
        seen = []

        def spy(*args, **kw):
            n_buf = len(ops.PACKED_BUFFERS[kind])
            seen.append([a.detach().clone() for a in args[n_buf:]])
            return plain(*args, **kw)

        monkeypatch.setattr(ref, PLAIN[kind], spy)
        got = _grads(bags, local, idx, plans, mesh, ct)
        # the forward ran the kernel's plain version directly, not the spy:
        # every call seen is the backward's, one stream of bags of one each
        assert all(s[0].shape[1] == 1 for s in seen)
        monkeypatch.setattr(ref, PLAIN[kind], plain)
        # what the full recompute gathers, read from the same routing
        routed = []
        monkeypatch.setattr(ops, "_diff", _capture(ops._diff, routed))
        want = _grads(bags, local, idx, plans, mesh, ct)
        monkeypatch.undo()
        streams = routed[0]
        for j in KEYED[kind]:
            kept = int((streams[j] != sinks[j]).sum())
            sunk += int((streams[j] == sinks[j]).sum())
            # the calls of this stream's group: none sees its sink row
            visits = [s[j] for s in seen if not (s[j] == sinks[j]).any()]
            assert sum(int(v.numel()) for v in visits) == kept
        for t in range(len(bags)):
            for key in got[t]:
                assert torch.equal(got[t][key], want[t][key]), (shard, t, key)
    assert sunk > 0                                 # the case routes accesses to sinks


def _capture(diff, routed):
    """``ops._diff`` without the sinks (the full recompute), recording the
    routed streams it was given."""
    def run(kernel, plain, buffers, streams, row_width, *, sinks=(), **kw):
        routed.append(streams)
        return diff(kernel, plain, buffers, streams, row_width, **kw)
    return run


def test_one_shard_passes_no_sinks(monkeypatch):
    """At one shard nothing routes to the zero rows, and the backward is the
    full recompute it always was (world 1 stays bitwise the single card)."""
    bags, tables, idx, _ = R.invariant_case("qr", {"collision": 8}, torch.float32)
    calls = []
    run = ops.packed_multi_pooled
    monkeypatch.setattr(ops, "packed_multi_pooled",
                        lambda *a, **kw: calls.append(kw.get("sinks")) or run(*a, **kw))
    mesh = _mesh(1, 0)
    local = [SE.shard_qr_params(t, b.emb, mesh) for t, b in zip(tables, bags)]
    SE.packed_local_partial(local, idx, bags, [SE.ShardPlan(b.emb, 1) for b in bags], mesh=mesh)
    assert calls == [None]
