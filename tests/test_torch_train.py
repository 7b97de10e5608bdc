"""Port parity of the training slice: gradients through the training entry
(``EmbeddingEngine.lookup``, the ``ops`` entries' recompute backward), the
AdamW optimizer, the DLRM train step, checkpoints and the training CLI,
against ``repro`` on the CPU.

Inputs are made from a seed with numpy (or by ``repro`` and handed over as
numpy) and given to both packages.  Tolerances:

* embedding gradients, fp32 tables: rtol = atol = 1e-5 (the scatter-adds
  of the two frameworks sum in other orders);
* optimizer: 1e-6 (the same fp32 arithmetic; measured bitwise);
* the DLRM train step: the head runs in bf16, whose products may round one
  bf16 step apart in the two frameworks (2**-8 relative); the losses agree
  to 1e-2 and the step-1 gradients to 2e-2 of each leaf's largest entry;
* checkpoints: bitwise.
"""

import dataclasses
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")  # the machine with the card has no jax
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro import engine as j_engine  # noqa: E402
from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.configs import registry as j_registry  # noqa: E402
from repro.core import embedding_bag as j_eb  # noqa: E402
from repro.core.embedding_bag import BagConfig as JBag  # noqa: E402
from repro.core.qr_embedding import EmbeddingConfig as JEmb  # noqa: E402
from repro.data import synthetic as j_syn  # noqa: E402
from repro.models import dlrm as j_dlrm  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.core.embedding_bag import BagConfig as TBag  # noqa: E402
from repro_torch.core.qr_embedding import EmbeddingConfig as TEmb  # noqa: E402
from repro_torch.data import synthetic as t_syn  # noqa: E402
from repro_torch.kernels import ops as t_ops, ref  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import dlrm as t_dlrm  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
import torch_pertable_inputs as pti  # noqa: E402
from torch_bag_inputs import bag_inputs  # noqa: E402
from torch_tt_inputs import DLRM_DIMS, SMOKE_DIMS, packed_tt_inputs, tt_inputs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = [("dense", {}), ("qr", {"collision": 8}), ("tt", {"tt_rank": 4}),
         ("tt", {"tt_rank": 4, "tt_exec": "pallas"}), ("hashed", {})]


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


# ---------------------------------------------------------------------------
# gradients through the training entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", KINDS)
def test_engine_lookup_grads_match_repro(kind, kw):
    """jax.grad through repro's engine.lookup against torch autograd through
    the port's, for every table leaf (tests/test_engine.py:123-140)."""
    def bags(emb_cls, dt, bag_cls):
        emb = emb_cls(vocab=1024, dim=32, kind=kind, param_dtype=dt, compute_dtype=dt, **kw)
        return [bag_cls(emb=emb, pooling=8) for _ in range(2)]

    jbags = bags(JEmb, jnp.float32, JBag)
    tbags = bags(TEmb, torch.float32, TBag)
    jtables = j_eb.init_tables(jax.random.PRNGKey(4), jbags)
    idx = np.random.default_rng(5).integers(0, 1024, (3, 2, 8)).astype(np.int32)
    jeng = j_engine.compile(j_engine.plan(j_engine.EngineSpec.from_bags(jbags)))
    jg = jax.grad(lambda t: (jeng.lookup(t, idx).astype(jnp.float32) ** 2).sum())(jtables)

    ttables = convert.tables_from_numpy(_np(jtables), "cpu")
    for t in ttables:
        for v in t.values():
            v.requires_grad_(True)
    teng = t_engine.engine_for(t_engine.EngineSpec.from_bags(tbags))
    assert teng.plan.packed == jeng.plan.packed
    (teng.lookup(ttables, torch.from_numpy(idx)).float() ** 2).sum().backward()
    got = [v.grad for t in ttables for _k, v in sorted(t.items())]
    expect = jax.tree.leaves(jg)
    assert len(got) == len(expect) and any(float(np.abs(e).max()) > 0 for e in expect)
    for a, b in zip(got, expect):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _entries():
    """(name, entry, plain, float buffers, streams, kw) for every ops entry
    whose backward recomputes its plain version."""
    a = bag_inputs("mixed", g=20, k=6)
    p = pti.pertable_inputs(lead=(4, 5), k=6)
    t5 = tt_inputs(dims=SMOKE_DIMS, b=20, k=6)
    t2 = packed_tt_inputs("ragged", dims=SMOKE_DIMS, g=20, k=6)
    to = torch.from_numpy
    packed = lambda kind, bufs, streams: (
        lambda *x, **kw: t_ops.packed_multi_pooled(
            dict(zip(bufs, x[:len(bufs)])), dict(zip(streams, x[len(bufs):])), kind=kind,
            **kw))
    return [
        ("packed_qr", packed("qr", ("q", "cache", "r"), ("q_idx", "slot", "r_idx")),
         ref.packed_qr_bag_ref, [to(a[n]) for n in ("table", "cache", "r_lut")],
         [to(a[n]) for n in ("idx", "slot", "r_idx")], {}),
        ("packed_dense", packed("dense", ("table", "cache"), ("idx", "slot")),
         ref.packed_bag_ref, [to(a[n]) for n in ("table", "cache")],
         [to(a[n]) for n in ("idx", "slot")], {}),
        ("packed_tt", packed("tt", ("g1", "g2", "g3", "cache"), ("i1", "i2", "i3", "slot")),
         ref.packed_tt_bag_ref, [to(t2[n]) for n in ("g1", "g2", "g3", "cache")],
         [to(t2[n]) for n in ("i1", "i2", "i3", "slot")], {"dims": SMOKE_DIMS}),
        ("cached_pooled", t_ops.cached_pooled, ref.cached_bag_ref,
         [to(p[n]) for n in ("table", "cache")], [to(p[n]) for n in ("idx", "slot")], {}),
        ("cached_qr_pooled", t_ops.cached_qr_pooled, ref.cached_qr_bag_ref,
         [to(p[n]) for n in ("table", "cache", "r_lut")],
         [to(p[n]) for n in ("idx", "slot", "r_idx")], {}),
        ("gnr_pooled", t_ops.gnr_pooled, ref.gnr_bag_ref,
         [to(p[n]) for n in ("table", "r_lut")], [to(p[n]) for n in ("idx", "r_idx")], {}),
        ("gnr_pooled_dense", t_ops.gnr_pooled_dense, ref.dense_bag_ref,
         [to(p["table"])], [to(p["idx"])], {}),
        ("qr_lookup", t_ops.qr_lookup, ref.qr_lookup_ref,
         [to(p[n]) for n in ("table", "r_lut")], [to(p[n]) for n in ("idx", "r_idx")], {}),
        ("tt_pooled_auto", lambda *x, **kw: t_ops.tt_pooled_auto(*x, exec_mode="pallas", **kw),
         ref.tt_bag_ref, [to(t5[n]) for n in ("g1", "g2", "g3")],
         [to(t5[n]) for n in ("i1", "i2", "i3")], {"dims": SMOKE_DIMS}),
        ("tt_lookup", t_ops.tt_lookup, ref.tt_bag_ref,
         [to(t5[n]) for n in ("g1", "g2", "g3")],
         [to(t5[n]) for n in ("i1", "i2", "i3")], {"dims": SMOKE_DIMS}),
    ]


BUDGETS = [pytest.param(("one chunk", torch.float32), id="one chunk"),
           pytest.param(("many chunks", torch.float32), id="many chunks"),
           pytest.param(("one chunk", torch.bfloat16), id="bf16 one chunk"),
           pytest.param(("many chunks", torch.bfloat16), id="bf16 many chunks")]


def _exact_and_magnitudes(plain, bufs, streams, ct, kw):
    """Plain autograd of ``plain`` on ``bufs`` widened to fp32 with the fp32
    cotangent ``ct``: the exact gradient; and the same on |bufs| and |ct|:
    each element's summed contribution magnitudes (the plain versions are
    multilinear in the buffers)."""
    out = []
    for sign in (lambda x: x, torch.abs):
        wide = [sign(b.float()).requires_grad_(True) for b in bufs]
        res = plain(*wide, *streams, **kw)
        out.append(torch.autograd.grad(res, wide, sign(ct).reshape(res.shape)))
    return out


def _within_one_rounding(got, exact, mags, msg):
    """A bf16 gradient within one bf16 rounding of the exact fp32 gradient:
    |got - exact| <= 2^-8 |exact| + 2^-16 m, where m is the element's summed
    contribution magnitudes (slack for the fp32 sums' order).  Returns the
    worst ratio of |got - exact| to that bound."""
    assert got.dtype == torch.bfloat16, msg
    d = (got.float() - exact).abs()
    ratio = float((d / (2.0 ** -8 * exact.abs() + 2.0 ** -16 * mags + 1e-30)).max())
    assert ratio <= 1.0, f"{msg}: {ratio} of one bf16 rounding of the exact gradient"
    return ratio


@pytest.mark.parametrize("entry", range(10))
@pytest.mark.parametrize("budget", BUDGETS)
def test_ops_entries_recompute_grads_equal_plain_autograd(entry, budget, monkeypatch):
    """Each ops entry's backward (the plain version recomputed over chunks
    of bags on fp32 copies of the buffers, chunk gradients summed in fp32,
    rounded once) equals autograd through the plain version itself in fp32;
    ``many chunks`` shrinks the chunk budget so the recompute runs bag by
    bag.  In bf16 each buffer's gradient lies within one bf16 rounding of
    the exact fp32 gradient (``_within_one_rounding``), for one chunk and
    for many alike."""
    chunks, dtype = budget
    name, fn, plain, bufs, streams, kw = _entries()[entry]
    if chunks == "many chunks":
        monkeypatch.setattr(t_ops, "RECOMPUTE_BYTES", 1)
    bufs = [b.to(dtype) for b in bufs]
    a = [b.clone().requires_grad_(True) for b in bufs]
    b = [x.clone().requires_grad_(True) for x in bufs]
    out = fn(*a, *streams, **kw)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(np.float32))
    (out * w).sum().backward()
    if name == "tt_lookup":
        flat = [s.reshape(-1, 1) for s in streams]
    elif name == "qr_lookup":
        flat = list(streams)
    else:
        flat = [s.reshape(-1, s.shape[-1]) for s in streams]
    expect = plain(*b, *flat, **kw).reshape(out.shape)
    torch.testing.assert_close(out, expect, rtol=0, atol=0)
    if dtype == torch.float32:
        (expect * w).sum().backward()
        for x, y in zip(a, b):
            torch.testing.assert_close(x.grad, y.grad, rtol=1e-6, atol=1e-6, msg=name)
        return
    ct = w.to(dtype).float()                    # the cotangent the bf16 output receives
    exact, mags = _exact_and_magnitudes(plain, bufs, flat, ct, kw)
    for i, (x, e, m) in enumerate(zip(a, exact, mags)):
        _within_one_rounding(x.grad, e, m, f"{name} buffer {i}")


def _zipf_tt(bags, k=32, seed=0):
    """dlrm-tt-like inputs of one table (``ROADMAP.md`` §3.1): dims (4, 8,
    4, 16), vocab factors (38, 1386, 38), bf16 cores at the init scale,
    Zipf(1.05) logical indices over the 2,000,976 rows, a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    dims, (v1, v2, v3) = DLRM_DIMS, (38, 1386, 38)
    d1, d2, d3, rank = dims
    scale = (d1 * d2 * d3 * rank ** 2) ** (-1.0 / 6.0)
    core = lambda *s: torch.from_numpy((rng.standard_normal(s) * scale).astype(
        np.float32)).to(torch.bfloat16)
    cores = [core(v1, d1 * rank), core(v2, rank * d2 * rank), core(v3, rank * d3)]
    p = 1.0 / np.arange(1, v1 * v2 * v3 + 1) ** 1.05
    idx = rng.choice(v1 * v2 * v3, size=(bags, k), p=p / p.sum())
    streams = [torch.from_numpy(x.astype(np.int32))
               for x in (idx // (v2 * v3), idx // v3 % v2, idx % v3)]
    ct = torch.from_numpy(rng.standard_normal((bags, d1 * d2 * d3)).astype(
        np.float32)).to(torch.bfloat16)
    return cores, streams, ct, dims


@pytest.mark.parametrize("chunks", [1, 4])
def test_bf16_tt_grads_do_not_depend_on_the_chunk_count(chunks, monkeypatch):
    """The fault of ``ROADMAP.md`` §3.1 on dlrm-tt-like inputs: 256 bags of
    32 through ``tt_pooled_auto(exec_mode="pallas")`` with the recompute
    budget cut so the backward runs 1 or 4 chunks.  Every core's bf16
    gradient lies within one bf16 rounding of the exact fp32 gradient
    (``_within_one_rounding``).  Before the recompute widened the buffers,
    each chunk's gradient was built in bf16 and this read far above."""
    cores, streams, ct, dims = _zipf_tt(256)
    per_bag = streams[0].shape[1] * cores[1].shape[1] * 4
    monkeypatch.setattr(t_ops, "RECOMPUTE_BYTES", 256 // chunks * per_bag)
    leaves = [c.clone().requires_grad_(True) for c in cores]
    out = t_ops.tt_pooled_auto(*leaves, *streams, dims=dims, exec_mode="pallas")
    got = torch.autograd.grad(out, leaves, ct)
    exact, mags = _exact_and_magnitudes(ref.tt_bag_ref, cores, streams, ct.float(),
                                        {"dims": dims})
    for i, (g, e, m) in enumerate(zip(got, exact, mags)):
        _within_one_rounding(g, e, m, f"core {i + 1}, {chunks} chunks")


# repro's bf16 vjp scatters in bf16: its distance from the exact gradient, as
# a share of each core's largest exact entry, measured 0.13-0.19 on these
# inputs (ROADMAP.md §3.1); held here to 0.25
REPRO_BF16_VJP_TOL = 0.25


def test_bf16_tt_grads_against_repro_vjp_and_exact():
    """Parity with ``repro``'s ``jax.vjp`` of ``ref.tt_bag_ref`` on the same
    bf16 cores, streams and cotangent, both held to the exact fp32
    gradient: the port per element within one bf16 rounding
    (``_within_one_rounding``); ``repro`` within ``REPRO_BF16_VJP_TOL`` of
    each core's largest exact entry (its index scatter accumulates in
    bf16); and per core the port no farther from the exact gradient than
    ``repro``."""
    from repro.kernels import ref as j_ref

    cores, streams, ct, dims = _zipf_tt(256, seed=1)
    leaves = [c.clone().requires_grad_(True) for c in cores]
    out = t_ops.tt_pooled_auto(*leaves, *streams, dims=dims, exec_mode="pallas")
    got = torch.autograd.grad(out, leaves, ct)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    jidx = [jnp.asarray(s.numpy()) for s in streams]
    _o, vjp = jax.vjp(lambda *c: j_ref.tt_bag_ref(*c, *jidx, dims=dims), *map(j, cores))
    jgot = vjp(j(ct))
    exact, mags = _exact_and_magnitudes(ref.tt_bag_ref, cores, streams, ct.float(),
                                        {"dims": dims})
    for i, (g, jg, e, m) in enumerate(zip(got, jgot, exact, mags)):
        _within_one_rounding(g, e, m, f"core {i + 1}")
        scale = float(e.abs().max())
        port = float((g.float() - e).abs().max()) / scale
        theirs = float(np.abs(np.asarray(jg, np.float32) - e.numpy()).max()) / scale
        assert theirs <= REPRO_BF16_VJP_TOL, f"core {i + 1}: repro {theirs} of scale"
        assert port <= theirs, f"core {i + 1}: port {port} vs repro {theirs} of scale"


def test_index_streams_get_no_gradient():
    p = pti.pertable_inputs()
    table = torch.from_numpy(p["table"]).requires_grad_(True)
    out = t_ops.gnr_pooled_dense(table, torch.from_numpy(p["idx"]))
    (grad,) = torch.autograd.grad(out.sum(), [table])
    counts = np.bincount(p["idx"].reshape(-1), minlength=p["table"].shape[0])
    np.testing.assert_array_equal(grad.numpy(), np.repeat(counts[:, None], 32, 1))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _opt_tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {"bottom": [{"w": f(5, 3), "b": f(3)}], "tables": [{"q": f(7, 4), "r": f(2, 4)}]}


@pytest.mark.parametrize("clip", [1.0, 0.0, 100.0])
def test_optimizer_update_matches_repro(clip):
    params, grads = _opt_tree(0), _opt_tree(1, scale=3.0)
    jcfg = j_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip)
    tcfg = t_opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=8, clip_norm=clip)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, js = params, j_opt.init(params)
    tp = tree.tree_map(torch.from_numpy, params)
    tg = tree.tree_map(torch.from_numpy, grads)
    ts = t_opt.init(tp)
    for _ in range(4):
        jp, js, jm = j_opt.update(jp, grads, js, jcfg)
        tp, ts, tm = t_opt.update(tp, tg, ts, tcfg)
    for j, t in zip(jax.tree.leaves((jp, js["mu"], js["nu"])),
                    tree.leaves((tp, ts["mu"], ts["nu"]))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 4 and ts["step"].dtype == torch.int32
    for key in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)


def test_optimizer_bf16_params_round_trip_fp32():
    params = {"w": np.random.default_rng(0).standard_normal((6, 4)).astype(np.float32)}
    grads = {"w": np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)}
    cfg = t_opt.OptConfig(lr=1e-1, warmup_steps=0)
    tp = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16)}
    new, state, _ = t_opt.update(tp, {"w": torch.from_numpy(grads["w"])}, t_opt.init(tp), cfg)
    jnew, jstate, _ = j_opt.update({"w": jnp.asarray(params["w"], jnp.bfloat16)}, grads,
                                   j_opt.init({"w": params["w"]}), j_opt.OptConfig(
                                       lr=1e-1, warmup_steps=0))
    assert new["w"].dtype == torch.bfloat16 and state["mu"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(new["w"].float().numpy(), np.asarray(jnew["w"], np.float32))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_learning_rate_matches_repro(schedule):
    jcfg = j_opt.OptConfig(lr=2e-3, warmup_steps=5, total_steps=40, schedule=schedule)
    tcfg = t_opt.OptConfig(lr=2e-3, warmup_steps=5, total_steps=40, schedule=schedule)
    for s in range(0, 45, 3):
        np.testing.assert_allclose(float(t_opt.learning_rate(tcfg, torch.tensor(s))),
                                   float(j_opt.learning_rate(jcfg, jnp.int32(s))), rtol=1e-6)


def test_clip_by_global_norm_matches_repro():
    grads = _opt_tree(2, scale=10.0)
    jc, jn = j_opt.clip_by_global_norm(grads, 1.0)
    tc, tn = t_opt.clip_by_global_norm(tree.tree_map(torch.from_numpy, grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for j, t in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the DLRM train step
# ---------------------------------------------------------------------------

def _leaf_close(got, expect, rel):
    """Each leaf within ``rel`` of its largest entry (the bf16 head)."""
    for path_leaf, e in zip(tree.leaves_with_paths(got), expect):
        path, g = path_leaf
        e = np.asarray(e, np.float32)
        scale = max(float(np.abs(e).max()), 1e-6)
        err = float(np.abs(g.float().numpy() - e).max())
        assert err <= rel * scale, f"{path}: max abs diff {err} vs scale {scale}"


@pytest.mark.parametrize("arch,microbatches", [
    ("dlrm-qr-smoke", 1), ("dlrm-tt-smoke", 1), ("dlrm-dense-smoke", 1), ("dlrm-qr-smoke", 2),
])
def test_train_steps_match_repro(arch, microbatches):
    """Three steps from the same params and batches: step-1 gradients and
    the three losses."""
    jcfg = j_registry.get_dlrm(arch)
    tcfg = t_registry.get_dlrm(arch)
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(_np(jparams), "cpu")
    truth = j_syn.dlrm_truth(jcfg)
    batches = [_np(j_syn.dlrm_planted_batch(jcfg, truth, 16, seed=0, step=s))
               for s in range(3)]
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=3)

    jloss = j_ts.make_dlrm_loss(jcfg)
    jgrad = jax.grad(lambda p: jloss(p, batches[0])[0])(jparams)
    tb = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
    _loss, _m, tgrad = t_ts.value_and_grad(t_ts.make_dlrm_loss(tcfg), tparams, tb[0])
    _leaf_close(tgrad, jax.tree.leaves(jgrad), 2e-2)

    jstep = jax.jit(j_ts.make_train_step(jloss, j_opt.OptConfig(**kw),
                                         microbatches=microbatches))
    tstep = t_ts.make_train_step(t_ts.make_dlrm_loss(tcfg), t_opt.OptConfig(**kw),
                                 microbatches=microbatches)
    js, ts = j_opt.init(jparams), t_opt.init(tparams)
    for s in range(3):
        jparams, js, jm = jstep(jparams, js, batches[s])
        tparams, ts, tm = tstep(tparams, ts, tb[s])
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-2, atol=1e-2)
        assert np.isfinite(float(tm["grad_norm"]))
    assert int(ts["step"]) == 3


def test_planted_batch_law_and_determinism():
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    truth = t_syn.dlrm_truth(cfg)
    a = t_syn.dlrm_planted_batch(cfg, truth, 64, seed=1, step=2)
    b = t_syn.dlrm_planted_batch(cfg, truth, 64, seed=1, step=2)
    c = t_syn.dlrm_planted_batch(cfg, truth, 64, seed=1, step=3)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["idx"], c["idx"])
    assert truth.shape == (cfg.vocab_per_table, 8)
    assert a["idx"].dtype == torch.int32 and a["idx"].shape == (64, cfg.num_tables, cfg.pooling)
    assert set(a["labels"].unique().tolist()) <= {0.0, 1.0}
    pipe = t_syn.Pipeline(make_batch=lambda seed, step: (seed, step), seed=3)
    assert [next(pipe) for _ in range(2)] == [(3, 0), (3, 1)]
    pipe.seek({"seed": 5, "step": 7})
    assert next(pipe) == (5, 7) and pipe.state() == {"seed": 5, "step": 8}


def test_auc_and_bce_match_repro():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(257).astype(np.float32)
    labels = (rng.random(257) < 0.3).astype(np.float32)
    tl, ty = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(t_dlrm.auc(tl, ty)),
                               float(j_dlrm.auc(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(t_dlrm.bce_loss(tl, ty)),
                               float(j_dlrm.bce_loss(logits, labels)), rtol=1e-6)


def test_forward_dlrm_matches_repro():
    jcfg = j_registry.get_dlrm("dlrm-qr-smoke")
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(1), jcfg)
    batch = jax.tree.map(np.array, j_syn.dlrm_batch(jcfg, 8, seed=2))
    expect = j_dlrm.forward_dlrm(jparams, batch["dense"], batch["idx"], jcfg)
    got = t_dlrm.forward_dlrm(convert.params_from_numpy(_np(jparams), "cpu"),
                              torch.from_numpy(batch["dense"]), torch.from_numpy(batch["idx"]),
                              t_registry.get_dlrm("dlrm-qr-smoke"))
    assert got.dtype == torch.float32 and got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_repro_checkpoint_restores_in_the_port_bitwise(tmp_path):
    jcfg = j_registry.get_dlrm("dlrm-tt-smoke")
    jparams, _ = j_dlrm.init_dlrm(jax.random.PRNGKey(3), jcfg)
    jopt = j_opt.init(jparams)
    jopt = {**jopt, "mu": jax.tree.map(lambda x: x + 0.25, jopt["mu"]),
            "step": jnp.int32(7)}
    j_ckpt.save(str(tmp_path), 7, {"params": jparams, "opt": jopt}, extra={"pipeline": {
        "seed": 1, "step": 7}})
    tparams = t_dlrm.init_dlrm(t_registry.get_dlrm("dlrm-tt-smoke"), seed=9, device="cpu")
    like = {"params": tparams, "opt": t_opt.init(tparams)}
    assert t_ckpt.latest_step(str(tmp_path)) == 7
    state, extra = t_ckpt.restore(str(tmp_path), 7, like)
    assert extra == {"pipeline": {"seed": 1, "step": 7}}
    expect = {"params": convert.params_from_numpy(_np(jparams), "cpu"),
              "opt": convert.opt_state_from_numpy(_np(jopt), "cpu")}
    got_leaves, want_leaves = tree.leaves(state), tree.leaves(expect)
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves({"p": jparams,
                                                                       "o": jopt}))
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_port_checkpoint_round_trips_bitwise_and_restores_in_repro(tmp_path):
    params = t_dlrm.init_dlrm(t_registry.get_dlrm("dlrm-qr-smoke"), seed=4, device="cpu")
    state = {"params": params, "opt": t_opt.init(params), "bf16": [torch.randn(3, 5).to(
        torch.bfloat16)]}
    for s in (1, 2, 3, 4):
        t_ckpt.save(str(tmp_path), s, state, extra={"s": s})
    t_ckpt.prune(str(tmp_path), keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    got, extra = t_ckpt.restore(str(tmp_path), 4, state)
    assert extra == {"s": 4}
    for g, w in zip(tree.leaves(got), tree.leaves(state)):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # repro reads the port's layout (fp32 leaves): same paths, same bits
    sub = {"params": params, "opt": t_opt.init(params)}
    t_ckpt.save(str(tmp_path / "j"), 1, sub)
    jlike = jax.tree.map(lambda t: np.zeros(tuple(t.shape), np.float32),
                         tree.tree_map(lambda t: t, sub))
    jgot, _ = j_ckpt.restore(str(tmp_path / "j"), 1, jlike)
    for j, t in zip(jax.tree.leaves(jgot), tree.leaves(sub)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    with pytest.raises(ValueError, match="leaf"):
        t_ckpt.restore(str(tmp_path), 4, {"params": params, "opt": t_opt.init(params),
                                          "other": [torch.zeros(3, 5)]})


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(tmp, steps, *extra):
    return t_train.main(["--arch", "dlrm-qr", "--smoke", "--device", "cpu", "--steps",
                         str(steps), "--batch", "32", "--lr", "3e-3", "--ckpt-dir", str(tmp),
                         "--log-every", "100", *extra])


def _held_out_loss(params):
    cfg = t_registry.get_dlrm("dlrm-qr-smoke")
    batch = t_syn.dlrm_planted_batch(cfg, t_syn.dlrm_truth(cfg), 2048, seed=123, step=10_000)
    with torch.no_grad():
        return float(t_ts.make_dlrm_loss(cfg)(params, batch)[0])


def _restored(tmp, step):
    p0 = t_dlrm.init_dlrm(t_registry.get_dlrm("dlrm-qr-smoke"), seed=0, device="cpu")
    state, extra = t_ckpt.restore(str(tmp), step, {"params": p0, "opt": t_opt.init(p0)})
    return state, extra, p0


def test_cli_lowers_the_loss_and_resumes_where_it_stopped(tmp_path, capsys):
    """20 steps lower the held-out loss.  A run that lost every checkpoint
    after step 12 (the newest ones deleted, as a crash would) resumes at 12
    and ends on the same params, bit for bit, as the straight run: the
    batches are a function of (seed, step) and the optimizer state is
    restored whole."""
    assert _cli(tmp_path, 20, "--ckpt-every", "6") == 0
    straight, extra, p0 = _restored(tmp_path, 20)
    assert extra["pipeline"] == {"seed": 0, "step": 20}
    assert int(straight["opt"]["step"]) == 20
    assert _held_out_loss(straight["params"]) < _held_out_loss(p0) - 0.01

    assert sorted(os.listdir(tmp_path)) == ["step_00000012", "step_00000018",
                                            "step_00000020"]
    for s in (18, 20):
        shutil.rmtree(tmp_path / f"step_{s:08d}")
    capsys.readouterr()
    assert _cli(tmp_path, 20, "--ckpt-every", "6") == 0
    assert "[resume] step 12" in capsys.readouterr().out
    resumed, _, _ = _restored(tmp_path, 20)
    for a, b in zip(tree.leaves(resumed), tree.leaves(straight)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cli_refuses_lm_archs(capsys):
    """The LM archs once raised here; the CLI now trains them: three steps of
    qwen2-1.5b-smoke, one step line each, finite losses."""
    assert t_train.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "16", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all() and "done" in out


def test_cli_checkpoints_and_exits_on_sigterm(tmp_path):
    # the child on one intra-op thread, as this module runs (torch_one_thread)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "dlrm-qr", "--smoke",
         "--device", "cpu", "--steps", "100000", "--batch", "8", "--log-every", "1",
         "--ckpt-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("step"):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert "[preempt]" in out
    step = t_ckpt.latest_step(str(tmp_path))
    assert step is not None and step < 100000
