"""Port parity, the sub-quadratic models served and trained on a mesh:
``repro``'s meshed serving as its dry run lowers it (params by
``PARAM_RULES``, the cache by ``cache_axes`` or replicated, prefill and
decode jitted under ``use_rules``) and the step-1 gradients of its jitted
meshed loss run zamba2-7b-smoke (one SSM group, and two), and xlstm-125m-smoke
at d_model 96 (its sLSTM FFN splits) in fp32 compute with a QR vocabulary,
in a child a mesh on a (1, 2), a (1, 4) and a (2, 2) host mesh (on (2, 2)
``repro``'s params sit FSDP over ``data`` and XLA gathers them, and the
port trains FSDP over ``data`` too: each leaf's ``embed`` dim stored split,
gathered at its use, its gradient reduce-scattered); the port runs the
same numpy params and prompts on gloo ranks (``torch_ssm_mesh_ranks``),
each mesh's ranks once for every case.

Held: the prefill's and four decode steps' logits, each rank's block of the
cache or states, and the step-1 loss to rtol 1e-5 / atol 1e-5 (``TOL``: two
frameworks' summation orders, as ``tests/test_torch_lm_mesh_serve.py``),
xlstm's logits and states to the single-card file's 5e-5 (``SERVED_TOL``),
the step-1 gradients (gathered whole) to rtol 2e-4 / atol 1e-5 as
``tests/test_torch_lm_mesh_repro.py`` (``GRAD_TOL``); the greedy tokens
equal; the
params gathered back from the ranks' blocks bitwise the logical ones.
``repro`` splits zamba2's ``in_proj`` in contiguous blocks at rest and
keeps xlstm's states replicated; the port splits the fused tensors by head
(``mamba2.layout``, ``xlstm.block_layout``) and holds the rank's heads'
states, and the values agree all the same.

Also: world 1 is bitwise the single card (serving and gradients), and so
is a (2, 1) mesh serving one sequence, which stays whole on both data
ranks (as ``repro``'s ``resolve_spec`` leaves a dim the axis does not
divide); a rank's
columns of each fused tensor are its pieces in order; the dry run's traces
on ``abstract_mesh((1, 2))`` count the collectives the gloo ranks issue,
the norm statistic's included; the serve CLI on (1, 2) prints the one
card's first sequence in fp32 compute."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import torch_ssm_mesh_ranks as R  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import mamba2 as MB  # noqa: E402
from repro_torch.models import xlstm as XL  # noqa: E402

SHAPES = ((1, 2), (1, 4), (2, 2))
TOL = dict(rtol=1e-5, atol=1e-5)
# xlstm's served values drift from repro's on one card too: the port's
# single card stands up to 2.5e-5 from repro's logits by the fourth decode
# step on the "xlstm" case, and tests/test_torch_xlstm.py holds its
# single-card logits and states to tests/torch_ssm_inputs.py's FP32_TOL,
# 5e-5; the meshed logits and states are held to that bound
SERVED_TOL = {"xlstm": dict(rtol=5e-5, atol=5e-5)}
# the step-1 gradients as tests/test_torch_lm_mesh_repro.py holds the
# transformers' meshed ones (tests/test_perf_variants.py's bounds)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=240)


def _at(shape, coords):
    return M.abstract_mesh(shape, ("data", "model"), coords)


def _rows(a, mesh):
    """The rank's ``data`` block of a whole reference's sequences (dim 0)."""
    return SH.local_shard(torch.from_numpy(np.asarray(a)), mesh, SH.P("data")).numpy()


@pytest.fixture(scope="module")
def meshed(tmp_path_factory):
    """``repro``'s results and the port's ranks on each mesh of ``SHAPES``
    (the (1, 2) ranks with the collectives of ``R.all_sites``), from the
    same params and prompts (``R.write_inputs``): each mesh's ``repro``
    child runs in the background while the port's ranks run."""
    import os
    import subprocess
    import sys

    from conftest import ROOT

    tmp = tmp_path_factory.mktemp("ssm")
    inputs = tmp / "inputs.npz"
    R.write_inputs(str(inputs))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    paths = {shape: tmp / f"repro_{shape[0]}x{shape[1]}.npz" for shape in SHAPES}
    children = {shape: subprocess.Popen(
        [sys.executable, "-c", R.repro_child_code(inputs, paths[shape], shape)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for shape in SHAPES}
    try:
        ranks = {shape: _spawn(tmp_path_factory.mktemp("rdv"), R.repro_cases, shape,
                               str(inputs), shape == (1, 2)) for shape in SHAPES}
        for shape, child in children.items():
            _out, err = child.communicate(timeout=300)
            assert child.returncode == 0, f"repro's child on {shape} failed:\n{err[-4000:]}"
    finally:
        for child in children.values():
            child.kill()
    ref = {}
    for path in paths.values():
        ref.update(np.load(path))
    return ref, ranks


@pytest.mark.parametrize("name", list(R.CASES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_meshed_ssm_serving_and_gradients_match_repro(meshed, shape, name):
    ref, ranks = meshed
    tag = f"{name}/{shape[0]}x{shape[1]}"
    for r in ranks[shape]:
        got, mesh = r[name], _at(shape, tuple(r["coords"].values()))
        for i, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(logits, _rows(ref[f"{tag}/logits{i}"], mesh),
                                       **SERVED_TOL.get(name, TOL),
                                       err_msg=f"{tag} step {i} {r['coords']}")
        np.testing.assert_array_equal(got["tokens"], _rows(ref[f"{tag}/tokens"], mesh))
        np.testing.assert_array_equal(got["generated"], got["tokens"])
        assert len(got["cache"]) == len(got["cache_specs"])
        for i, (block, spec) in enumerate(zip(got["cache"], got["cache_specs"])):
            want = SH.local_shard(torch.from_numpy(ref[f"{tag}/cache/{i}"]), mesh, spec)
            np.testing.assert_allclose(block, want.numpy(), **SERVED_TOL.get(name, TOL),
                                       err_msg=f"{tag} cache leaf {i} {r['coords']}")
        assert got["gathered"], tag
        np.testing.assert_allclose(got["loss"], float(ref[f"{tag}/loss"]), **TOL)
        assert len(got["grads"]) == len([k for k in ref if k.startswith(f"{tag}/grad/")])
        for i, g in enumerate(got["grads"]):
            np.testing.assert_allclose(g, ref[f"{tag}/grad/{i}"], **GRAD_TOL,
                                       err_msg=f"{tag} gradient {i}")


def test_world1_is_bitwise_the_single_card(tmp_path):
    [got] = _spawn(tmp_path, R.world1, (1, 1))
    want = {"logits": True, "cache": True, "tokens": True, "grads": True}
    assert got == {"zamba2-7b": want, "xlstm-125m": want}


def test_a_batch_the_data_ranks_do_not_divide_stays_whole_on_every_rank(tmp_path):
    got = _spawn(tmp_path, R.whole_batch, (2, 1))
    want = {"rows": 1, "logits": True, "cache": True, "tokens": True, "grads": True}
    assert got == [{"zamba2-7b": want, "xlstm-125m": want}] * 2
    pod = _at((16, 16), (7, 3))
    assert SH.batch_split(1, pod) == () and SH.batch_rows(1, pod) == 1
    assert SH.batch_split(32, pod) == ("data",) and SH.batch_rows(32, pod) == 2
    # the dry run traces long_500k's one sequence on a pod1 rank as it runs
    b = registry.get("zamba2-7b")
    rec = dryrun.trace_serve(b, b.smoke, "decode", 1, 64, mesh=pod)
    assert {k: tuple(v.shape)[1] for k, v in
            registry.cache_specs(b, b.smoke, 1, 64, mesh=pod).items()} == dict.fromkeys(
                ("ssm", "conv", "k", "v"), 1)
    assert "combine/model" in rec["sites"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_rank_columns_of_each_fused_tensor_are_its_pieces_in_order(shape):
    m = shape[1]
    z2 = R.config("zamba2-g2")                     # 8 SSM heads of 16, 2 groups of 16
    xl = R.config("xlstm")                         # d 96: mLSTM 4 heads of 48, FFN 128
    di, gn, h = 128, 32, 8
    f, dx = 128, 192
    for s in range(m):
        mesh = _at(shape, (0, s))
        split = MB.ssm_split(z2, mesh)
        assert (split.lo, split.n) == (s * h // m, h // m)
        lay = MB.layout(z2, mesh)
        cols = SH.local_shard(torch.arange(2 * di + 2 * gn + h)[None], mesh, lay["in_proj"])[0]
        zl = torch.arange(s * di // m, (s + 1) * di // m)
        hl = torch.arange(s * h // m, (s + 1) * h // m)
        want = torch.cat([zl, di + zl, 2 * di + torch.arange(2 * gn), 2 * di + 2 * gn + hl])
        assert torch.equal(cols, want)
        conv = SH.local_shard(torch.arange(di + 2 * gn), mesh, lay["conv_b"])
        assert torch.equal(conv, torch.cat([zl, di + torch.arange(2 * gn)]))
        assert torch.equal(SH.local_shard(torch.arange(h), mesh, lay["A_log"]), hl)
        xlay = XL.block_layout(xl, mesh, slstm=False)
        up = SH.local_shard(torch.arange(2 * dx)[None], mesh, xlay["up"])[0]
        assert torch.equal(up, torch.cat([torch.arange(dx),
                                          dx + torch.arange(s * dx // m, (s + 1) * dx // m)]))
        slay = XL.block_layout(xl, mesh, slstm=True)
        ffn = SH.local_shard(torch.arange(2 * f)[None], mesh, slay["ffn_up"])[0]
        fl = torch.arange(s * f // m, (s + 1) * f // m)
        assert torch.equal(ffn, torch.cat([fl, f + fl]))
        assert SH.full_shape(ffn[None], slay["ffn_up"], mesh) == (1, 2 * f)
    # a mesh that does not split the heads leaves the block whole
    pod = _at((16, 16), (0, 3))
    assert XL.mlstm_split(registry.get("xlstm-125m").config, pod) is None
    assert XL.block_layout(registry.get("xlstm-125m").config, pod, slstm=False)["up"] == SH.P()
    assert MB.ssm_split(registry.get("zamba2-7b").config, pod).n == 7


def test_cache_and_state_blocks_are_the_rank_share():
    z = registry.get("zamba2-7b").config             # 112 SSM heads of 64, 2 groups of 64
    cache = registry.cache_specs(registry.get("zamba2-7b"), z, 32, 64, mesh=_at((16, 16), (0, 5)))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        "ssm": (81, 2, 7, 64, 64), "conv": (81, 2, 3, 7 * 64 + 256),
        "k": (13, 2, 64, 2, 112), "v": (13, 2, 64, 2, 112)}
    x = registry.get("xlstm-125m").config
    states = registry.cache_specs(registry.get("xlstm-125m"), x, 8, 64, mesh=_at((1, 2), (0, 1)))
    assert [tuple(t.shape) for t in states[0]] == [(8, 2, 384, 384), (8, 2, 384), (8, 2)]
    assert [tuple(t.shape) for t in states[3]] == [(8, 4, 192)] * 4


def test_dry_run_counts_the_collectives_the_ranks_issue(meshed):
    _, ranks = meshed
    for r in ranks[(1, 2)]:
        mesh = _at((1, 2), (0, r["coords"]["model"]))
        for arch, want in r["sites"].items():
            b, cfg = registry.get(arch), R.sites_config(arch)
            for kind in ("prefill", "decode"):
                got = dryrun.trace_serve(b, cfg, kind, R.BATCH, R.SEQ, mesh=mesh)["sites"]
                assert got == dict(sorted(want[kind].items(), key=str)), (arch, kind)
                assert {"combine/model", "logits/model", "norm_stat/model"} <= set(got)
            got = dryrun.trace_train(b, cfg, R.BATCH, R.SEQ, mesh=mesh)["sites"]
            assert got == dict(sorted(want["train"].items(), key=str)), (arch, "train")
            assert {"entry/model", "norm_stat/model", "loss/model", "norm/model"} <= set(got)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
def test_serve_cli_on_a_mesh_prints_the_one_card_tokens(arch, capfd):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "32", "--max-new", "8", "--compute-dtype", "float32"]
    firsts = []
    for extra in ([], ["--mesh-shape", "1,2"]):
        assert serve.main(argv + extra) == 0
        out = capfd.readouterr().out
        firsts.append([x for x in out.splitlines() if x.startswith("first sequence:")])
    assert len(firsts[0]) == 1 and firsts[0] == firsts[1]
    assert "2 cpu ranks, mesh (1, 2)" in out
