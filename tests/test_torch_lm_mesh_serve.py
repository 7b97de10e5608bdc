"""Port parity, the dense and MoE transformers served on a mesh: ``repro``'s
meshed serving as its dry run lowers it (params by ``PARAM_RULES``, the
cache by ``cache_axes``, prefill and decode jitted under ``use_rules``, the
logits replicated) runs qwen2-1.5b-smoke (dense, and QR ``twolevel``) and
granite-moe-3b-a800m-smoke (QR) in fp32 compute in one child on a (2, 2)
and a (1, 4) host mesh; the port serves the same params and prompts on
gloo ranks (``torch_lm_mesh_serve_ranks``).  The prefill's and four
decode steps' logits and each rank's block of the cache agree to rtol
1e-5 / atol 1e-5 (``TOL``), the greedy tokens are equal.  On (1, 4)
``repro`` splits each of the 2 kv heads in half at rest and its cache's
positions over ``model``; the port keeps whole kv heads and whole
positions (``sharding.cache_block``) and the values agree all the same.

Also: world 1 is bitwise the single card; the dry run's trace on
``abstract_mesh((1, 2))`` counts the collectives the gloo ranks issue; the
CLI on (1, 2) prints the one card's first sequence in fp32 compute, and on
(2, 1) data ranks serves the prefix models (each rank its sequence and its
frames or patches) with the one card's first sequence."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401
jax = pytest.importorskip("jax")  # the machine with the card has no jax

import numpy as np  # noqa: E402

import torch_lm_mesh_serve_ranks as R  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

SHAPES = ((2, 2), (1, 4))
# fp32 values of scale ~1 from two frameworks' summation orders: the
# meshed logits stand up to ~1.5e-6 from repro's, an ulp or two (the
# single-card parity files hold the same at 5e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=240)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``repro``'s results and the port's ranks on each mesh of ``SHAPES``,
    from the same params and prompts (``R.write_inputs``): each mesh's
    ``repro`` child runs in the background while the port's ranks run."""
    import os
    import subprocess
    import sys

    from conftest import ROOT

    tmp = tmp_path_factory.mktemp("serve")
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
                               str(inputs)) for shape in SHAPES}
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
def test_meshed_serving_matches_repro(served, shape, name):
    ref, ranks = served
    tag = f"{name}/{shape[0]}x{shape[1]}"
    per = R.BATCH // shape[0]
    for r in ranks[shape]:
        got = r[name]
        rows = slice(r["coords"]["data"] * per, (r["coords"]["data"] + 1) * per)
        for i, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(logits, ref[f"{tag}/logits{i}"][rows], **TOL,
                                       err_msg=f"{tag} step {i} {r['coords']}")
        np.testing.assert_array_equal(got["tokens"], ref[f"{tag}/tokens"][rows])
        np.testing.assert_array_equal(got["generated"], got["tokens"])
        for k, block in got["cache"].items():
            kv = slice(got["kv0"], got["kv0"] + block.shape[3])
            np.testing.assert_allclose(block, ref[f"{tag}/cache/{k}"][:, rows, :, kv], **TOL,
                                       err_msg=f"{tag} cache {k}")


def test_world1_is_bitwise_the_single_card(tmp_path):
    [got] = _spawn(tmp_path, R.world1, (1, 1))
    assert got == {name: {"logits": True, "cache": True, "tokens": True} for name in R.CASES}


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_dry_run_counts_the_collectives_the_ranks_issue(arch, tmp_path):
    batch, seq = 2, 16
    real = _spawn(tmp_path, R.serve_sites, (1, 2), arch, batch, seq)
    b = registry.get(arch)
    for shard, want in enumerate(real):
        mesh = M.abstract_mesh((1, 2), ("data", "model"), (0, shard))
        for kind in ("prefill", "decode"):
            got = dryrun.trace_serve(b, b.smoke, kind, batch, seq, mesh=mesh)["sites"]
            assert got == dict(sorted(want[kind].items(), key=str)), (kind, shard)
            assert {"combine/model", "logits/model"} <= set(got)


def test_cache_block_is_the_rank_share():
    cfg = registry.get("qwen2-1.5b").config               # 12 q heads, 2 kv heads of 128
    at = lambda shape, coords: M.abstract_mesh(shape, ("data", "model"), coords)
    assert SH.cache_block(cfg, None, 8, 64) == (28, 8, 64, 2, 128)
    assert SH.cache_block(cfg, at((2, 2), (1, 1)), 8, 64) == (28, 4, 64, 1, 128)
    assert SH.cache_block(cfg, at((1, 4), (0, 3)), 8, 64) == (28, 8, 64, 1, 128)
    assert SH.cache_block(cfg, at((16, 16), (0, 0)), 128, 64) == (28, 8, 64, 2, 128)
    # a batch the data ranks do not divide stays whole on every rank
    assert SH.cache_block(cfg, at((4, 1), (0, 0)), 2, 64) == (28, 2, 64, 2, 128)


def test_serve_cli_on_a_mesh_prints_the_one_card_tokens(capfd):
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch", "2",
            "--prompt-len", "32", "--max-new", "8", "--compute-dtype", "float32"]
    firsts = []
    for extra in ([], ["--mesh-shape", "1,2"]):
        assert serve.main(argv + extra) == 0
        out = capfd.readouterr().out
        firsts.append([x for x in out.splitlines() if x.startswith("first sequence:")])
    assert len(firsts[0]) == 1 and firsts[0] == firsts[1]
    assert "2 cpu ranks, mesh (1, 2)" in out


@pytest.mark.parametrize("arch,item", [("pixtral-12b", "item 11"), ("whisper-large-v3", "item 11")])
def test_serve_cli_refuses_the_one_card_kinds_on_a_mesh(arch, item, capfd):
    # the name predates ROADMAP.md §1 ``item``, which brought these kinds'
    # mesh: on (2, 1) each data rank serves its sequence and its frames or
    # patches, the rank at coordinates 0 printing the gathered tokens
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--max-new", "4", "--compute-dtype", "float32"]
    firsts = []
    for extra in ([], ["--mesh-shape", "2,1"]):
        assert serve.main(argv + extra) == 0
        out = capfd.readouterr().out
        firsts.append([x for x in out.splitlines() if x.startswith("first sequence:")])
    assert len(firsts[0]) == 1 and firsts[0] == firsts[1]
    assert "generated (2, 4) in" in out and "2 cpu ranks, mesh (2, 1)" in out
