"""The training launcher on a mesh, no ``repro`` (this file runs where jax
is absent too): ``--mesh-shape 2,2`` then ``4,1`` under one ``--ckpt-dir``
resumes at step 4 (``repro``'s ``test_train_elastic_mesh_restart``), the
checkpoint holds the full logical arrays (it restores on one card), one
rank's stop flag stops every rank at the same step with a checkpoint, and
SIGTERM to the launcher reaches the ranks, which checkpoint and exit 0."""

import os
import signal
import subprocess
import sys

import torch
from torch_one_thread import one_thread  # noqa: F401

import test_torch_mesh_ranks as R
from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.launch import train as train_cli
from repro_torch.models import dlrm
from repro_torch.train import optimizer as opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(tmp, steps, mesh, *extra):
    return ["--arch", "dlrm-qr", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--batch", "16", "--lr", "3e-3", "--log-every", "1", "--ckpt-dir", str(tmp),
            "--ckpt-every", "2", "--mesh-shape", mesh, *extra]


def test_cli_trains_on_2x2_and_resumes_on_4x1(tmp_path, capfd):
    assert train_cli.main(_argv(tmp_path, 4, "2,2")) == 0
    cap = capfd.readouterr()
    out = cap.out
    assert "mesh (2, 2) over ('data', 'model'), backend gloo" in cap.err
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in lines] == [1, 2, 3, 4]   # rank (0, 0) alone
    assert ckpt.latest_step(str(tmp_path)) == 4
    # the full logical arrays: the checkpoint restores on one card
    cfg = R.config("dlrm-qr-smoke")
    p0 = dlrm.init_dlrm(cfg, seed=0, device="cpu")
    state, extra = ckpt.restore(str(tmp_path), 4, {"params": p0, "opt": opt.init(p0)})
    assert extra["pipeline"] == {"seed": 0, "step": 4}
    assert tuple(state["opt"]["mu"]["tables"][0]["q"].shape) == (512, 32)
    assert int(state["opt"]["step"]) == 4
    assert not torch.equal(state["params"]["tables"][0]["q"], p0["tables"][0]["q"])

    assert train_cli.main(_argv(tmp_path, 8, "4,1")) == 0
    out = capfd.readouterr().out
    assert "[resume] step 4" in out
    steps = [int(ln.split()[1]) for ln in out.splitlines() if ln.startswith("step")]
    assert steps == [5, 6, 7, 8]
    assert ckpt.latest_step(str(tmp_path)) == 8
    again, _ = ckpt.restore(str(tmp_path), 8, {"params": p0, "opt": opt.init(p0)})
    assert int(again["opt"]["step"]) == 8
    assert all(torch.isfinite(x).all() for x in tree.leaves(again))


def test_one_ranks_stop_flag_stops_every_rank_at_the_same_step(tmp_path):
    res = R.spawn_cpu(tmp_path, R.cli_run, (2, 2), _argv(tmp_path / "ck", 6, "2,2"), 3, 2)
    assert [r["step"] for r in res] == [2, 2, 2, 2]
    assert all(r["rc"] == 0 and len(r["losses"]) == 2 for r in res)
    assert ckpt.latest_step(str(tmp_path / "ck")) == 2


def test_sigterm_to_the_launcher_checkpoints_every_rank_and_exits_0(tmp_path):
    # the child on one intra-op thread, as this module runs (torch_one_thread)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_argv(tmp_path, 100000, "2,2", "--ckpt-every", "100000")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("step"):
                proc.send_signal(signal.SIGTERM)
                break
        out, _ = proc.communicate(timeout=180)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    assert out.count("[preempt]") == 1          # printed by rank (0, 0) alone
    step = ckpt.latest_step(str(tmp_path))
    assert step is not None and step < 100000
    assert f"[preempt] checkpointing at step {step} and exiting" in out
