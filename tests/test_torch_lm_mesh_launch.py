"""The LM's training launcher on a mesh, no ``repro`` (this file runs where
jax is absent too): qwen2-1.5b-smoke with a QR vocabulary on ``--mesh-shape
2,2`` for 4 steps, then ``1,2`` under the same ``--ckpt-dir`` resumes at
step 4, then one rank without ``--mesh-shape`` resumes at step 6 (the
checkpoint holds the full logical arrays); SIGTERM to a meshed run reaches
the ranks, which checkpoint and exit 0; and the elastic example trains on
(2, 4), checkpoints, and resumes on (1, 4)."""

import os
import signal
import subprocess
import sys

import torch
from torch_one_thread import one_thread  # noqa: F401

from repro_torch import tree
from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs import registry
from repro_torch.examples import elastic_restart
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(tmp, steps, *extra):
    return ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--steps", str(steps),
            "--batch", "8", "--seq", "32", "--embedding", "qr", "--log-every", "1",
            "--ckpt-dir", str(tmp), "--ckpt-every", "2", *extra]


def _steps(out: str) -> list:
    return [int(ln.split()[1]) for ln in out.splitlines() if ln.startswith("step")]


def test_cli_trains_on_2x2_resumes_on_1x2_then_on_one_rank(tmp_path, capfd):
    assert train_cli.main(_argv(tmp_path, 4, "--mesh-shape", "2,2")) == 0
    cap = capfd.readouterr()
    assert "mesh (2, 2) over ('data', 'model'), backend gloo" in cap.err
    assert _steps(cap.out) == [1, 2, 3, 4]            # rank (0, 0) alone prints
    assert ckpt.latest_step(str(tmp_path)) == 4

    assert train_cli.main(_argv(tmp_path, 6, "--mesh-shape", "1,2")) == 0
    out = capfd.readouterr().out
    assert "[resume] step 4" in out and _steps(out) == [5, 6]

    assert train_cli.main(_argv(tmp_path, 8)) == 0
    out = capfd.readouterr().out
    assert "[resume] step 6" in out and _steps(out) == [7, 8]
    cfg = registry.get("qwen2-1.5b").smoke.replace(embedding_kind="qr")
    p0, _ = T.init_lm(cfg, seed=0, device="cpu")
    state, extra = ckpt.restore(str(tmp_path), 8, {"params": p0, "opt": opt.init(p0)})
    assert extra["pipeline"] == {"seed": 0, "step": 8} and int(state["opt"]["step"]) == 8
    # the full logical arrays: the padded Q table, qwen2's whole kv projections
    assert tuple(state["params"]["embed"]["q"].shape) == (128, cfg.d_model)
    assert tuple(state["opt"]["mu"]["layers"]["attn"]["wk"]["w"].shape) == (
        cfg.num_layers, cfg.d_model, cfg.kv_heads * cfg.head_dim_)
    assert all(bool(torch.isfinite(x).all()) for x in tree.leaves(state))


def test_sigterm_to_a_meshed_lm_run_checkpoints_every_rank_and_exits_0(tmp_path):
    # the child on one intra-op thread, as this module runs (torch_one_thread)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_argv(tmp_path, 100000, "--ckpt-every", "100000", "--mesh-shape", "1,2")],
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
    assert "[preempt] checkpointing at step" in out
    step = ckpt.latest_step(str(tmp_path))
    assert step is not None and f"step {step} and exiting" in out


def test_elastic_example_resumes_on_the_degraded_mesh(tmp_path, capsys):
    res = elastic_restart.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "phase 2: resumed step 6 on degraded mesh (data=1, model=4)" in out
    assert res["healthy"]["start"] == 0 and res["degraded"]["start"] == 6
    losses = res["healthy"]["losses"] + res["degraded"]["losses"]
    assert len(losses) == 12 and all(torch.isfinite(torch.tensor(losses)))
    assert ckpt.latest_step(str(tmp_path)) == 12
