"""The LM side of ``repro_torch.launch.train`` on the CPU: train, checkpoint
and resume (``tests/test_launch.py``'s counterpart), SIGTERM, LM
checkpoints across the two packages (bitwise, both ways), the quickstart's
section 4, an LM on a mesh, and the refusal of a missing card without
``--device cpu``."""

import os
import signal
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

from repro.checkpoint import checkpointer as j_ckpt  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as t_T  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM = ["--arch", "qwen2-1.5b", "--smoke", "--batch", "4", "--seq", "32"]


def _port(tmp, steps, *extra):
    return t_train.main([*LM, "--device", "cpu", "--steps", str(steps), "--ckpt-dir",
                         str(tmp), "--ckpt-every", "2", "--log-every", "2", *extra])


def _like(embedding=None):
    cfg = t_registry.get("qwen2-1.5b").smoke
    if embedding:
        cfg = cfg.replace(embedding_kind=embedding)
    params, _ = t_T.init_lm(cfg, seed=5, device="cpu")
    return {"params": params, "opt": t_opt.init(params)}


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """6 steps with a checkpoint every 2; a second call starts at step 6 and
    does nothing more; the step lines are ``repro``'s."""
    assert _port(tmp_path, 6, "--microbatches", "2") == 0
    out = capsys.readouterr().out
    assert t_ckpt.latest_step(str(tmp_path)) == 6
    lines = [x for x in out.splitlines() if x.startswith("step")]
    assert [x.split()[1] for x in lines] == ["1", "2", "4", "6"]
    assert all(" loss " in x and " lr " in x and " gnorm " in x for x in lines)
    assert "done" in out
    assert _port(tmp_path, 6, "--microbatches", "2") == 0
    assert "[resume] step 6" in capsys.readouterr().out
    state, extra = t_ckpt.restore(str(tmp_path), 6, _like())
    assert extra["pipeline"] == {"seed": 0, "step": 6} and extra["arch"] == "qwen2-1.5b"
    assert int(state["opt"]["step"]) == 6


def test_cli_trains_a_qr_vocabulary_and_lowers_the_loss(tmp_path, capsys):
    """``--embedding qr`` applies to the LM; at a high learning rate the loss
    falls over 8 steps of uniform tokens (the unigram floor is log 512)."""
    assert _port(tmp_path, 8, "--embedding", "qr", "--lr", "3e-3", "--log-every", "1") == 0
    losses = [float(x.split()[3]) for x in capsys.readouterr().out.splitlines()
              if x.startswith("step")]
    assert len(losses) == 8 and losses[-1] < losses[0]
    state, _ = t_ckpt.restore(str(tmp_path), 8, _like("qr"))
    assert set(state["params"]["embed"]) == {"q", "r"}


def test_cli_checkpoints_and_exits_on_sigterm(tmp_path):
    # the child on one intra-op thread, as this module runs (torch_one_thread)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LM, "--device", "cpu", "--steps",
         "100000", "--log-every", "1", "--ckpt-dir", str(tmp_path)],
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


def test_lm_checkpoints_cross_packages_bitwise(tmp_path, capsys):
    """``repro.launch.train`` writes a qwen2-1.5b-smoke checkpoint at step 2:
    the port restores it bitwise and its CLI resumes there; the port's step-4
    checkpoint restores in ``repro`` bitwise and ``repro``'s CLI resumes
    there."""
    args = [*LM, "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--log-every", "2"]
    assert j_train.main([*args, "--steps", "2"]) == 0
    like = _like()
    state, extra = t_ckpt.restore(str(tmp_path), 2, like)
    assert extra["pipeline"] == {"seed": 0, "step": 2}
    path = tmp_path / "step_00000002"
    for i, (p, leaf) in enumerate(tree.leaves_with_paths(state)):
        saved = np.load(path / f"leaf_{i:05d}.npy")
        assert leaf.dtype == torch.from_numpy(saved).dtype, p
        assert np.array_equal(leaf.numpy(), saved), p
    capsys.readouterr()
    assert t_train.main([*args, "--device", "cpu", "--steps", "4"]) == 0
    assert "[resume] step 2" in capsys.readouterr().out

    ported, _ = t_ckpt.restore(str(tmp_path), 4, like)
    jlike = jax.tree.map(lambda t: np.zeros(tuple(t.shape), t.numpy().dtype),
                         tree.tree_map(lambda t: t, ported))
    jgot, jextra = j_ckpt.restore(str(tmp_path), 4, jlike)
    assert jextra["pipeline"] == {"seed": 0, "step": 4}
    for j, t in zip(jax.tree.leaves(jgot), tree.leaves(ported)):
        assert np.asarray(j).dtype == t.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
    assert j_train.main([*args, "--steps", "5"]) == 0
    assert "[resume] step 4" in capsys.readouterr().out


def test_quickstart_trains_the_qr_lm():
    """Section 4: qwen2-1.5b-smoke with a QR vocabulary (collision 8) over 10
    steps on one batch; the loss falls by more than 1."""
    res = quickstart.main(["--device", "cpu"])
    losses = res["lm_losses"]
    assert len(losses) == 10 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 1.0, losses


def test_cli_refuses_an_lm_on_a_mesh_and_a_missing_card(monkeypatch, tmp_path, capfd):
    """An LM on a mesh trains (it was refused before the meshed LM): two
    steps on (2, 2) checkpoint the full logical arrays; without a card and
    without ``--device cpu`` the CLI still refuses."""
    assert t_train.main([*LM, "--device", "cpu", "--mesh-shape", "2,2", "--steps", "2",
                         "--ckpt-dir", str(tmp_path), "--log-every", "1"]) == 0
    lines = [x for x in capfd.readouterr().out.splitlines() if x.startswith("step")]
    assert [x.split()[1] for x in lines] == ["1", "2"]      # rank (0, 0) alone prints
    state, _ = t_ckpt.restore(str(tmp_path), 2, _like())
    assert int(state["opt"]["step"]) == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main([*LM, "--steps", "1"])
