"""The port's LM serving entry points on the CPU: ``launch.serve`` and
``examples.serve_lm`` run the smoke configs with ``--device cpu``; without
it and without a card the CLI raises; none of the LM modules imports jax or
``repro``.  (No jax here: the file runs where the card is too.)"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("arch,embedding", [("qwen2-1.5b", "dense"), ("qwen2-1.5b", "qr"),
                                            ("granite-34b", "hashed"),
                                            ("chatglm3-6b", "qr"), ("minitron-4b", None)])
def test_serve_cli_runs_on_the_cpu(arch, embedding, capsys):
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "16",
            "--max-new", "4"]
    if embedding:
        argv += ["--embedding", embedding]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out and "tok/s on cpu" in out
    first = out.split("first sequence:")[1].strip()
    assert len(eval(first)) == 4


def test_serve_cli_is_deterministic(capsys):
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--embedding", "qr",
            "--seed", "3", "--max-new", "3"]
    serve.main(argv)
    a = capsys.readouterr().out.split("first sequence:")[1]
    serve.main(argv)
    assert capsys.readouterr().out.split("first sequence:")[1] == a


def test_serve_cli_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        serve.main(["--arch", "qwen2-1.5b", "--smoke"])


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_serve_cli_refuses_an_unported_arch(arch, capsys):
    """No arch of the registry is refused: the prefix models serve on the
    CPU, their batches carrying the frames or the patches; an arch outside
    the registry is refused by name."""
    assert serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--max-new", "2"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 2) in" in out and "tok/s on cpu" in out
    with pytest.raises(KeyError, match="unknown arch"):
        serve.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu"])


def test_serve_lm_example_runs_on_the_cpu(capsys):
    serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "xlstm-125m (qr embedding): generated (2, 4)" in out
    assert "steady-state decode:" in out


@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_serve_lm_example_runs_the_prefix_models(arch, capsys):
    serve_lm.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                   "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"{arch} (qr embedding): generated (2, 3)" in out
    assert "steady-state decode:" in out


def test_lm_modules_import_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.configs.registry, repro_torch.configs.base\n"
        "import repro_torch.models.transformer, repro_torch.models.layers\n"
        "import repro_torch.models.mamba2, repro_torch.models.zamba2\n"
        "import repro_torch.models.xlstm, repro_torch.launch.train\n"
        "import repro_torch.models.whisper, repro_torch.models.pixtral\n"
        "import repro_torch.train.serve_step, repro_torch.launch.serve\n"
        "import repro_torch.examples.serve_lm, repro_torch.data.synthetic\n"
        "import repro_torch.convert, repro_torch.kernels.ops\n"
        "for m in ('qwen2_1_5b', 'granite_34b', 'chatglm3_6b', 'minitron_4b', 'zamba2_7b',\n"
        "          'xlstm_125m', 'whisper_large_v3', 'pixtral_12b', 'granite_moe_3b_a800m',\n"
        "          'qwen3_moe_235b_a22b'):\n"
        "    __import__('repro_torch.configs.' + m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
