"""The port's MoE transformers against ``repro`` on the CPU:
granite-moe-3b-a800m-smoke and qwen3-moe-235b-a22b-smoke with a dense and a
QR (collision 8) vocabulary, on ``repro``'s params carried over by
``convert.lm_params_from_numpy`` and the same numpy tokens; then the CLIs.

Bounds: the forwards as ``tests/test_torch_lm_transformer.py`` holds the
dense ones (fp32 compute to 5e-5, bf16 to 2e-2 of the logits' scale), one
training step as ``tests/test_torch_lm_train_step.py`` (fp32: the loss to
1e-5, the updated params to rtol 2e-4 / atol 2e-5; bf16: the loss and the
norm to 2e-2 relative), greedy tokens equal.  Each arch runs both
vocabularies in fp32 and one in bf16 (a repeat would test nothing new).
The smoke configs drop assignments (capacity factor 1.25, 24 tokens):
both packages drop the same ones.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import transformer as j_T  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import serve_step as j_S  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_lm_inputs import lm_pair, tokens  # noqa: E402

MOE = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
FP32_TOL = 5e-5
BF16_SCALE = 2e-2
OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)   # test_torch_lm_train_step's
FP32_CASES = [(a, v) for a in MOE for v in ("dense", "qr")]
BF16_CASES = list(zip(MOE, ("qr", "dense")))


def close(got: torch.Tensor, want, compute: str) -> None:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert float(np.abs(got - want).max()) <= BF16_SCALE * float(np.abs(want).max())


@pytest.mark.parametrize("arch,vocab,compute", [(*c, "float32") for c in FP32_CASES]
                         + [(*c, "bfloat16") for c in BF16_CASES])
def test_forwards_match_repro(arch, vocab, compute):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab, compute)
    toks = tokens(jcfg.vocab, 2, 12)
    with torch.inference_mode():
        close(T.forward_train(tp, torch.from_numpy(toks), tcfg),
              j_T.forward_train(jp, jnp.asarray(toks), jcfg), compute)
        jlg, jcache = j_T.forward_prefill(jp, jnp.asarray(toks[:, :11]), jcfg, max_len=16)
        tlg, tcache = T.forward_prefill(tp, torch.from_numpy(toks[:, :11]), tcfg, 16)
        close(tlg, jlg, compute)
        for key in ("k", "v"):
            close(tcache[key], jcache[key], compute)
        jlg2, _ = j_T.forward_decode(jp, jnp.asarray(toks[:, 11:12]), jcache, jnp.int32(11),
                                     jcfg)
        tlg2, _ = T.forward_decode(tp, torch.from_numpy(toks[:, 11:12]), tcache, 11, tcfg)
        close(tlg2, jlg2, compute)


@pytest.mark.parametrize("arch", MOE)
def test_init_lm_tree_matches_repro(arch):
    """``params["layers"]["moe"]`` in place of ``mlp``, ``repro``'s keys,
    shapes, dtypes and logical axes."""
    jcfg, tcfg = j_registry.get(arch).smoke, t_registry.get(arch).smoke
    jp, jaxes = j_T.init_lm(jax.random.PRNGKey(0), jcfg)
    tp, taxes = T.init_lm(tcfg, seed=0, device="cpu")
    assert taxes == jaxes and "mlp" not in tp["layers"]
    jl = dict(zip([p for p, _ in tree.leaves_with_paths(jp)], jax.tree.leaves(jp)))
    tl = dict(tree.leaves_with_paths(tp))
    assert set(tl) == set(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == jl[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == jl[path].dtype.name, path


@pytest.mark.parametrize("arch,vocab", BF16_CASES)
def test_greedy_tokens_equal_repro(arch, vocab):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab)
    prompt = tokens(jcfg.vocab, 2, 8, seed=3)
    want = j_S.greedy_generate(j_S.serve_family("transformer"), jp,
                               {"tokens": jnp.asarray(prompt)}, jcfg, max_new=5, max_len=13)
    got = S.greedy_generate(S.serve_family("transformer"), tp,
                            {"tokens": torch.from_numpy(prompt)}, tcfg, max_new=5, max_len=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_decode_reproduces_the_train_forward_where_nothing_drops(arch):
    """``repro``'s consistency test on the port (fp32) at a capacity factor
    of ``num_experts / top_k``, where a decode step's capacity holds every
    assignment; at the config's 1.25 a decode step of 2 tokens drops what
    the 24-token forward keeps, by design."""
    _, tcfg, _, tp = lm_pair(arch, "dense")
    tcfg = tcfg.replace(capacity_factor=tcfg.num_experts / tcfg.top_k)
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 12))
    with torch.inference_mode():
        full = T.forward_train(tp, toks, tcfg)
        lg, cache = T.forward_prefill(tp, toks[:, :11], tcfg, 16)
        torch.testing.assert_close(lg[:, 0], full[:, 10], rtol=FP32_TOL, atol=FP32_TOL)
        lg2, _ = T.forward_decode(tp, toks[:, 11:12], cache, 11, tcfg)
        torch.testing.assert_close(lg2[:, 0], full[:, 11], rtol=FP32_TOL, atol=FP32_TOL)


def one_step(arch, vocab, compute):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab, compute)
    toks = tokens(jcfg.vocab, 4, 16)
    jstep = jax.jit(j_ts.make_train_step(
        j_registry.train_loss_fn(j_registry.get(arch), jcfg), j_opt.OptConfig(**OPT),
        microbatches=2))
    tstep = t_ts.make_train_step(t_registry.train_loss_fn(t_registry.get(arch), tcfg),
                                 t_opt.OptConfig(**OPT), microbatches=2)
    jnew, _, jm = jstep(jp, j_opt.init(jp), {"tokens": jnp.asarray(toks)})
    tnew, _, tm = tstep(tp, t_opt.init(tp), {"tokens": torch.from_numpy(toks)})
    return jnew, jm, tnew, tm


@pytest.mark.parametrize("arch,vocab", FP32_CASES)
def test_train_step_matches_repro_fp32(arch, vocab):
    jnew, jm, tnew, tm = one_step(arch, vocab, "float32")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tl, jl = list(tree.leaves_with_paths(tnew)), jax.tree.leaves(jnew)
    assert len(tl) == len(jl)
    for (path, t), j in zip(tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5,
                                   err_msg=path)


@pytest.mark.parametrize("arch,vocab", BF16_CASES)
def test_train_step_matches_repro_bf16(arch, vocab):
    jnew, jm, tnew, tm = one_step(arch, vocab, "bfloat16")
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-2 * abs(float(jm[key])), key
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(tnew))


@pytest.mark.parametrize("arch,vocab", BF16_CASES)
def test_serving_params_give_the_same_logits_bitwise(arch, vocab):
    """The expert stacks cast once to bf16, the router kept in fp32: the
    same logits, bit for bit, as the params cast on every call."""
    _, tcfg, _, tp = lm_pair(arch, vocab, "bfloat16")
    served = T.serving_params(tp, tcfg)
    m = served["layers"]["moe"]
    assert {k: m[k].dtype for k in m} == {"router": torch.float32, "w_up": torch.bfloat16,
                                          "w_gate": torch.bfloat16, "w_down": torch.bfloat16}
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 10))
    with torch.inference_mode():
        assert torch.equal(T.forward_train(served, toks, tcfg), T.forward_train(tp, toks, tcfg))
        a, ca = T.forward_prefill(served, toks[:, :9], tcfg, 12)
        b, cb = T.forward_prefill(tp, toks[:, :9], tcfg, 12)
        assert torch.equal(a, b) and torch.equal(ca["v"], cb["v"])
        a, _ = T.forward_decode(served, toks[:, 9:], ca, 9, tcfg)
        b, _ = T.forward_decode(tp, toks[:, 9:], cb, 9, tcfg)
        assert torch.equal(a, b)


def test_convert_carries_the_moe_subtree_bf16_included():
    """``lm_params_from_numpy`` carries ``repro``'s bf16 ``moe`` leaves
    value for value, and the port computes on them as ``repro`` does."""
    arch = MOE[0]
    jcfg = j_registry.get(arch).smoke.replace(param_dtype="bfloat16")
    tcfg = t_registry.get(arch).smoke.replace(param_dtype="bfloat16")
    jp, _ = j_T.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for k, v in jp["layers"]["moe"].items():
        got = tp["layers"]["moe"][k]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(v, np.float32))
    toks = tokens(jcfg.vocab, 2, 12)
    with torch.inference_mode():
        close(T.forward_train(tp, torch.from_numpy(toks), tcfg),
              j_T.forward_train(jp, jnp.asarray(toks), jcfg), "bfloat16")


@pytest.mark.parametrize("arch,vocab", BF16_CASES)
def test_serve_cli_runs_an_moe_arch_on_the_cpu(arch, vocab, capsys):
    assert t_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--embedding", vocab,
                         "--batch", "2", "--prompt-len", "16", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out and "tok/s on cpu" in out


def test_train_cli_trains_an_moe_arch_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", MOE[0], "--smoke", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--embedding", "qr", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    assert t_train.main([*argv, "--steps", "4"]) == 0
    out = capsys.readouterr().out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 4 and all(np.isfinite(losses)) and "done" in out
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    assert t_train.main([*argv, "--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "[resume] step 4" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["5", "6"]
