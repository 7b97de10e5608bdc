"""One ``make_train_step`` step of the port's LM against ``repro``'s
jitted step on the CPU: the four dense smoke configs (qwen2-1.5b,
granite-34b, chatglm3-6b, minitron-4b) x the dense, hashed, QR (collision
8) and TT vocabularies, microbatches 2, on ``repro``'s params carried over
by ``convert.lm_params_from_numpy`` and the same numpy tokens.

Tolerances: in fp32 compute the loss to 1e-5 and the updated params to
rtol 2e-4 / atol 2e-5, the bounds of
``tests/test_train.py::test_microbatch_equivalence`` (AdamW's eps set to
1e-2, ``OPT``); in bf16 compute the loss and the gradient norm to 2e-2
relative, ROADMAP.md's cross-framework bound (the frameworks round the bf16
products, attention's scaled q and P·V's P at other places).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_lm_inputs import lm_pair, tokens  # noqa: E402

ARCHS = ("qwen2-1.5b", "granite-34b", "chatglm3-6b", "minitron-4b")
VOCABS = ("dense", "hashed", "qr", "tt")
# AdamW's first step moves an entry by lr u, u = g / (|g| + eps), and
# |du| <= |dg| / eps: at the default eps 1e-8 an entry whose |g| is near 1e-8
# moves by anything up to lr when the two frameworks' fp32 sums differ in the
# last bit; eps 1e-2 bounds the change (chip_smoke.LMT_REF_OPT), so the
# params hold the gradients too
OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)
BF16_REL = 2e-2


def one_step(arch, vocab, compute, microbatches=2):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab, compute)
    toks = tokens(jcfg.vocab, 4, 16)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    jstep = jax.jit(j_ts.make_train_step(
        j_registry.train_loss_fn(j_registry.get(arch), jcfg), j_opt.OptConfig(**OPT),
        microbatches=microbatches))
    tstep = t_ts.make_train_step(t_registry.train_loss_fn(t_registry.get(arch), tcfg),
                                 t_opt.OptConfig(**OPT), microbatches=microbatches)
    jnew, _, jm = jstep(jp, j_opt.init(jp), jb)
    tnew, tstate, tm = tstep(tp, t_opt.init(tp), tb)
    assert int(tstate["step"]) == 1
    return jnew, jm, tnew, tm


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_repro_fp32(arch, vocab):
    jnew, jm, tnew, tm = one_step(arch, vocab, "float32")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tl = list(tree.leaves_with_paths(tnew))
    jl = jax.tree.leaves(jnew)
    assert len(tl) == len(jl)
    for (path, t), j in zip(tl, jl):
        assert tuple(t.shape) == j.shape, path
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5,
                                   err_msg=path)


@pytest.mark.parametrize("arch,vocab", list(zip(ARCHS, VOCABS)))
def test_train_step_matches_repro_bf16(arch, vocab):
    """bf16 compute, each arch with one of the vocabularies."""
    jnew, jm, tnew, tm = one_step(arch, vocab, "bfloat16")
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= BF16_REL * abs(float(jm[key])), key
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(tnew))
