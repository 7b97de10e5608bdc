"""Greedy generation and init of the port's dense transformer against
``repro`` on the CPU.

``serve_step.greedy_generate``'s tokens equal ``repro``'s in fp32 compute,
for the four dense smoke configs with dense, hashed and QR (collision 8)
vocabularies, on ``repro``'s params and the same numpy prompts.
``transformer.init_lm``'s tree has ``repro``'s keys, shapes, dtypes and
logical axes, and each leaf's standard deviation lies within 5% of
``repro``'s draw's (the numbers differ: ``torch.Generator`` against
``jax.random``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.train import serve_step as jS  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from test_torch_lm_transformer import ARCHS, VOCABS, lm_pair, tokens  # noqa: E402


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_repro(arch, vocab):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab, "float32")
    prompt = tokens(jcfg, 2, 8, seed=3)
    want = jS.greedy_generate(jS.serve_family("transformer"), jp, {"tokens": jnp.asarray(prompt)},
                              jcfg, max_new=5, max_len=13)
    got = S.greedy_generate(S.serve_family("transformer"), tp,
                            {"tokens": torch.from_numpy(prompt)}, tcfg, max_new=5, max_len=13)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_serves_from_cast_params():
    """``ServeFamily.prepare`` (the weights cast once) gives the tokens of
    the params as drawn, in bf16 compute."""
    _, tcfg, _, tp = lm_pair("minitron-4b", "qr", "bfloat16")
    fam = S.serve_family("transformer")
    batch = {"tokens": torch.from_numpy(tokens(tcfg, 2, 8, seed=4))}
    a = S.greedy_generate(fam, fam.prepare(tp, tcfg), batch, tcfg, max_new=4, max_len=12)
    b = S.greedy_generate(fam, tp, batch, tcfg, max_new=4, max_len=12)
    assert torch.equal(a, b)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_repro(arch, vocab):
    kw = dict(embedding_kind=vocab, qr_collision=8)
    jcfg = jregistry.get(arch).smoke.replace(**kw)
    tcfg = tregistry.get(arch).smoke.replace(**kw)
    jp, jaxes = jT.init_lm(jax.random.PRNGKey(0), jcfg)
    tp, taxes = T.init_lm(tcfg, seed=0, device="cpu")
    assert taxes == jaxes
    jl, tl = dict(_leaves(jp)), dict(_leaves(tp))
    assert set(tl) == set(jl)
    for path, jleaf in jl.items():
        leaf = tl[path]
        assert tuple(leaf.shape) == jleaf.shape, path
        assert str(leaf.dtype).replace("torch.", "") == jleaf.dtype.name, path
        want = float(np.std(np.asarray(jleaf, np.float64)))
        assert abs(float(leaf.double().std(unbiased=False)) - want) <= 0.05 * want, path


def test_cache_has_repro_layout_and_axes():
    jcfg, tcfg, _, _ = lm_pair("chatglm3-6b", "dense", "bfloat16")
    cache = T.init_cache(tcfg, 3, 20, device="cpu")
    want = jT.init_cache(jcfg, 3, 20)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == want[key].shape
        assert cache[key].dtype == torch.bfloat16 and not cache[key].any()
    assert T.cache_axes() == jT.cache_axes()
    assert S.serve_family("transformer").cache_axes() == jT.cache_axes()
