"""The port's dense transformer (``repro_torch.models.transformer``) against
``repro.models.transformer`` on the CPU: the four dense smoke configs
(qwen2-1.5b, granite-34b, chatglm3-6b, minitron-4b) with a dense, a hashed
and a QR (collision 8) vocabulary, on ``repro``'s params carried over by
``convert.lm_params_from_numpy`` and the same numpy tokens.

``forward_train``, ``forward_prefill`` (last logits and the cache, value
for value) and ``forward_decode`` agree with ``repro``: in fp32 compute to
``repro``'s own consistency bound, 5e-5 (rtol and atol); in bf16 compute to
2e-2 of the logits' (or the cache's) scale, ROADMAP.md's cross-framework
bound (attention inside: ``repro`` scales q in bf16 and feeds P·V a bf16 P,
the port's K9 plain version works in fp32).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("qwen2-1.5b", "granite-34b", "chatglm3-6b", "minitron-4b")
VOCABS = ("dense", "hashed", "qr")
FP32_TOL = 5e-5
BF16_SCALE = 2e-2


def lm_pair(arch: str, vocab: str, compute: str = "float32", seed: int = 0):
    """(repro cfg, port cfg, repro params, port params) on the same weights."""
    kw = dict(compute_dtype=compute, embedding_kind=vocab)
    if vocab == "qr":
        kw["qr_collision"] = 8
    jcfg = jregistry.get(arch).smoke.replace(**kw)
    tcfg = tregistry.get(arch).smoke.replace(**kw)
    jp, _ = jT.init_lm(jax.random.PRNGKey(seed), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def tokens(cfg, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def close(got: torch.Tensor, want, compute: str) -> None:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert float(np.abs(got - want).max()) <= BF16_SCALE * float(np.abs(want).max())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forwards_match_repro(arch, vocab, compute):
    jcfg, tcfg, jp, tp = lm_pair(arch, vocab, compute)
    toks = tokens(jcfg, 2, 12)
    with torch.inference_mode():
        close(T.forward_train(tp, torch.from_numpy(toks), tcfg),
              jT.forward_train(jp, jnp.asarray(toks), jcfg), compute)

        jlg, jcache = jT.forward_prefill(jp, jnp.asarray(toks[:, :11]), jcfg, max_len=16)
        tlg, tcache = T.forward_prefill(tp, torch.from_numpy(toks[:, :11]), tcfg, 16)
        close(tlg, jlg, compute)
        for key in ("k", "v"):
            assert tcache[key].dtype == tcfg.cdtype
            close(tcache[key], jcache[key], compute)

        jlg2, jcache2 = jT.forward_decode(jp, jnp.asarray(toks[:, 11:12]), jcache,
                                          jnp.int32(11), jcfg)
        tlg2, tcache2 = T.forward_decode(tp, torch.from_numpy(toks[:, 11:12]), tcache, 11, tcfg)
        close(tlg2, jlg2, compute)
        for key in ("k", "v"):
            assert tcache2[key] is tcache[key]           # the one cache, written in place
            close(tcache2[key], jcache2[key], compute)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_reproduces_the_train_forward(arch):
    """``repro``'s consistency test on the port alone, fp32 compute."""
    _, tcfg, _, tp = lm_pair(arch, "dense")
    toks = torch.from_numpy(tokens(tcfg, 2, 12))
    with torch.inference_mode():
        full = T.forward_train(tp, toks, tcfg)
        lg, cache = T.forward_prefill(tp, toks[:, :11], tcfg, 16)
        torch.testing.assert_close(lg[:, 0], full[:, 10], rtol=FP32_TOL, atol=FP32_TOL)
        lg2, _ = T.forward_decode(tp, toks[:, 11:12], cache, 11, tcfg)
        torch.testing.assert_close(lg2[:, 0], full[:, 11], rtol=FP32_TOL, atol=FP32_TOL)


@pytest.mark.parametrize("vocab", VOCABS)
def test_serving_params_give_the_same_logits_bitwise(vocab):
    """Weights cast once to bf16 serve the same logits, bit for bit, as the
    fp32 weights cast on every call (qwen2 tied, chatglm3 untied)."""
    for arch in ("qwen2-1.5b", "chatglm3-6b"):
        _, tcfg, _, tp = lm_pair(arch, vocab, "bfloat16")
        served = T.serving_params(tp, tcfg)
        assert served["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
        assert served["layers"]["ln1"]["scale"].dtype == torch.float32
        toks = torch.from_numpy(tokens(tcfg, 2, 10))
        with torch.inference_mode():
            assert torch.equal(T.forward_train(served, toks, tcfg),
                               T.forward_train(tp, toks, tcfg))
            a, ca = T.forward_prefill(served, toks[:, :9], tcfg, 12)
            b, cb = T.forward_prefill(tp, toks[:, :9], tcfg, 12)
            assert torch.equal(a, b) and torch.equal(ca["k"], cb["k"])
            a, _ = T.forward_decode(served, toks[:, 9:], ca, 9, tcfg)
            b, _ = T.forward_decode(tp, toks[:, 9:], cb, 9, tcfg)
            assert torch.equal(a, b)


def test_unported_execution_knobs_raise():
    """``flash_block_dtype="bf16"`` no longer raises (K9's bf16
    probability tile; ``tests/test_torch_fsdp.py`` holds its logits to
    ``repro``'s); ``embedding_exec="twolevel"`` off a mesh is the plain
    lookup, as ``repro``'s ``token_embed_inline`` falls back to it: the
    logits are the ``gspmd`` path's, bit for bit."""
    _, tcfg, _, tp = lm_pair("qwen2-1.5b", "qr")
    toks = torch.from_numpy(tokens(tcfg, 2, 8))
    with torch.inference_mode():
        tile = T.forward_train(tp, toks, tcfg.replace(flash_block_dtype="bf16"))
    assert tile.shape == (2, 8, tcfg.vocab) and bool(torch.isfinite(tile).all())
    with torch.inference_mode():
        assert torch.equal(T.forward_train(tp, toks, tcfg.replace(embedding_exec="twolevel")),
                           T.forward_train(tp, toks, tcfg))
