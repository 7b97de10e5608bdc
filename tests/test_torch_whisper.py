"""The port's whisper (``repro_torch.models.whisper``) against
``repro.models.whisper`` on the CPU: whisper-large-v3-smoke with a dense and
a QR (collision 8) vocabulary, on ``repro``'s params carried over by
``convert.lm_params_from_numpy`` and the same numpy frames and tokens.

The encoder runs over ``N_AUDIO`` = 1,536 frames even in the smoke config,
so the batch is 2 and the decoder 6 tokens, and ``repro``'s results are
computed once a vocabulary (``reference``, each function jitted once).
fp32 compute: the encoder's states, ``forward_train``'s logits, the
prefill's last logits and cache (the self k / v rows it filled, the cross
k / v), one decode step and ``sinusoid_positions`` to ``repro``'s bound,
1e-4 (rtol and atol); greedy tokens equal; ``make_prefixed_lm_loss``'s loss
to 1e-5 and its gradients to 1e-4 of each leaf's scale of ``jax.grad``'s.
Then the tree, the batches, the serve family and the CLIs (trained on
(1, 2) ranks, resumed on one card).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.train import serve_step as j_S  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_prefix_inputs import (  # noqa: E402
    LOSS_TOL, TOL, close, leaf_scale_close, prefix_pair, prefix_rows, tokens)

ARCH = "whisper-large-v3"
B, S_LEN, PREFILL, MAX_LEN = 2, 6, 5, 8
VOCABS = ("dense", "qr")


@functools.lru_cache(maxsize=None)
def reference(vocab: str) -> dict:
    """``repro``'s results on the smoke config with ``vocab`` (fp32), and
    the port's params and inputs on the same values."""
    jcfg, tcfg, jp, tp = prefix_pair(ARCH, vocab)
    frames = prefix_rows(B, jW.N_AUDIO, jcfg.d_model)
    toks = tokens(jcfg.vocab, B, S_LEN)
    jf, jt = jnp.asarray(frames), jnp.asarray(toks)
    pre, cache = jax.jit(jW.forward_prefill, static_argnames=("cfg", "max_len"))(
        jp, jf, jt[:, :PREFILL], jcfg, MAX_LEN)
    dec, dcache = jax.jit(jW.forward_decode, static_argnames="cfg")(
        jp, jt[:, PREFILL:], cache, jnp.int32(PREFILL), jcfg)
    loss_fn = j_ts.make_prefixed_lm_loss(jW.forward_train, jcfg, "frames")
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp, {"frames": jf, "tokens": jt})
    greedy = j_S.greedy_generate(j_S.serve_family("whisper"), jp,
                                 {"frames": jf, "tokens": jt[:, :4]}, jcfg, max_new=4,
                                 max_len=MAX_LEN)
    return {"jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp, "frames": frames, "tokens": toks,
            "encode": jax.jit(jW.encode, static_argnames="cfg")(jp, jf, jcfg),
            "train": jax.jit(jW.forward_train, static_argnames="cfg")(jp, jf, jt, jcfg),
            "prefill": pre, "cache": cache, "decode": dec, "decoded_cache": dcache,
            "loss": loss, "grads": grads, "greedy": np.asarray(greedy)}


def port_inputs(ref: dict):
    return torch.from_numpy(ref["frames"]), torch.from_numpy(ref["tokens"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_encode_matches_repro(vocab):
    ref = reference(vocab)
    frames, _ = port_inputs(ref)
    with torch.inference_mode():
        got = W.encode(ref["tp"], frames, ref["tcfg"])
    close(got, ref["encode"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_forward_train_matches_repro(vocab):
    ref = reference(vocab)
    with torch.inference_mode():
        got = W.forward_train(ref["tp"], *port_inputs(ref), ref["tcfg"])
    assert got.shape == (B, S_LEN, ref["tcfg"].vocab)
    close(got, ref["train"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_prefill_matches_repro(vocab):
    """The last logits, the self k / v rows [0, 5) the prefill filled (the
    rest zeros) and the cross k / v."""
    ref = reference(vocab)
    frames, toks = port_inputs(ref)
    with torch.inference_mode():
        lg, cache = W.forward_prefill(ref["tp"], frames, toks[:, :PREFILL], ref["tcfg"], MAX_LEN)
    close(lg, ref["prefill"])
    want = ref["cache"]
    assert set(cache) == set(want) == {"k", "v", "ck", "cv"}
    for key in ("k", "v"):
        close(cache[key][:, :, :PREFILL], np.asarray(want[key])[:, :, :PREFILL])
        assert not bool(cache[key][:, :, PREFILL:].any())
    for key in ("ck", "cv"):
        assert cache[key].shape[2] == W.N_AUDIO
        close(cache[key], want[key])


@pytest.mark.parametrize("vocab", VOCABS)
def test_decode_matches_repro(vocab):
    """One step at position 5 on the port's prefill cache: the logits, the
    row it wrote in place and the cross k / v left as they were."""
    ref = reference(vocab)
    frames, toks = port_inputs(ref)
    with torch.inference_mode():
        _, cache = W.forward_prefill(ref["tp"], frames, toks[:, :PREFILL], ref["tcfg"], MAX_LEN)
        ck = cache["ck"].clone()
        lg, out = W.forward_decode(ref["tp"], toks[:, PREFILL:], cache, PREFILL, ref["tcfg"])
    assert out is cache and torch.equal(out["ck"], ck)
    close(lg, ref["decode"])
    for key in ("k", "v"):
        close(out[key][:, :, :PREFILL + 1],
              np.asarray(ref["decoded_cache"][key])[:, :, :PREFILL + 1])


@pytest.mark.parametrize("n,dim", [(1536, 64), (1536, 1280), (7, 16), (1, 2)])
def test_sinusoid_positions_match_repro(n, dim):
    """The frequencies within one fp32 step of ``repro``'s (XLA's ``exp`` and
    torch's differ in the last bit for some), the table and the decode rows
    to 1e-4 plus what that step becomes at position p: p · 2^-23 (a
    frequency is at most 1, its step at most 2^-23 of it)."""
    half = dim // 2
    want_f = jnp.exp(-np.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / max(half - 1, 1))
    np.testing.assert_allclose(W._freqs(dim, "cpu").numpy(), np.asarray(want_f),
                               rtol=2.0 ** -23, atol=0)
    slack = TOL + np.arange(n)[:, None] * 2.0 ** -23
    got = W.sinusoid_positions(n, dim).double().numpy()
    assert (np.abs(got - np.asarray(jW.sinusoid_positions(n, dim), np.float64))
            <= slack + TOL * np.abs(got)).all()
    for pos in (0, n - 1):
        close(W._sinusoid_at(pos, dim, torch.float32)[0, 0], got[pos], 0)
        close(W._sinusoid_at(pos, dim, torch.float32),
              jW._sinusoid_at(jnp.int32(pos), dim, jnp.float32), TOL + pos * 2.0 ** -23)


@pytest.mark.parametrize("vocab", VOCABS)
def test_greedy_tokens_equal_repro(vocab):
    ref = reference(vocab)
    frames, toks = port_inputs(ref)
    got = S.greedy_generate(S.serve_family("whisper"), ref["tp"],
                            {"frames": frames, "tokens": toks[:, :4]}, ref["tcfg"], max_new=4,
                            max_len=MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_prefixed_loss_and_gradients_match_repro(vocab):
    """``registry.train_loss_fn`` (``make_prefixed_lm_loss`` on the frames):
    the loss to 1e-5 and each leaf's gradient to 1e-4 of its scale, every
    encoder and decoder layer recomputed in the backward."""
    ref = reference(vocab)
    frames, toks = port_inputs(ref)
    loss_fn = t_registry.train_loss_fn(t_registry.get(ARCH), ref["tcfg"])
    loss, metrics, grads = t_ts.value_and_grad(loss_fn, ref["tp"],
                                               {"frames": frames, "tokens": toks})
    assert metrics["loss"] == loss
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=LOSS_TOL)
    leaf_scale_close(grads, ref["grads"], TOL)


def test_decode_consistency():
    """``repro``'s test on the port (fp32): a prefill of 5 tokens and one
    decode step give the train forward's logits at positions 4 and 5."""
    ref = reference("dense")
    tp, tcfg = ref["tp"], ref["tcfg"]
    frames, toks = port_inputs(ref)
    with torch.inference_mode():
        full = W.forward_train(tp, frames, toks, tcfg)
        lg, cache = W.forward_prefill(tp, frames, toks[:, :PREFILL], tcfg, MAX_LEN)
        lg2, _ = W.forward_decode(tp, toks[:, PREFILL:], cache, PREFILL, tcfg)
    torch.testing.assert_close(lg[:, 0], full[:, PREFILL - 1], rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(lg2[:, 0], full[:, PREFILL], rtol=TOL, atol=TOL)


def test_bf16_train_logits_near_repro_fp32():
    """bf16 compute: the logits within 2e-2 of the scale of ``repro``'s fp32
    logits (the transformer tests' cross-framework bound)."""
    ref = reference("qr")
    with torch.inference_mode():
        got = W.forward_train(ref["tp"], *port_inputs(ref),
                              ref["tcfg"].replace(compute_dtype="bfloat16"))
    want = np.asarray(ref["train"], np.float64)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.double().numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())


def test_init_tree_matches_repro():
    """``repro``'s keys, shapes, dtypes and logical axes, the encoder's and
    the decoder's leaves stacked along a leading layer dim; the cache's
    shapes and axes too."""
    jcfg, tcfg = j_registry.get(ARCH).smoke, t_registry.get(ARCH).smoke
    jp, jaxes = jW.init_whisper(jax.random.PRNGKey(0), jcfg)
    tp, taxes = W.init_whisper(tcfg, seed=0, device="cpu")
    assert taxes == jaxes
    jl = dict(zip([p for p, _ in tree.leaves_with_paths(jp)], jax.tree.leaves(jp)))
    tl = dict(tree.leaves_with_paths(tp))
    assert set(tl) == set(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == jl[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == jl[path].dtype.name, path
    assert tl["enc/attn/wq/w"].shape[0] == tcfg.enc_layers
    assert tl["dec/xattn/wk/b"].shape[0] == tcfg.dec_layers
    jc = jW.init_cache(jcfg, 2, 9)
    tc = W.init_cache(tcfg, 2, 9, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert W.cache_axes() == jW.cache_axes()


def test_whisper_batch_is_a_pure_function_of_seed_and_step():
    cfg = t_registry.get(ARCH).smoke
    make = t_registry.make_batch_fn(t_registry.get(ARCH), cfg)
    a = make(2, 5, seed=3, step=1)
    assert list(a) == ["frames", "tokens"]
    assert a["frames"].shape == (2, W.N_AUDIO, cfg.d_model) and a["frames"].dtype == torch.float32
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == torch.int32
    assert abs(float(a["frames"].std()) - 1.0) < 0.02
    b = synthetic.whisper_batch(cfg, 2, 5, seed=3, step=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(a["tokens"], synthetic.lm_batch(cfg, 2, 5, seed=3, step=1)["tokens"])
    c = make(2, 5, seed=3, step=2)
    assert not torch.equal(a["frames"], c["frames"])


def test_serve_family_and_serving_params():
    """The registry's binding and the serve family: the weights cast once
    for serving give the same prefill, cache and decode bit for bit; the
    family's cache is ``init_cache``'s."""
    b = t_registry.get(ARCH)
    cfg = b.smoke.replace(embedding_kind="qr", qr_collision=8)
    params, _ = t_registry.init_fn(b)(cfg, seed=0, device="cpu")
    fam = S.serve_family(b.kind)
    served = fam.prepare(params, cfg)
    assert served["dec"]["xattn"]["wq"]["w"].dtype == torch.bfloat16
    assert served["dec"]["ln1"]["bias"].dtype == torch.float32
    batch = t_registry.make_batch_fn(b, cfg)(2, 4, seed=0, step=0)
    cache = fam.make_cache(cfg, 2, 7, device="cpu")
    assert {k: tuple(v.shape[:3]) for k, v in cache.items()} == {
        "k": (2, 2, 7), "v": (2, 2, 7), "ck": (2, 2, W.N_AUDIO), "cv": (2, 2, W.N_AUDIO)}
    with torch.inference_mode():
        a, ca = fam.prefill(served, batch, cfg, 7)
        c, cc = fam.prefill(params, batch, cfg, 7)
        assert a.shape == (2, 1, cfg.vocab) and torch.equal(a, c)
        assert all(torch.equal(ca[k], cc[k]) for k in ca)
        tok = torch.argmax(a[:, -1], -1)[:, None].to(torch.int32)
        a, _ = fam.decode(served, ca, tok, 4, cfg)
        c, _ = fam.decode(params, cc, tok, 4, cfg)
        assert torch.equal(a, c)


def test_remat_recomputes_each_layer_with_the_same_gradients():
    """``cfg.remat`` under grad checkpoints every encoder and decoder layer:
    the gradients equal those without it, bitwise, and nothing is
    checkpointed without grad."""
    _, tcfg, _, tp = prefix_pair(ARCH, "qr")
    batch = {"frames": torch.from_numpy(prefix_rows(1, W.N_AUDIO, tcfg.d_model)),
             "tokens": torch.from_numpy(tokens(tcfg.vocab, 1, 4))}
    calls = []
    saved = W.T.ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return saved(*a, **kw)

    W.T.ckpt.checkpoint = counted
    try:
        grads = {}
        for remat in (True, False):
            loss_fn = t_registry.train_loss_fn(t_registry.get(ARCH), tcfg.replace(remat=remat))
            grads[remat] = t_ts.value_and_grad(loss_fn, tp, batch)[2]
        assert len(calls) == tcfg.enc_layers + tcfg.dec_layers
        with torch.no_grad():
            W.forward_train(tp, batch["frames"], batch["tokens"], tcfg)
        assert len(calls) == tcfg.enc_layers + tcfg.dec_layers
    finally:
        W.T.ckpt.checkpoint = saved
    for a, b in zip(tree.leaves(grads[True]), tree.leaves(grads[False])):
        assert torch.equal(a, b)


def test_serve_cli_runs_whisper_on_the_cpu(capsys):
    assert t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--embedding", "qr",
                         "--batch", "2", "--prompt-len", "6", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) in" in out and "tok/s on cpu" in out


def test_train_cli_trains_whisper_resumes_and_refuses_a_mesh(tmp_path, capfd):
    # the name predates the mesh (ROADMAP.md §1 item 11, now done): trained
    # on (1, 2) ranks, resumed on one card
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "8",
            "--embedding", "qr", "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    assert t_train.main([*argv, "--steps", "2", "--mesh-shape", "1,2"]) == 0
    assert t_train.main([*argv, "--steps", "3"]) == 0
    out = capfd.readouterr().out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[resume] step 2" in out
