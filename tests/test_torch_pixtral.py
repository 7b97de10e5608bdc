"""The port's pixtral (``repro_torch.models.pixtral``) against
``repro.models.pixtral`` on the CPU: pixtral-12b-smoke (8 patches in front
of the tokens) with a dense and a QR (collision 8) vocabulary, on
``repro``'s params carried over by ``convert.lm_params_from_numpy`` and the
same numpy patches and tokens.

``repro``'s results are computed once a vocabulary (``reference``, each
function jitted once).  fp32 compute: ``forward_train``'s text logits, the
prefill's last logits and cache (the rows [0, P + S) it filled, P the
patches), one decode step at position P + S to ``repro``'s bound, 1e-4
(rtol and atol); greedy tokens equal; ``make_prefixed_lm_loss``'s loss to
1e-5 and its gradients to 1e-4 of each leaf's scale of ``jax.grad``'s.
Then the batches, the serve family, the CLIs (trained on (2, 1) data ranks,
resumed on one card).
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.models import pixtral as jP  # noqa: E402
from repro.train import serve_step as j_S  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import pixtral as P  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_prefix_inputs import (  # noqa: E402
    LOSS_TOL, TOL, close, leaf_scale_close, prefix_pair, prefix_rows, tokens)

ARCH = "pixtral-12b"
B, S_LEN, PREFILL = 2, 6, 5
VOCABS = ("dense", "qr")


@functools.lru_cache(maxsize=None)
def reference(vocab: str) -> dict:
    """``repro``'s results on the smoke config with ``vocab`` (fp32), and
    the port's params and inputs on the same values."""
    jcfg, tcfg, jp, tp = prefix_pair(ARCH, vocab)
    n = jcfg.num_patches
    patches = prefix_rows(B, n, jcfg.d_model)
    toks = tokens(jcfg.vocab, B, S_LEN)
    jpt, jt = jnp.asarray(patches), jnp.asarray(toks)
    max_len = n + 8
    pre, cache = jax.jit(jP.forward_prefill, static_argnames=("cfg", "max_len"))(
        jp, jpt, jt[:, :PREFILL], jcfg, max_len)
    dec, dcache = jax.jit(jP.forward_decode, static_argnames="cfg")(
        jp, jt[:, PREFILL:], cache, jnp.int32(n + PREFILL), jcfg)
    loss_fn = j_ts.make_prefixed_lm_loss(jP.forward_train, jcfg, "patches")
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jp, {"patches": jpt, "tokens": jt})
    greedy = j_S.greedy_generate(j_S.serve_family("pixtral"), jp,
                                 {"patches": jpt, "tokens": jt[:, :4]}, jcfg, max_new=4,
                                 max_len=8)
    return {"jcfg": jcfg, "tcfg": tcfg, "tp": tp, "patches": patches, "tokens": toks,
            "max_len": max_len,
            "train": jax.jit(jP.forward_train, static_argnames="cfg")(jp, jpt, jt, jcfg),
            "prefill": pre, "cache": cache, "decode": dec, "decoded_cache": dcache,
            "loss": loss, "grads": grads, "greedy": np.asarray(greedy)}


def port_inputs(ref: dict):
    return torch.from_numpy(ref["patches"]), torch.from_numpy(ref["tokens"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_forward_train_text_logits_match_repro(vocab):
    ref = reference(vocab)
    with torch.inference_mode():
        got = P.forward_train(ref["tp"], *port_inputs(ref), ref["tcfg"])
    assert got.shape == (B, S_LEN, ref["tcfg"].vocab)
    close(got, ref["train"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_prefill_matches_repro(vocab):
    """The last logits and the cache's rows [0, P + 5), the patches' and
    the prompt's; the rest zeros."""
    ref = reference(vocab)
    patches, toks = port_inputs(ref)
    filled = ref["tcfg"].num_patches + PREFILL
    with torch.inference_mode():
        lg, cache = P.forward_prefill(ref["tp"], patches, toks[:, :PREFILL], ref["tcfg"],
                                      ref["max_len"])
    close(lg, ref["prefill"])
    for key in ("k", "v"):
        assert cache[key].shape[2] == ref["max_len"]
        close(cache[key][:, :, :filled], np.asarray(ref["cache"][key])[:, :, :filled])
        assert not bool(cache[key][:, :, filled:].any())


@pytest.mark.parametrize("vocab", VOCABS)
def test_decode_matches_repro(vocab):
    """One step at position P + 5, counted from the start of the prefix:
    the logits and the row written in place."""
    ref = reference(vocab)
    patches, toks = port_inputs(ref)
    pos = ref["tcfg"].num_patches + PREFILL
    with torch.inference_mode():
        _, cache = P.forward_prefill(ref["tp"], patches, toks[:, :PREFILL], ref["tcfg"],
                                     ref["max_len"])
        lg, out = P.forward_decode(ref["tp"], toks[:, PREFILL:], cache, pos, ref["tcfg"])
    assert out is cache
    close(lg, ref["decode"])
    for key in ("k", "v"):
        close(out[key][:, :, :pos + 1], np.asarray(ref["decoded_cache"][key])[:, :, :pos + 1])


@pytest.mark.parametrize("vocab", VOCABS)
def test_greedy_tokens_equal_repro(vocab):
    """``greedy_generate`` decodes from position P + 4: the cache and the
    prefill take max_len + num_patches positions."""
    ref = reference(vocab)
    patches, toks = port_inputs(ref)
    got = S.greedy_generate(S.serve_family("pixtral"), ref["tp"],
                            {"patches": patches, "tokens": toks[:, :4]}, ref["tcfg"], max_new=4,
                            max_len=8)
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("vocab", VOCABS)
def test_prefixed_loss_and_gradients_match_repro(vocab):
    """``registry.train_loss_fn`` (``make_prefixed_lm_loss`` on the
    patches): the loss to 1e-5 and each leaf's gradient to 1e-4 of its
    scale, every layer recomputed in the backward."""
    ref = reference(vocab)
    patches, toks = port_inputs(ref)
    loss_fn = t_registry.train_loss_fn(t_registry.get(ARCH), ref["tcfg"])
    loss, metrics, grads = t_ts.value_and_grad(loss_fn, ref["tp"],
                                               {"patches": patches, "tokens": toks})
    assert metrics["loss"] == loss
    np.testing.assert_allclose(float(loss), float(ref["loss"]), rtol=LOSS_TOL)
    leaf_scale_close(grads, ref["grads"], TOL)


def test_decode_consistency():
    """``repro``'s test on the port (fp32): a prefill of the patches and 5
    tokens and one decode step at P + 5 give the train forward's text
    logits at positions 4 and 5."""
    ref = reference("dense")
    tp, tcfg = ref["tp"], ref["tcfg"]
    patches, toks = port_inputs(ref)
    with torch.inference_mode():
        full = P.forward_train(tp, patches, toks, tcfg)
        lg, cache = P.forward_prefill(tp, patches, toks[:, :PREFILL], tcfg, ref["max_len"])
        lg2, _ = P.forward_decode(tp, toks[:, PREFILL:], cache, tcfg.num_patches + PREFILL, tcfg)
    torch.testing.assert_close(lg[:, 0], full[:, PREFILL - 1], rtol=5e-5, atol=5e-5)
    torch.testing.assert_close(lg2[:, 0], full[:, PREFILL], rtol=TOL, atol=TOL)


def test_bf16_train_logits_near_repro_fp32():
    """bf16 compute: the text logits within 2e-2 of the scale of ``repro``'s
    fp32 logits (the transformer tests' cross-framework bound)."""
    ref = reference("qr")
    with torch.inference_mode():
        got = P.forward_train(ref["tp"], *port_inputs(ref),
                              ref["tcfg"].replace(compute_dtype="bfloat16"))
    want = np.asarray(ref["train"], np.float64)
    assert got.dtype == torch.bfloat16
    assert float(np.abs(got.double().numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())


def test_pixtral_batch_is_a_pure_function_of_seed_and_step():
    cfg = t_registry.get(ARCH).smoke
    make = t_registry.make_batch_fn(t_registry.get(ARCH), cfg)
    a = make(3, 5, seed=2, step=4)
    assert list(a) == ["patches", "tokens"]
    assert a["patches"].shape == (3, cfg.num_patches, cfg.d_model)
    assert a["patches"].dtype == torch.float32 and a["tokens"].dtype == torch.int32
    assert a["tokens"].shape == (3, 5) and int(a["tokens"].max()) < cfg.vocab
    b = synthetic.pixtral_batch(cfg, 3, 5, seed=2, step=4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = make(3, 5, seed=2, step=5)
    assert not torch.equal(a["patches"], c["patches"])


def test_serve_family_and_serving_params():
    """The registry's binding and the serve family: the cache covers the
    patches and ``max_len`` text positions; the weights cast once for
    serving give the same prefill, cache and decode bit for bit."""
    b = t_registry.get(ARCH)
    cfg = b.smoke.replace(embedding_kind="qr", qr_collision=8, compute_dtype="bfloat16")
    params, _ = t_registry.init_fn(b)(cfg, seed=0, device="cpu")
    assert "head" in params and set(params["embed"]) == {"q", "r"}
    fam = S.serve_family(b.kind)
    served = fam.prepare(params, cfg)
    assert served["head"]["w"].dtype == torch.bfloat16
    assert fam.make_cache(cfg, 2, 7, device="cpu")["k"].shape[2] == 7 + cfg.num_patches
    batch = t_registry.make_batch_fn(b, cfg)(2, 4, seed=0, step=0)
    with torch.inference_mode():
        a, ca = fam.prefill(served, batch, cfg, 7)
        c, cc = fam.prefill(params, batch, cfg, 7)
        assert a.shape == (2, 1, cfg.vocab) and torch.equal(a, c)
        assert ca["k"].shape[2] == 7 + cfg.num_patches
        assert all(torch.equal(ca[k], cc[k]) for k in ca)
        tok = torch.argmax(a[:, -1], -1)[:, None].to(torch.int32)
        pos = cfg.num_patches + 4
        a, _ = fam.decode(served, ca, tok, pos, cfg)
        c, _ = fam.decode(params, cc, tok, pos, cfg)
        assert torch.equal(a, c)


def test_remat_recomputes_each_layer_with_the_same_gradients():
    _, tcfg, _, tp = prefix_pair(ARCH, "qr")
    batch = {"patches": torch.from_numpy(prefix_rows(2, tcfg.num_patches, tcfg.d_model)),
             "tokens": torch.from_numpy(tokens(tcfg.vocab, 2, 6))}
    calls = []
    saved = P.T.ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return saved(*a, **kw)

    P.T.ckpt.checkpoint = counted
    try:
        grads = {}
        for remat in (True, False):
            loss_fn = t_registry.train_loss_fn(t_registry.get(ARCH), tcfg.replace(remat=remat))
            grads[remat] = t_ts.value_and_grad(loss_fn, tp, batch)[2]
        assert len(calls) == tcfg.num_layers
    finally:
        P.T.ckpt.checkpoint = saved
    for a, b in zip(tree.leaves(grads[True]), tree.leaves(grads[False])):
        assert torch.equal(a, b)


def test_serve_cli_runs_pixtral_on_the_cpu(capsys):
    assert t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--embedding", "qr",
                         "--batch", "2", "--prompt-len", "6", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 3) in" in out and "tok/s on cpu" in out


def test_train_cli_trains_pixtral_resumes_and_refuses_a_mesh(tmp_path, capfd):
    # the name predates the mesh (ROADMAP.md §1 item 11, now done): trained
    # on (2, 1) data ranks, resumed on one card
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4", "--seq", "8",
            "--embedding", "qr", "--ckpt-dir", str(tmp_path), "--log-every", "1",
            "--microbatches", "2"]
    assert t_train.main([*argv, "--steps", "2", "--mesh-shape", "2,1"]) == 0
    assert t_train.main([*argv, "--steps", "3"]) == 0
    out = capfd.readouterr().out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "[resume] step 2" in out
