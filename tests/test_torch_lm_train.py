"""The port's LM training (``train_step.next_token_loss``, ``make_lm_loss``,
``make_prefixed_lm_loss``, ``registry.train_loss_fn``, per-layer recompute
in ``transformer.forward_train``) against ``repro`` on the CPU.

``repro``'s params are carried over by ``convert.lm_params_from_numpy``;
tokens and logits are numpy arrays from a seed, handed to both packages.
One train step against ``repro``'s jitted step is in
``tests/test_torch_lm_train_step.py``.  Tolerances:

* ``next_token_loss``: the value within 1e-6 relative of ``repro``'s in
  fp32 (each row's logsumexp is the same fp32 reduction; the mean sums in
  another order), its gradient within 1e-6 of scale (fp32 logits) and one
  bf16 rounding (bf16 logits: both round the same fp32 gradient once);
* microbatches 1 against 4: ``repro``'s own tolerances
  (``tests/test_train.py::test_microbatch_equivalence``);
* remat off / ``full`` / ``dots`` and ``unbind`` against the ``[i]`` views:
  bitwise, on the dense, hashed and QR vocabularies.  The TT vocabulary is
  left out there: on the CPU its cores' gradient (batched products of small
  matrices) changes in the last bit from one call to the next with nothing
  changed, remat or not.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as t_T  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_lm_inputs import lm_pair, tokens  # noqa: E402


# ---------------------------------------------------------------------------
# next_token_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 4 * 5 * 2])
def test_next_token_loss_is_log_vocab_on_zero_logits(chunk, monkeypatch):
    if chunk:
        monkeypatch.setattr(t_ts, "LOSS_CHUNK_BYTES", chunk)     # rows of 2
    toks = torch.tensor([[1, 2, 3, 4, 0], [4, 4, 1, 0, 2]], dtype=torch.int32)
    loss = t_ts.next_token_loss(torch.zeros((2, 5, 5)), toks)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), np.log(5.0), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [None, 4 * 97 * 3])
def test_next_token_loss_matches_repro(dtype, chunk, monkeypatch):
    """Value and gradient against ``repro``'s on random logits, in one chunk
    and in chunks of 3 rows (B 3, S 9, V 97)."""
    if chunk:
        monkeypatch.setattr(t_ts, "LOSS_CHUNK_BYTES", chunk)
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 9, 97))).astype(np.float32)
    toks = tokens(97, 3, 9)
    jl = jnp.asarray(logits, dtype)
    want, jgrad = jax.value_and_grad(j_ts.next_token_loss)(jl, jnp.asarray(toks))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_(True)
    got = t_ts.next_token_loss(tl, torch.from_numpy(toks))
    (tgrad,) = torch.autograd.grad(got, tl)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    assert tgrad.dtype == tl.dtype and not bool(tgrad[:, -1].any())
    g = tgrad.float().numpy()
    w = np.asarray(jgrad.astype(jnp.float32))
    if dtype == "float32":
        assert float(np.abs(g - w).max()) <= 1e-6 * float(np.abs(w).max())
    else:
        assert np.all(np.abs(g - w) <= 2.0 ** -8 * np.abs(w) + 1e-12)


def test_prefixed_lm_loss_with_a_stub_forward():
    """``make_prefixed_lm_loss`` hands the prefix, the tokens and the config
    to the forward and scores its logits: a stub forward (embedding plus the
    prefix's mean, then a head), written in each package, gives the same
    loss and gradients."""
    rng = np.random.default_rng(3)
    e, w = rng.standard_normal((31, 8)), rng.standard_normal((8, 31))
    prefix = rng.standard_normal((2, 5, 8)).astype(np.float32)
    toks = tokens(31, 2, 7)

    def j_fwd(p, pre, tk, cfg):
        return (p["e"][tk] + pre.mean(axis=1)[:, None]) @ p["w"] * cfg

    def t_fwd(p, pre, tk, cfg):
        return (p["e"][tk.long()] + pre.mean(dim=1)[:, None]) @ p["w"] * cfg

    jp = {"e": jnp.asarray(e, jnp.float32), "w": jnp.asarray(w, jnp.float32)}
    tp = {"e": torch.tensor(e, dtype=torch.float32), "w": torch.tensor(w, dtype=torch.float32)}
    (jl, jm), jg = jax.value_and_grad(j_ts.make_prefixed_lm_loss(j_fwd, 0.5, "frames"),
                                      has_aux=True)(
        jp, {"frames": jnp.asarray(prefix), "tokens": jnp.asarray(toks)})
    tl, tm, tg = t_ts.value_and_grad(t_ts.make_prefixed_lm_loss(t_fwd, 0.5, "frames"), tp,
                                     {"frames": torch.from_numpy(prefix),
                                      "tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tm["loss"]) == float(tl)
    for k in ("e", "w"):
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-5, atol=1e-6)


def test_microbatches_one_and_four_give_the_same_update():
    """``repro``'s ``test_microbatch_equivalence`` on the port: the in-place
    fp32 accumulation over four slices against one pass."""
    _, tcfg, _, tp = lm_pair("qwen2-1.5b", "dense", remat=False)
    loss_fn = t_registry.train_loss_fn(t_registry.get("qwen2-1.5b"), tcfg)
    batch = t_registry.make_batch_fn(t_registry.get("qwen2-1.5b"), tcfg)(8, 16, seed=0, step=0)
    ocfg = t_opt.OptConfig(warmup_steps=0, schedule="constant")
    p1, _, m1 = t_ts.make_train_step(loss_fn, ocfg, microbatches=1)(tp, t_opt.init(tp), batch)
    p4, _, m4 = t_ts.make_train_step(loss_fn, ocfg, microbatches=4)(tp, t_opt.init(tp), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]), rtol=1e-5)
    for a, b in zip(tree.leaves(p1), tree.leaves(p4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# per-layer recompute and the stacked leaves
# ---------------------------------------------------------------------------

def grads_of(params, tcfg, toks, forward=None):
    fwd = forward or t_T.forward_train
    loss, _, g = t_ts.value_and_grad(t_ts.make_lm_loss(fwd, tcfg), params, {"tokens": toks})
    return loss, tree.leaves(g)


@pytest.mark.parametrize("vocab", ["dense", "hashed", "qr"])
def test_remat_policies_give_bitwise_equal_gradients(vocab):
    _, tcfg, _, tp = lm_pair("qwen2-1.5b", vocab)
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 12))
    want_loss, want = grads_of(tp, tcfg.replace(remat=False), toks)
    for policy in ("full", "dots"):
        loss, got = grads_of(tp, tcfg.replace(remat=True, remat_policy=policy), toks)
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(got, want)), policy
    with pytest.raises(ValueError, match="remat_policy"):
        grads_of(tp, tcfg.replace(remat_policy="offload"), toks)


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat the backward runs every layer's forward again (``full``);
    without it, and under ``inference_mode``, each layer runs once."""
    _, tcfg, _, tp = lm_pair("chatglm3-6b", "dense")
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 8))
    calls = []
    inner = t_T.layer_fwd
    monkeypatch.setattr(t_T, "layer_fwd", lambda *a, **k: calls.append(1) or inner(*a, **k))
    for remat, want in ((False, 1), (True, 2)):
        calls.clear()
        grads_of(tp, tcfg.replace(remat=remat), toks)
        assert len(calls) == want * tcfg.num_layers, remat
    calls.clear()
    with torch.inference_mode():
        t_T.forward_train(tp, toks, tcfg)
    assert len(calls) == tcfg.num_layers


def test_unbind_gives_the_views_values_and_gradients():
    """``layer_list`` holds bitwise the ``[i]`` views of the stacked leaves,
    and the gradients through it equal those through the views."""
    _, tcfg, _, tp = lm_pair("minitron-4b", "qr", remat=False)
    for i, layer in enumerate(t_T.layer_list(tp)):
        views = tree.tree_map(lambda a: a[i], tp["layers"])
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(layer), tree.leaves(views)))

    def by_views(params, toks, cfg):
        x = t_T.embed_tokens(params, toks, cfg).to(cfg.cdtype)
        for i in range(cfg.num_layers):
            x, _ = t_T.layer_fwd(tree.tree_map(lambda a: a[i], params["layers"]), x, cfg)
        return t_T.lm_logits(params, t_T.L.apply_norm(params["final_norm"], x), cfg)

    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 10))
    loss_a, a = grads_of(tp, tcfg, toks)
    loss_b, b = grads_of(tp, tcfg, toks, by_views)
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_tiny_lm_overfits_one_batch():
    """``repro``'s ``test_loss_decreases_tiny_lm``: 12 steps on one batch of
    qwen2-1.5b-smoke (bf16 compute, remat on) lower the loss by > 0.5."""
    binding = t_registry.get("qwen2-1.5b")
    cfg = binding.smoke
    params, _ = t_registry.init_fn(binding)(cfg, seed=0, device="cpu")
    step = t_ts.make_train_step(t_registry.train_loss_fn(binding, cfg),
                                t_opt.OptConfig(lr=1e-3, warmup_steps=2))
    opt = t_opt.init(params)
    batch = t_registry.make_batch_fn(binding, cfg)(8, 32, seed=0, step=0)
    losses = []
    for _ in range(12):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses
