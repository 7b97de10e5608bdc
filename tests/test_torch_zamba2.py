"""The port's zamba2 hybrid against ``repro.models.zamba2`` on the CPU:
zamba2-7b-smoke with a dense and a QR (collision 8) vocabulary, on
``repro``'s params carried over by ``convert.lm_params_from_numpy`` and the
same numpy tokens; then the serve family, the CLIs and the converted cache.

Bounds (``tests/torch_ssm_inputs.py``): fp32 logits and cache entries to
5e-5, bf16 held to ``repro``'s fp32 by 2e-2 of scale or twice ``repro``'s
own bf16 distance; ``repro``'s decode consistency at its 1e-4; greedy
tokens equal;
one training step as ``tests/test_torch_lm_train_step.py`` (the loss to
1e-5, the updated params to rtol 2e-4 / atol 2e-5).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import zamba2 as jZ  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import serve_step as j_S  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import checkpointer as t_ckpt  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import zamba2 as Z  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_ssm_inputs import (  # noqa: E402
    close_bf16, close_fp32, j_forward_zamba2, ssm_pair, tokens)

ARCH = "zamba2-7b"
OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)   # test_torch_lm_train_step's
CACHE_KEYS = ("ssm", "conv", "k", "v")


def run_repro(jp, toks, jcfg):
    """repro's train logits, prefill (all rows) and its cache, one decode
    step and its cache: 11 tokens prefilled into a cache of 16."""
    train, _ = j_forward_zamba2(jp, jnp.asarray(toks), jcfg)
    cache = jZ.init_zamba2_cache(jcfg, toks.shape[0], 16)
    pre, cache = j_forward_zamba2(jp, jnp.asarray(toks[:, :11]), jcfg, cache=cache,
                                  pos=jnp.int32(0), decode=False)
    dec, cache2 = j_forward_zamba2(jp, jnp.asarray(toks[:, 11:12]), jcfg, cache=cache,
                                   pos=jnp.int32(11), decode=True)
    return [("train", train), ("prefill", pre), *((f"cache_{k}", cache[k]) for k in CACHE_KEYS),
            ("decode", dec), *((f"decoded_{k}", cache2[k]) for k in CACHE_KEYS)]


def run_port(tp, toks, tcfg):
    with torch.inference_mode():
        train, none = Z.forward_zamba2(tp, torch.from_numpy(toks), tcfg)
        assert none is None
        cache = Z.init_zamba2_cache(tcfg, toks.shape[0], 16, device="cpu")
        pre, out = Z.forward_zamba2(tp, torch.from_numpy(toks[:, :11]), tcfg, cache=cache, pos=0)
        assert out is cache
        filled = {k: v.clone() for k, v in cache.items()}
        dec, out = Z.forward_zamba2(tp, torch.from_numpy(toks[:, 11:12]), tcfg, cache=cache,
                                    pos=11, decode=True)
        assert out is cache
    return [("train", train), ("prefill", pre), *((f"cache_{k}", filled[k]) for k in CACHE_KEYS),
            ("decode", dec), *((f"decoded_{k}", cache[k]) for k in CACHE_KEYS)]


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", ["dense", "qr"])
def test_forwards_match_repro(vocab, compute):
    """Train, prefill (logits and every cache entry, value for value) and
    decode against ``repro``."""
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, vocab, compute)
    toks = tokens(jcfg.vocab, 2, 12)
    got = run_port(tp, toks, tcfg)
    want = run_repro(jp, toks, jcfg)
    if compute == "float32":
        for (name, g), (_, w) in zip(got, want):
            close_fp32(g, w)
        return
    want32 = run_repro(jp, toks, jcfg.replace(compute_dtype="float32"))
    for (name, g), (_, w), (_, w32) in zip(got, want, want32):
        assert g.dtype == torch.bfloat16, name
        close_bf16(g, w, w32)


def test_decode_consistency():
    """``repro``'s test on the port (fp32): a prefill of 7 tokens and one
    decode step give the train forward's logits at position 7 (1e-4)."""
    _, tcfg, _, tp = ssm_pair(ARCH, "dense", param_dtype="float32")
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 8))
    with torch.inference_mode():
        full, _ = Z.forward_zamba2(tp, toks, tcfg)
        cache = Z.init_zamba2_cache(tcfg, 2, 12, dtype=torch.float32, device="cpu")
        _, cache = Z.forward_zamba2(tp, toks[:, :7], tcfg, cache=cache, pos=0)
        lg2, _ = Z.forward_zamba2(tp, toks[:, 7:8], tcfg, cache=cache, pos=7, decode=True)
    torch.testing.assert_close(lg2[:, 0], full[:, 7], rtol=1e-4, atol=1e-4)


def j_prefill(fam, jp, prompt, jcfg, max_len: int = 13):
    """``repro``'s family prefill, jitted as ``greedy_generate`` jits it
    (eagerly, op by op, it takes twice the jitted call's compile)."""
    return jax.jit(lambda p, t: fam.prefill(p, {"tokens": t}, jcfg, max_len))(jp, prompt)


@pytest.mark.parametrize("vocab", ["dense", "qr"])
def test_greedy_tokens_equal_repro(vocab):
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, vocab)
    prompt = tokens(jcfg.vocab, 2, 8, seed=3)
    want = j_S.greedy_generate(j_S.serve_family("zamba2"), jp, {"tokens": jnp.asarray(prompt)},
                               jcfg, max_new=5, max_len=13)
    fam = S.serve_family("zamba2")
    got = S.greedy_generate(fam, tp, {"tokens": torch.from_numpy(prompt)}, tcfg, max_new=5,
                            max_len=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the family's prefill: repro's last-row logits, the head on that row alone
    jlg, _ = j_prefill(j_S.serve_family("zamba2"), jp, jnp.asarray(prompt), jcfg)
    with torch.inference_mode():
        tlg, cache = fam.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tcfg, 13)
    close_fp32(tlg, jlg)
    assert tlg.shape == (2, 1, tcfg.vocab) and cache["k"].shape[2] == 13


@pytest.mark.parametrize("layers,every", [(81, 6), (4, 2), (5, 2), (6, 6), (48, 6), (7, 3)])
def test_segment_bounds_match_repro(layers, every):
    tcfg = t_registry.get(ARCH).config.replace(num_layers=layers, attn_every=every)
    jcfg = j_registry.get(ARCH).config.replace(num_layers=layers, attn_every=every)
    assert Z._segment_bounds(tcfg) == jZ._segment_bounds(jcfg)
    assert Z.num_attn_sites(tcfg) == jZ.num_attn_sites(jcfg)
    if layers == 81:
        assert Z.num_attn_sites(tcfg) == 13 and Z._segment_bounds(tcfg)[-1] == (78, 81, False)


def test_init_tree_matches_repro():
    """``repro``'s keys, shapes, dtypes and logical axes, the mamba leaves
    stacked along a leading layer dim; the cache's shapes and axes too."""
    jcfg, tcfg = j_registry.get(ARCH).smoke, t_registry.get(ARCH).smoke
    jp, jaxes = jZ.init_zamba2(jax.random.PRNGKey(0), jcfg)
    tp, taxes = Z.init_zamba2(tcfg, seed=0, device="cpu")
    assert taxes == jaxes
    jl = dict(zip([p for p, _ in tree.leaves_with_paths(jp)], jax.tree.leaves(jp)))
    tl = dict(tree.leaves_with_paths(tp))
    assert set(tl) == set(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == jl[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == jl[path].dtype.name, path
    assert tl["mamba/in_proj"].shape[0] == tcfg.num_layers
    jc = jZ.init_zamba2_cache(jcfg, 2, 9)
    tc = Z.init_zamba2_cache(tcfg, 2, 9, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in jc.items()}
    assert Z.zamba2_cache_axes() == jZ.zamba2_cache_axes()


def one_step(vocab, compute):
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, vocab, compute)
    toks = tokens(jcfg.vocab, 4, 16)
    jstep = jax.jit(j_ts.make_train_step(
        j_registry.train_loss_fn(j_registry.get(ARCH), jcfg), j_opt.OptConfig(**OPT),
        microbatches=2))
    tstep = t_ts.make_train_step(t_registry.train_loss_fn(t_registry.get(ARCH), tcfg),
                                 t_opt.OptConfig(**OPT), microbatches=2)
    jnew, _, jm = jstep(jp, j_opt.init(jp), {"tokens": jnp.asarray(toks)})
    tnew, _, tm = tstep(tp, t_opt.init(tp), {"tokens": torch.from_numpy(toks)})
    return jnew, jm, tnew, tm


@pytest.mark.parametrize("vocab", ["dense", "qr"])
def test_train_step_matches_repro_fp32(vocab):
    """One step of 2 microbatches with each mamba layer recomputed in the
    backward (``remat``), against ``repro``'s jitted step."""
    jnew, jm, tnew, tm = one_step(vocab, "float32")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tl, jl = list(tree.leaves_with_paths(tnew)), jax.tree.leaves(jnew)
    assert len(tl) == len(jl)
    for (path, t), j in zip(tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5,
                                   err_msg=path)


def test_train_step_matches_repro_bf16():
    jnew, jm, tnew, tm = one_step("qr", "bfloat16")
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-2 * abs(float(jm[key])), key
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(tnew))


def test_remat_recomputes_each_mamba_layer_with_the_same_gradients():
    """``cfg.remat`` under grad checkpoints each mamba layer: the gradients
    equal those without it, bitwise, and no checkpoint runs without grad."""
    _, tcfg, _, tp = ssm_pair(ARCH, "qr")
    toks = {"tokens": torch.from_numpy(tokens(tcfg.vocab, 2, 8))}
    calls = []
    saved = Z.ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return saved(*a, **kw)

    Z.ckpt.checkpoint = counted
    try:
        grads = {}
        for remat in (True, False):
            c = tcfg.replace(remat=remat)
            loss_fn = t_registry.train_loss_fn(t_registry.get(ARCH), c)
            grads[remat] = t_ts.value_and_grad(loss_fn, tp, toks)[2]
        assert len(calls) == tcfg.num_layers
        with torch.no_grad():
            Z.forward_zamba2(tp, toks["tokens"], tcfg)
        assert len(calls) == tcfg.num_layers
    finally:
        Z.ckpt.checkpoint = saved
    for a, b in zip(tree.leaves(grads[True]), tree.leaves(grads[False])):
        assert torch.equal(a, b)


def test_serving_params_give_the_same_logits_bitwise():
    _, tcfg, _, tp = ssm_pair(ARCH, "qr", "bfloat16")
    served = Z.serving_params(tp, tcfg)
    m = served["mamba"]
    assert {k: m[k].dtype for k in ("in_proj", "conv_w", "D", "A_log", "dt_bias")} == {
        "in_proj": torch.bfloat16, "conv_w": torch.bfloat16, "D": torch.bfloat16,
        "A_log": torch.float32, "dt_bias": torch.float32}
    assert served["shared_attn"]["wq"]["w"].dtype == torch.bfloat16
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 10))
    fam = S.serve_family("zamba2")
    with torch.inference_mode():
        assert torch.equal(Z.forward_zamba2(served, toks, tcfg)[0],
                           Z.forward_zamba2(tp, toks, tcfg)[0])
        a, ca = fam.prefill(served, {"tokens": toks[:, :9]}, tcfg, 12)
        b, cb = fam.prefill(tp, {"tokens": toks[:, :9]}, tcfg, 12)
        assert torch.equal(a, b) and all(torch.equal(ca[k], cb[k]) for k in CACHE_KEYS)
        a, _ = fam.decode(served, ca, toks[:, 9:], 9, tcfg)
        b, _ = fam.decode(tp, cb, toks[:, 9:], 9, tcfg)
        assert torch.equal(a, b)


def test_convert_carries_a_zamba2_cache():
    """A ``repro`` cache (a dict of stacked leaves) carried by
    ``lm_params_from_numpy`` decodes as ``repro`` decodes from it."""
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, "dense")
    toks = tokens(jcfg.vocab, 2, 9)
    cache = jZ.init_zamba2_cache(jcfg, 2, 12)
    _, cache = j_forward_zamba2(jp, jnp.asarray(toks[:, :8]), jcfg, cache=cache,
                                pos=jnp.int32(0), decode=False)
    tc = lm_params_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
    assert set(tc) == set(CACHE_KEYS)
    for k in CACHE_KEYS:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(cache[k]))
    want, _ = j_forward_zamba2(jp, jnp.asarray(toks[:, 8:]), jcfg, cache=cache,
                               pos=jnp.int32(8), decode=True)
    with torch.inference_mode():
        got, _ = Z.forward_zamba2(tp, torch.from_numpy(toks[:, 8:]), tcfg, cache=tc, pos=8,
                                  decode=True)
    close_fp32(got, want)


def test_serve_cli_runs_zamba2_on_the_cpu(capsys):
    assert t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--embedding", "qr",
                         "--batch", "2", "--prompt-len", "16", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out and "tok/s on cpu" in out


def test_train_cli_trains_zamba2_checkpoints_resumes_and_refuses_a_mesh(tmp_path, capfd):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--embedding", "qr", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
            "--log-every", "1"]
    assert t_train.main([*argv, "--steps", "2"]) == 0
    out = capfd.readouterr().out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and "done" in out
    assert t_ckpt.latest_step(str(tmp_path)) == 2
    assert t_train.main([*argv, "--steps", "3"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 2" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["3"]
    # a mesh takes the run on from one card's checkpoint, one card from the mesh's
    assert t_train.main([*argv, "--steps", "4", "--mesh-shape", "1,2"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 3" in out and "done" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["4"]
    assert t_ckpt.latest_step(str(tmp_path)) == 4
    assert t_train.main([*argv, "--steps", "5"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 4" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["5"]
