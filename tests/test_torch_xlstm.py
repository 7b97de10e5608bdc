"""The port's xLSTM against ``repro.models.xlstm`` on the CPU: the cells
(``mlstm_chunked``, ``mlstm_step``, ``slstm_scan``) on numpy inputs, then
xlstm-125m-smoke with a dense and a QR (collision 8) vocabulary on
``repro``'s params carried over by ``convert.lm_params_from_numpy`` (its
``blocks`` list and its states included) and the same numpy tokens.

Bounds: the cells in fp32 to 1e-5; whole models as
``tests/torch_ssm_inputs.py`` says (fp32 to 5e-5, bf16 held to
``repro``'s fp32 by 2e-2 of scale or twice ``repro``'s own bf16 distance);
``repro``'s decode consistency at its 2e-4; greedy tokens equal; one
training step as ``tests/test_torch_lm_train_step.py``.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as j_registry  # noqa: E402
from repro.models import xlstm as jX  # noqa: E402
from repro.train import optimizer as j_opt  # noqa: E402
from repro.train import serve_step as j_S  # noqa: E402
from repro.train import train_step as j_ts  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry as t_registry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import xlstm as X  # noqa: E402
from repro_torch.train import optimizer as t_opt  # noqa: E402
from repro_torch.train import serve_step as S  # noqa: E402
from repro_torch.train import train_step as t_ts  # noqa: E402
from torch_ssm_inputs import (  # noqa: E402
    close_bf16, close_fp32, j_forward_xlstm, ssm_pair, tokens)

ARCH = "xlstm-125m"
CELL_TOL = 1e-5
OPT = dict(lr=1e-3, eps=1e-2, warmup_steps=1, total_steps=4)   # test_torch_lm_train_step's
j_mlstm_chunked = jax.jit(jX.mlstm_chunked, static_argnames=("chunk",))
j_slstm_scan = jax.jit(jX.slstm_scan)


def cell_close(got, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=CELL_TOL, atol=CELL_TOL)


def mlstm_inputs(b=2, h=2, s=16, d=8, seed=0):
    rng = np.random.default_rng(seed)
    out = {k: rng.normal(size=(b, h, s, d)).astype(np.float32) for k in ("q", "k", "v")}
    out["i"] = rng.normal(size=(b, h, s)).astype(np.float32)
    out["f"] = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    out["C"] = (0.1 * rng.normal(size=(b, h, d, d))).astype(np.float32)
    out["n"] = (0.1 * rng.normal(size=(b, h, d))).astype(np.float32)
    out["m"] = rng.normal(size=(b, h)).astype(np.float32)
    return out


@pytest.mark.parametrize("chunk,with_state", [(4, False), (16, False), (8, True)])
def test_mlstm_chunked_matches_repro(chunk, with_state):
    z = mlstm_inputs()
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    j = {k: jnp.asarray(v) for k, v in z.items()}
    jst = (j["C"], j["n"], j["m"]) if with_state else None
    tst = (t["C"], t["n"], t["m"]) if with_state else None
    want, (wC, wn, wm) = j_mlstm_chunked(j["q"], j["k"], j["v"], j["i"], j["f"], state=jst,
                                         chunk=chunk)
    got, (gC, gn, gm) = X.mlstm_chunked(t["q"], t["k"], t["v"], t["i"], t["f"], state=tst,
                                        chunk=chunk)
    for a, b in ((got, want), (gC, wC), (gn, wn), (gm, wm)):
        cell_close(a, b)


def test_mlstm_chunked_equals_the_step_stepped_and_c_is_k_by_v():
    """``mlstm_chunked`` from -inf equals ``mlstm_step`` stepped from the
    state ``init_xlstm_state`` makes (m at -1e30): the outputs and the final
    (C, n, m); C is laid out (d_k, d_v) in both; ``repro``'s step agrees."""
    z = mlstm_inputs(d=6)
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    h_par, (C, n, m) = X.mlstm_chunked(t["q"], t["k"], t["v"], t["i"], t["f"], chunk=4)
    st = (torch.zeros((2, 2, 6, 6)), torch.zeros((2, 2, 6)), torch.full((2, 2), -1e30))
    jst = tuple(jnp.asarray(x.numpy()) for x in st)
    outs = []
    for s in range(16):
        args = [t[k][:, :, s] for k in ("q", "k", "v", "i", "f")]
        h, st = X.mlstm_step(st, *args)
        jh, jst = jX.mlstm_step(jst, *(jnp.asarray(a.numpy()) for a in args))
        cell_close(h, jh)
        outs.append(h)
    torch.testing.assert_close(torch.stack(outs, dim=2), h_par, rtol=1e-4, atol=1e-5)
    for a, b in zip(st, (C, n, m)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    # one token from zero: C = exp(i - m) k ⊗ v, rows indexed by k's dims
    one = {k: v[:, :, :1] for k, v in t.items() if k in ("q", "k", "v", "i", "f")}
    _, (C1, _, m1) = X.mlstm_chunked(one["q"], one["k"], one["v"], one["i"], one["f"])
    outer = one["k"][:, :, 0, :, None] * one["v"][:, :, 0, None, :]
    torch.testing.assert_close(C1, torch.exp(one["i"][:, :, 0] - m1)[..., None, None] * outer)
    assert not torch.allclose(C1, C1.transpose(-1, -2))


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_repro(with_state):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 3, 4, 5)).astype(np.float32)
    r = (rng.normal(size=(3, 4, 5, 5)) / math.sqrt(5)).astype(np.float32)
    st = [rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 1.0                    # the normalizer is positive
    jst = tuple(jnp.asarray(a) for a in st) if with_state else None
    tst = tuple(torch.from_numpy(a) for a in st) if with_state else None
    want, wstate = j_slstm_scan(jnp.asarray(x), jnp.asarray(r), state=jst)
    got, gstate = X.slstm_scan(torch.from_numpy(x), torch.from_numpy(r), state=tst)
    cell_close(got, want)
    for a, b in zip(gstate, wstate):
        cell_close(a, b)


def test_slstm_backward_written_out_passes_gradcheck():
    """``_SLSTMScan``'s backward (the time loop written out in reverse)
    against ``torch.autograd.gradcheck``'s finite differences in fp64, from
    a random state, every input and the final state's outputs."""
    g = torch.Generator().manual_seed(7)
    s, h, b, d = 5, 2, 3, 3
    xg = torch.randn((s, h, b, 4 * d), generator=g, dtype=torch.float64)
    rw = torch.randn((h, d, 4 * d), generator=g, dtype=torch.float64) / 2
    st = [torch.randn((h, b, d), generator=g, dtype=torch.float64) for _ in range(4)]
    st[1] = st[1].abs() + 1.0                      # the normalizer is positive
    inputs = [t.requires_grad_(True) for t in (xg, rw, *st)]
    assert torch.autograd.gradcheck(lambda *a: X._SLSTMScan.apply(*a, False), inputs,
                                    fast_mode=True)


def test_slstm_scan_gradients_match_repro():
    """The scan's gradients (its inputs, weights and initial state) against
    ``jax.grad`` through ``repro``'s scan, fp32 to 1e-5 of each one's
    scale."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 9, 3, 4, 5)).astype(np.float32)
    r = (rng.normal(size=(3, 4, 5, 5)) / math.sqrt(5)).astype(np.float32)
    st = [rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 1.0
    w = rng.normal(size=(2, 9, 3, 5)).astype(np.float32)

    def jloss(x, r, st):
        hs, (c, n, hh, m) = jX.slstm_scan(x, r, state=st)
        return (hs * w).sum() + (c * n).sum() + m.sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(r),
                                              tuple(jnp.asarray(a) for a in st))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, r, *st)]
    hs, (c, n, hh, m) = X.slstm_scan(leaves[0], leaves[1], state=tuple(leaves[2:]))
    ((hs * torch.from_numpy(w)).sum() + (c * n).sum() + m.sum()).backward()
    for got, ref_ in zip(leaves, [want[0], want[1], *want[2]]):
        ref_ = np.asarray(ref_)
        assert float(np.abs(got.grad.numpy() - ref_).max()) <= 1e-5 * float(np.abs(ref_).max())


def run_repro(jp, toks, jcfg):
    train, _ = j_forward_xlstm(jp, jnp.asarray(toks), jcfg)
    st = jX.init_xlstm_state(jcfg, toks.shape[0])
    pre, st = j_forward_xlstm(jp, jnp.asarray(toks[:, :8]), jcfg, states=st)
    dec, st2 = j_forward_xlstm(jp, jnp.asarray(toks[:, 8:9]), jcfg, states=st, decode=True)
    return [("train", train), ("prefill", pre), ("states", st), ("decode", dec),
            ("decoded", st2)]


def run_port(tp, toks, tcfg):
    with torch.inference_mode():
        train, _ = X.forward_xlstm(tp, torch.from_numpy(toks), tcfg)
        st = X.init_xlstm_state(tcfg, toks.shape[0], device="cpu")
        pre, st = X.forward_xlstm(tp, torch.from_numpy(toks[:, :8]), tcfg, states=st)
        dec, st2 = X.forward_xlstm(tp, torch.from_numpy(toks[:, 8:9]), tcfg, states=st,
                                   decode=True)
    return [("train", train), ("prefill", pre), ("states", st), ("decode", dec),
            ("decoded", st2)]


def flat(entries):
    """(name, array) pairs with the states' leaves spread out."""
    out = []
    for name, v in entries:
        if isinstance(v, (list, tuple)):
            out += [(f"{name}/{i}/{j}", x) for i, s in enumerate(v) for j, x in enumerate(s)]
        else:
            out.append((name, v))
    return out


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab", ["dense", "qr"])
def test_forwards_match_repro(vocab, compute):
    """Train, a prefill from ``init_xlstm_state`` (logits and every state
    leaf) and one decode step against ``repro``."""
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, vocab, compute)
    toks = tokens(jcfg.vocab, 2, 9)
    got, want = flat(run_port(tp, toks, tcfg)), flat(run_repro(jp, toks, jcfg))
    assert [n for n, _ in got] == [n for n, _ in want]
    if compute == "float32":
        for (name, g), (_, w) in zip(got, want):
            close_fp32(g, w)
        return
    want32 = flat(run_repro(jp, toks, jcfg.replace(compute_dtype="float32")))
    for (name, g), (_, w), (_, w32) in zip(got, want, want32):
        close_bf16(g, w, w32)


def test_decode_consistency_and_both_initial_m():
    """``repro``'s test on the port (fp32): 9 decode steps from
    ``init_xlstm_state`` (m at -1e30) give the train forward's logits (m at
    -inf) within 2e-4; both are finite."""
    _, tcfg, _, tp = ssm_pair(ARCH, "dense", param_dtype="float32")
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 9))
    with torch.inference_mode():
        full, _ = X.forward_xlstm(tp, toks, tcfg)
        st = X.init_xlstm_state(tcfg, 2, device="cpu")
        assert all(bool((s[2] == -1e30).all()) for s in st if len(s) == 3)
        outs = []
        for t in range(9):
            lg, st = X.forward_xlstm(tp, toks[:, t:t + 1], tcfg, states=st, decode=True)
            outs.append(lg[:, 0])
    assert bool(torch.isfinite(full).all())
    torch.testing.assert_close(torch.stack(outs, dim=1), full, rtol=2e-4, atol=2e-4)


def j_prefill(fam, jp, prompt, jcfg, max_len: int = 13):
    """``repro``'s family prefill, jitted as ``greedy_generate`` jits it
    (eagerly, op by op, it takes twice the jitted call's compile)."""
    return jax.jit(lambda p, t: fam.prefill(p, {"tokens": t}, jcfg, max_len))(jp, prompt)


@pytest.mark.parametrize("vocab", ["dense", "qr"])
def test_greedy_tokens_equal_repro(vocab):
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, vocab)
    prompt = tokens(jcfg.vocab, 2, 8, seed=3)
    want = j_S.greedy_generate(j_S.serve_family("xlstm"), jp, {"tokens": jnp.asarray(prompt)},
                               jcfg, max_new=5, max_len=13)
    fam = S.serve_family("xlstm")
    got = S.greedy_generate(fam, tp, {"tokens": torch.from_numpy(prompt)}, tcfg, max_new=5,
                            max_len=13)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jlg, _ = j_prefill(j_S.serve_family("xlstm"), jp, jnp.asarray(prompt), jcfg)
    with torch.inference_mode():
        tlg, _ = fam.prefill(tp, {"tokens": torch.from_numpy(prompt)}, tcfg, 13)
    assert tlg.shape == (2, 1, tcfg.vocab)
    close_fp32(tlg, jlg)


def test_init_tree_and_states_match_repro():
    """``blocks`` a list of heterogeneous dicts (sLSTM at
    ``is_slstm_layer``), ``repro``'s keys, shapes, dtypes, logical axes and
    constants; the states' shapes and initial values."""
    jcfg, tcfg = j_registry.get(ARCH).smoke, t_registry.get(ARCH).smoke
    jp, jaxes = jX.init_xlstm(jax.random.PRNGKey(0), jcfg)
    tp, taxes = X.init_xlstm(tcfg, seed=0, device="cpu")
    assert taxes == jaxes and isinstance(tp["blocks"], list)
    assert [X.is_slstm_layer(tcfg, i) for i in range(4)] == [
        jX.is_slstm_layer(jcfg, i) for i in range(4)] == [False, True, False, True]
    jl = dict(zip([p for p, _ in tree.leaves_with_paths(jp)], jax.tree.leaves(jp)))
    tl = dict(tree.leaves_with_paths(tp))
    assert set(tl) == set(jl)
    for path, leaf in tl.items():
        assert tuple(leaf.shape) == jl[path].shape, path
        assert str(leaf.dtype).replace("torch.", "") == jl[path].dtype.name, path
        if path.endswith(("gate_bias", "f_bias", "out_norm", "scale")):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jl[path]), err_msg=path)
    js, ts = jX.init_xlstm_state(jcfg, 3), X.init_xlstm_state(tcfg, 3, device="cpu")
    for a, b in zip(tree.leaves(ts), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_convert_carries_the_blocks_list_and_the_states():
    """``lm_params_from_numpy`` keeps ``blocks`` a list and a state list's
    tuples as tuples; a decode step from ``repro``'s states carried over
    gives ``repro``'s logits."""
    jcfg, tcfg, jp, tp = ssm_pair(ARCH, "qr")
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == tcfg.num_layers
    np.testing.assert_array_equal(tp["blocks"][1]["r_gates"].numpy(),
                                  np.asarray(jp["blocks"][1]["r_gates"]))
    toks = tokens(jcfg.vocab, 2, 9)
    st = jX.init_xlstm_state(jcfg, 2)
    _, st = j_forward_xlstm(jp, jnp.asarray(toks[:, :8]), jcfg, states=st)
    tst = lm_params_from_numpy(jax.tree.map(np.asarray, st), "cpu")
    assert isinstance(tst, list) and all(isinstance(s, tuple) for s in tst)
    want, _ = j_forward_xlstm(jp, jnp.asarray(toks[:, 8:]), jcfg, states=st, decode=True)
    with torch.inference_mode():
        got, _ = X.forward_xlstm(tp, torch.from_numpy(toks[:, 8:]), tcfg, states=tst,
                                 decode=True)
    close_fp32(got, want)


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
    jnew, jm, tnew, tm = one_step(vocab, "float32")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tl, jl = list(tree.leaves_with_paths(tnew)), jax.tree.leaves(jnew)
    assert len(tl) == len(jl)
    for (path, t), j in zip(tl, jl):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-4, atol=2e-5,
                                   err_msg=path)


def test_train_step_matches_repro_bf16():
    jnew, jm, tnew, tm = one_step("dense", "bfloat16")
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= 2e-2 * abs(float(jm[key])), key
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(tnew))


def test_serving_params_give_the_same_logits_bitwise():
    _, tcfg, _, tp = ssm_pair(ARCH, "qr", "bfloat16")
    served = X.serving_params(tp, tcfg)
    assert served["blocks"][0]["wq"].dtype == torch.bfloat16
    assert served["blocks"][1]["r_gates"].dtype == torch.float32
    toks = torch.from_numpy(tokens(tcfg.vocab, 2, 10))
    fam = S.serve_family("xlstm")
    with torch.inference_mode():
        assert torch.equal(X.forward_xlstm(served, toks, tcfg)[0],
                           X.forward_xlstm(tp, toks, tcfg)[0])
        a, sa = fam.prefill(served, {"tokens": toks[:, :9]}, tcfg, 12)
        b, sb = fam.prefill(tp, {"tokens": toks[:, :9]}, tcfg, 12)
        assert torch.equal(a, b)
        a, _ = fam.decode(served, sa, toks[:, 9:], 9, tcfg)
        b, _ = fam.decode(tp, sb, toks[:, 9:], 9, tcfg)
        assert torch.equal(a, b)


def test_serve_cli_and_the_example_default_to_xlstm_on_the_cpu(capsys):
    assert t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "16", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "generated (2, 4) in" in out and "tok/s on cpu" in out
    serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--max-new", "4"])
    out = capsys.readouterr().out
    assert out.startswith("xlstm-125m (qr embedding): generated (2, 4)")
    assert "steady-state decode" in out


def test_train_cli_trains_xlstm_and_refuses_a_mesh(tmp_path, capfd):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--log-every", "1"]
    assert t_train.main([*argv, "--steps", "2"]) == 0
    assert t_train.main([*argv, "--steps", "3"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 2" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["1", "2", "3"]
    # a mesh takes the run on from one card's checkpoint, one card from the mesh's
    assert t_train.main([*argv, "--steps", "4", "--mesh-shape", "1,2"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 3" in out and "done" in out
    losses = [float(x.split()[3]) for x in out.splitlines() if x.startswith("step")]
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert t_train.main([*argv, "--steps", "5"]) == 0
    out = capfd.readouterr().out
    assert "[resume] step 4" in out
    assert [x.split()[1] for x in out.splitlines() if x.startswith("step")] == ["5"]
