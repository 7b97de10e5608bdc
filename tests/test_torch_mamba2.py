"""The port's Mamba2 (SSD) block against ``repro.models.mamba2`` on the CPU:
the same numpy inputs and ``repro``'s params carried over.

Bounds: fp32 to 1e-5 (rtol and atol), bf16 to 2e-2 of the output's scale;
``repro``'s chunked-vs-step test at its own bounds (rtol 1e-4, atol 1e-5).
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import mamba2 as jM  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402

# repro's functions jitted whole: one compile each, not one an operation
j_mamba2_fwd = jax.jit(jM.mamba2_fwd, static_argnames=("cfg", "decode"))
j_ssd_chunked = jax.jit(jM.ssd_chunked, static_argnames=("chunk",))

FP32_TOL = 1e-5
BF16_SCALE = 2e-2
DTYPES = ("float32", "bfloat16")
# one layer at a small width: 2 groups of 4 heads of P 8, state 8
CFG = dict(name="m", family="ssm", num_layers=1, d_model=32, num_heads=2, kv_heads=2,
           d_ff=0, vocab=64, ssm_state=8, ssm_head_dim=8, ssm_groups=2)


def cfgs(compute: str = "float32"):
    return (JConfig(**CFG, compute_dtype=compute), TConfig(**CFG, compute_dtype=compute))


def close(got, want, compute: str) -> None:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape
    if compute == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        assert float(np.abs(got - want).max()) <= BF16_SCALE * float(np.abs(want).max())


def pair(a: np.ndarray, compute: str):
    """``a`` in ``compute`` for both packages (bf16 rounded once, by jax)."""
    j = jnp.asarray(a, jnp.dtype(compute))
    t = torch.from_numpy(np.asarray(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, compute))


def ssd_inputs(b=2, s=16, h=4, p=8, g=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(b, s, h, p)).astype(np.float32),
            "a": -rng.uniform(0.05, 1.5, size=(b, s, h)).astype(np.float32),
            "b": rng.normal(size=(b, s, g, n)).astype(np.float32),
            "c": rng.normal(size=(b, s, g, n)).astype(np.float32),
            "state": rng.normal(size=(b, h, p, n)).astype(np.float32)}


def layer_params():
    jcfg, _ = cfgs()
    jp, _ = jM.init_mamba2(jax.random.PRNGKey(4), jcfg)
    jp = {**jp, "dt_bias": jnp.linspace(-1.0, 1.0, jp["dt_bias"].shape[0]),
          "conv_b": jnp.full(jp["conv_b"].shape, 0.1), "D": jnp.linspace(0.5, 1.5, 8)}
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("compute", DTYPES)
def test_segsum_matches_repro(compute):
    a = -np.random.default_rng(1).uniform(0.1, 2.0, size=(3, 2, 16)).astype(np.float32)
    ja, ta = pair(a, compute)
    want, got = jM._segsum(ja), M._segsum(ta)
    assert got.dtype == getattr(torch, compute)
    np.testing.assert_array_equal(np.isinf(np.asarray(want, np.float32)),
                                  torch.isinf(got.float()).numpy())
    fin = ~np.isinf(np.asarray(want, np.float32))
    close(got.masked_fill(~torch.from_numpy(fin), 0), jnp.where(fin, want, 0), compute)


@pytest.mark.parametrize("compute", DTYPES)
@pytest.mark.parametrize("chunk,init", [(8, False), (8, True), (16, True), (4, False)])
def test_ssd_chunked_matches_repro(chunk, init, compute):
    z = ssd_inputs()
    j = {k: pair(v, compute)[0] for k, v in z.items()}
    t = {k: pair(v, compute)[1] for k, v in z.items()}
    jy, jst = j_ssd_chunked(j["x"], j["a"], j["b"], j["c"], chunk=chunk,
                             initial_state=j["state"] if init else None)
    ty, tst = M.ssd_chunked(t["x"], t["a"], t["b"], t["c"], chunk=chunk,
                            initial_state=t["state"] if init else None)
    assert ty.dtype == tst.dtype == getattr(torch, compute)
    close(ty, jy, compute)
    close(tst, jst, compute)


@pytest.mark.parametrize("compute", DTYPES)
def test_ssd_step_matches_repro(compute):
    z = ssd_inputs(s=1)
    j = {k: pair(v, compute)[0] for k, v in z.items()}
    t = {k: pair(v, compute)[1] for k, v in z.items()}
    jy, jst = jM.ssd_step(j["state"], j["x"][:, 0], j["a"][:, 0], j["b"][:, 0], j["c"][:, 0])
    ty, tst = M.ssd_step(t["state"], t["x"][:, 0], t["a"][:, 0], t["b"][:, 0], t["c"][:, 0])
    close(ty, jy, compute)
    close(tst, jst, compute)


@pytest.mark.parametrize("compute", DTYPES)
def test_gated_norm_matches_repro(compute):
    rng = np.random.default_rng(2)
    (jy, ty), (jz, tz) = (pair(rng.normal(size=(2, 5, 64)).astype(np.float32), compute)
                          for _ in range(2))
    scale = rng.uniform(0.5, 1.5, size=(64,)).astype(np.float32)
    close(M._gated_norm(ty, tz, torch.from_numpy(scale)),
          jM._gated_norm(jy, jz, jnp.asarray(scale)), compute)


@pytest.mark.parametrize("compute", DTYPES)
def test_mamba2_fwd_matches_repro_in_every_mode(compute):
    """Train (no state), prefill from a state and a conv state, one decode
    step from them: outputs, SSM states and conv states."""
    jcfg, tcfg = cfgs(compute)
    jp, tp = layer_params()
    rng = np.random.default_rng(3)
    ju, tu = pair(rng.normal(size=(2, 16, 32)).astype(np.float32), compute)
    jst, tst = pair(rng.normal(size=(2, 8, 8, 8)).astype(np.float32), compute)
    jcv, tcv = pair(rng.normal(size=(2, 3, 96)).astype(np.float32), compute)
    with torch.inference_mode():
        want, _ = j_mamba2_fwd(jp, ju, jcfg)
        got, _ = M.mamba2_fwd(tp, tu, tcfg)
        close(got, want, compute)
        want, (ws, wc) = j_mamba2_fwd(jp, ju, jcfg, state=jst, conv_state=jcv)
        got, (gs, gc) = M.mamba2_fwd(tp, tu, tcfg, state=tst, conv_state=tcv)
        for a, b in ((got, want), (gs, ws), (gc, wc)):
            close(a, b, compute)
        want, (ws, wc) = j_mamba2_fwd(jp, ju[:, :1], jcfg, state=jst, conv_state=jcv,
                                       decode=True)
        got, (gs, gc) = M.mamba2_fwd(tp, tu[:, :1], tcfg, state=tst, conv_state=tcv,
                                     decode=True)
        for a, b in ((got, want), (gs, ws), (gc, wc)):
            close(a, b, compute)


def test_mamba2_chunked_vs_step():
    """``repro``'s test on the port: the chunked forward of 8 tokens equals 8
    decode steps from the zero state (fp32, rtol 1e-4, atol 1e-5)."""
    cfg = TConfig(name="m", family="ssm", num_layers=1, d_model=32, num_heads=2, kv_heads=2,
                  d_ff=0, vocab=64, ssm_state=8, ssm_head_dim=8,
                  compute_dtype="float32", param_dtype="float32")
    g = torch.Generator().manual_seed(4)
    params, _ = M.init_mamba2(cfg, generator=g, device="cpu")
    u = torch.randn((1, 8, 32), generator=g)
    with torch.inference_mode():
        y_par, _ = M.mamba2_fwd(params, u, cfg)
        st, conv = M.init_ssm_state(cfg, 1, dtype=torch.float32, device="cpu")
        ys = []
        for t in range(8):
            yt, (st, conv) = M.mamba2_fwd(params, u[:, t:t + 1], cfg, state=st, conv_state=conv,
                                          decode=True)
            ys.append(yt)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_par, rtol=1e-4, atol=1e-5)


def test_lengths_the_chunk_does_not_divide_are_refused():
    z = ssd_inputs(s=12)
    t = {k: torch.from_numpy(v) for k, v in z.items()}
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        M.ssd_chunked(t["x"], t["a"], t["b"], t["c"], chunk=8)
    y, _ = M.ssd_chunked(t["x"], t["a"], t["b"], t["c"], chunk=4)       # 12 = 3 x 4
    assert y.shape == (2, 12, 4, 8)
    _, tcfg = cfgs()
    _, tp = layer_params()
    with pytest.raises(ValueError, match="not a multiple of the chunk 256"):
        M.mamba2_fwd(tp, torch.zeros((1, 300, 32)), tcfg)
    out, _ = M.mamba2_fwd(tp, torch.zeros((1, 200, 32)), tcfg)            # one chunk of 200
    assert out.shape == (1, 200, 32)


def test_init_mamba2_tree_and_scales_match_repro():
    """Keys, shapes, dtypes and logical axes as ``repro``'s; the constants
    equal; each drawn leaf's standard deviation within 10% of its scale."""
    jcfg, tcfg = cfgs()
    jcfg, tcfg = (c.replace(d_model=128, num_layers=6) for c in (jcfg, tcfg))
    jp, jaxes = jM.init_mamba2(jax.random.PRNGKey(0), jcfg)
    tp, taxes = M.init_mamba2(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert taxes == jaxes and set(tp) == set(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == jp[k].shape and v.dtype == torch.float32, k
    for k in ("conv_b", "A_log", "D", "dt_bias", "norm_scale"):
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    di = M.d_inner(tcfg)
    for k, scale in (("in_proj", 1 / math.sqrt(128)), ("conv_w", 0.5),
                     ("out_proj", 1 / math.sqrt(di * 2 * 6))):
        assert abs(float(tp[k].std()) / scale - 1) < 0.1, k
        assert abs(float(np.asarray(jp[k]).std()) / scale - 1) < 0.1, k
    assert (M.d_inner(tcfg), M.num_ssm_heads(tcfg)) == (jM.d_inner(jcfg), jM.num_ssm_heads(jcfg))
    assert (M.CONV_WIDTH, M.CHUNK) == (jM.CONV_WIDTH, jM.CHUNK)
    st, conv = M.init_ssm_state(tcfg, 3, device="cpu")
    jst, jconv = jM.init_ssm_state(jcfg, 3)
    assert (tuple(st.shape), tuple(conv.shape)) == (jst.shape, jconv.shape)
    assert st.dtype == tcfg.cdtype and not bool(st.any())
