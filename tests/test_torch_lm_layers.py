"""The LM layers of the port (``repro_torch.models.layers``: ``dense``,
``apply_norm``, ``rms_norm_headwise``, ``rope``, ``decode_attention``,
``attention`` and ``mlp``) against ``repro.models.layers`` on the CPU, on
the same numpy inputs and the same params (``repro``'s draws carried over).

Tolerances: fp32 compute to 1e-5 (rtol and atol; the two frameworks sum the
products in other orders).  bf16 compute of one op (``dense``, the norms,
``rope``) to one bf16 step of the output, 2^-7 |want|,
plus 2^-7 of the output's scale for values near 0 (each side rounds an fp32
result once per op, and two fp32 results in other orders may straddle a
rounding boundary).  bf16 with attention inside (``decode_attention``,
``attention``) to 2e-2 of the output's scale: ``repro`` scales q in bf16 and
feeds its blockwise P·V a bf16 P, the port's K9 plain version scales and
sums in fp32 (ROADMAP.md's cross-framework bound).  ``mlp`` in bf16 is a
chain of rounded ops (up, gate, activation, product, down; ``jax.nn.gelu``
and ``silu`` round inside their formulas in bf16, torch's round once), so
its output is held to the same 2e-2 of scale.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch.configs import registry as tregistry  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-5)
STEP = 2.0 ** -7            # one bf16 step, relative
ATTN_BF16 = 2e-2            # of the output's scale


def _cfgs(arch="qwen2-1.5b", **kw):
    return (jregistry.get(arch).smoke.replace(**kw), tregistry.get(arch).smoke.replace(**kw))


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x) -> np.ndarray:
    return x.float().numpy()


def _close(got, want, compute, *, chained=False):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    if compute == "float32":
        np.testing.assert_allclose(got, want, **FP32)
    elif chained:
        assert float(np.abs(got - want).max()) <= ATTN_BF16 * scale
    else:
        bound = STEP * np.abs(want) + STEP * 1e-2 * scale
        assert np.all(np.abs(got - want) <= bound), float(np.abs(got - want).max())


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _dtypes(compute):
    return (jnp.float32 if compute == "float32" else jnp.bfloat16,
            torch.float32 if compute == "float32" else torch.bfloat16)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_matches_repro(compute, bias):
    jd, td = _dtypes(compute)
    p, _ = jL.init_dense(jax.random.PRNGKey(1), 48, 40, ("embed", "ffn"), dtype=jnp.float32,
                         bias=bias)
    if bias:
        p["b"] = jnp.asarray(_x((40,), 3))
    x = _x((2, 5, 48))
    want = jL.dense(p, jnp.asarray(x), jd)
    got = L.dense(lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                  torch.from_numpy(x), td)
    assert got.dtype == td
    _close(_t(got), _np(want), compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm_matches_repro(kind, compute):
    jd, td = _dtypes(compute)
    p, _ = jL.init_norm(kind, 64, jnp.float32)
    p = {k: jnp.asarray(1.0 + 0.1 * _x(v.shape, 5 + i)) for i, (k, v) in enumerate(p.items())}
    x = 3.0 * _x((2, 7, 64)) + 0.5
    want = jL.apply_norm(p, jnp.asarray(x).astype(jd))
    got = L.apply_norm(lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                       torch.from_numpy(x).to(td))
    assert got.dtype == td
    _close(_t(got), _np(want), compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_rms_norm_headwise_matches_repro(compute):
    jd, td = _dtypes(compute)
    x, scale = _x((2, 5, 4, 32)), 1.0 + 0.1 * _x((32,), 1)
    want = jL.rms_norm_headwise(jnp.asarray(x).astype(jd), jnp.asarray(scale))
    got = L.rms_norm_headwise(torch.from_numpy(x).to(td), torch.from_numpy(scale))
    _close(_t(got), _np(want), compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("partial", [1.0, 0.5, 0.3])
@pytest.mark.parametrize("positions", ["S", "BS"])
def test_rope_matches_repro(positions, partial, compute):
    jd, td = _dtypes(compute)
    b, h, s, d = 2, 4, 9, 32
    if positions == "S":             # x (B, H, S, D): the attention layout
        x, pos = _x((b, h, s, d)), np.arange(3, 3 + s, dtype=np.int32)
    else:                            # x (B, S, D) against per-row positions
        x = _x((b, s, d))
        pos = np.stack([np.arange(s), np.arange(5, 5 + s)]).astype(np.int32)
    want = jL.rope(jnp.asarray(x).astype(jd), jnp.asarray(pos), theta=1e6,
                   partial_factor=partial)
    got = L.rope(torch.from_numpy(x).to(td), torch.from_numpy(pos), theta=1e6,
                 partial_factor=partial)
    assert got.dtype == td
    _close(_t(got), _np(want), compute)


HEADS = [(4, 4), (4, 2), (8, 2), (4, 1)]     # GQA ratios 1, 2, 4 and MQA


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", HEADS)
def test_decode_attention_matches_repro(heads, compute):
    jd, td = _dtypes(compute)
    h, kh = heads
    q, k, v = _x((2, h, 1, 32), 1), _x((2, kh, 24, 32), 2), _x((2, kh, 24, 32), 3)
    want = jL.decode_attention(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), 13)
    got = L.decode_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)), 13)
    assert got.shape == (2, h, 1, 32) and got.dtype == td
    _close(_t(got), _np(want), compute, chained=True)


def test_decode_attention_reads_a_cache_view_in_place():
    """The decode branch hands ``decode_attention`` transposed views of the
    (B, S, KH, D) cache; the result is the one on contiguous copies."""
    q, cache_k, cache_v = _x((2, 4, 1, 32)), _x((2, 24, 2, 32), 1), _x((2, 24, 2, 32), 2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, cache_k, cache_v))
    views = L.decode_attention(tq, tk.transpose(1, 2), tv.transpose(1, 2), 20)
    copies = L.decode_attention(tq, tk.transpose(1, 2).contiguous(),
                                tv.transpose(1, 2).contiguous(), 20)
    assert torch.equal(views, copies)


ATTN_CASES = [
    dict(num_heads=4, kv_heads=4),
    dict(num_heads=4, kv_heads=2, partial_rotary=0.5),
    dict(num_heads=8, kv_heads=2, head_dim=16, qkv_bias=False),
    dict(num_heads=4, kv_heads=1, qk_norm=True),
]


def _attn_params(jcfg, seed=2):
    p, _ = jL.init_attention(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:   # nonzero biases, so the test sees them
        for i, name in enumerate(("wq", "wk", "wv")):
            p[name]["b"] = jnp.asarray(0.1 * _x(p[name]["b"].shape, 10 + i))
    return p, lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_train_branch_matches_repro(case, compute):
    jcfg, tcfg = _cfgs(compute_dtype=compute, **ATTN_CASES[case])
    jp, tp = _attn_params(jcfg)
    x = _x((2, 16, jcfg.d_model), 4)
    want, (jk, jv) = jL.attention(jp, jnp.asarray(x).astype(jcfg.cdtype), jcfg)
    got, (tk, tv) = L.attention(tp, torch.from_numpy(x).to(tcfg.cdtype), tcfg)
    assert got.dtype == tcfg.cdtype and tk.shape == (2, 16, tcfg.kv_heads, tcfg.head_dim_)
    _close(_t(got), _np(want), compute, chained=True)
    _close(_t(tk), _np(jk), compute)
    _close(_t(tv), _np(jv), compute)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_attention_decode_branch_matches_repro(case, compute):
    jcfg, tcfg = _cfgs(compute_dtype=compute, **ATTN_CASES[case])
    jp, tp = _attn_params(jcfg)
    kh, hd, pos = jcfg.kv_heads, jcfg.head_dim_, 9
    ck, cv = 0.5 * _x((2, 20, kh, hd), 6), 0.5 * _x((2, 20, kh, hd), 7)
    x = _x((2, 1, jcfg.d_model), 8)
    want, (jck, jcv) = jL.attention(
        jp, jnp.asarray(x).astype(jcfg.cdtype), jcfg,
        cache=(jnp.asarray(ck).astype(jcfg.cdtype), jnp.asarray(cv).astype(jcfg.cdtype)),
        pos=jnp.int32(pos))
    tck, tcv = (torch.from_numpy(a).to(tcfg.cdtype) for a in (ck, cv))
    got, (rk, rv) = L.attention(tp, torch.from_numpy(x).to(tcfg.cdtype), tcfg,
                                cache=(tck, tcv), pos=pos)
    assert rk is tck and rv is tcv                  # written in place
    _close(_t(got), _np(want), compute, chained=True)
    _close(_t(tck), _np(jck), compute)
    _close(_t(tcv), _np(jcv), compute)


def test_attention_raises_on_a_bf16_probability_tile():
    """``flash_block_dtype="bf16"`` no longer raises: the train branch
    rounds each probability to bf16 (K9's ``p_bf16``; its plain version on
    the CPU) and matches ``repro``'s ``_attn_block(p_dtype=bf16)`` in fp32
    compute to 1e-5, and its output moves off the fp32 tile's."""
    jcfg, tcfg = _cfgs(flash_block_dtype="bf16", compute_dtype="float32")
    jp, tp = _attn_params(jcfg)
    x = _x((2, 16, jcfg.d_model), 4)
    want, _ = jL.attention(jp, jnp.asarray(x), jcfg)
    got, _ = L.attention(tp, torch.from_numpy(x), tcfg)
    _close(_t(got), _np(want), "float32")
    f32, _ = L.attention(tp, torch.from_numpy(x), tcfg.replace(flash_block_dtype="f32"))
    assert not torch.equal(got, f32)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
def test_mlp_matches_repro(activation, compute):
    jcfg, tcfg = _cfgs(compute_dtype=compute, activation=activation)
    p, _ = jL.init_mlp(jax.random.PRNGKey(3), jcfg)
    x = _x((2, 6, jcfg.d_model), 9)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    assert set(p) == {"w_up", "w_down"} | ({"w_gate"} if activation == "silu" else set())
    want = jL.mlp(p, jnp.asarray(x).astype(jcfg.cdtype), jcfg)
    got = L.mlp(tp, torch.from_numpy(x).to(tcfg.cdtype), tcfg)
    _close(_t(got), _np(want), compute, chained=True)


def test_init_draws_have_repro_shapes_dtypes_and_scales():
    jcfg, tcfg = _cfgs(qk_norm=True)
    g = torch.Generator().manual_seed(0)
    for jfn, tfn in ((lambda: jL.init_attention(jax.random.PRNGKey(0), jcfg),
                      lambda: L.init_attention(tcfg, generator=g, device="cpu")),
                     (lambda: jL.init_mlp(jax.random.PRNGKey(0), jcfg),
                      lambda: L.init_mlp(tcfg, generator=g, device="cpu"))):
        (jp, jaxes), (tp, taxes) = jfn(), tfn()
        assert taxes == jaxes
        jleaves = jax.tree_util.tree_leaves_with_path(jp)
        tflat = {jax.tree_util.keystr(k): None for k, _ in jleaves}
        assert len(tflat) == len(jleaves)
        for path, jleaf in jleaves:
            node = tp
            for key in path:
                node = node[key.key]
            assert tuple(node.shape) == jleaf.shape and str(node.dtype)[6:] == jleaf.dtype.name
            want = float(np.std(np.asarray(jleaf)))
            assert abs(float(node.std()) - want) <= 0.05 * want + 1e-12
