"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, on ``repro``'s params carried over by
``convert.lm_params_from_numpy`` and the same numpy inputs (the configs of
``tests/test_moe.py`` and ``tests/test_perf_variants.py``).

Tolerances: fp32 outputs to rtol 2e-4 / atol 2e-5 (``repro``'s own bound,
``tests/test_moe.py``), bf16 outputs to 2e-2 of their scale (ROADMAP.md's
cross-framework bound), fp32 gradients of a sum-of-squares loss to rtol
1e-4 / atol 1e-5 (``tests/test_perf_variants.py``'s).  The routing ids and
the dropped assignments are equal, not close.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import ModelConfig as TConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

FP32 = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16_SCALE = 2e-2


def configs(**kw):
    """(repro's, the port's) ``tests/test_moe.py`` config with ``kw``."""
    base = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=4, kv_heads=2,
                d_ff=16, vocab=64, num_experts=8, top_k=2, compute_dtype="float32",
                param_dtype="float32")
    base.update(kw)
    return JConfig(**base), TConfig(**base)


def pair(jcfg, bias: float = 0.0, seed: int = 0):
    """(repro's params, the port's) on the same weights; ``bias`` added to
    every weight of the router's column 0 (expert 0 wins or loses by far:
    its queue overflows)."""
    jp, _ = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp)
    if bias:
        jp["router"] = jp["router"].at[:, 0].add(bias)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def inputs(shape, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def repro_keep(jp, x: np.ndarray, jcfg) -> np.ndarray:
    """``repro``'s kept assignments (T * k,) on one device: its router and
    its one-hot cumsum positions (``moe.py:86-96``), written out."""
    d = x.shape[-1]
    logits = jnp.asarray(x).reshape(-1, d) @ jp["router"]
    _, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    flat = ids.reshape(-1)
    cap = jmoe._capacity(flat.shape[0] // jcfg.top_k, jcfg, 1)
    onehot = jax.nn.one_hot(flat, jcfg.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot, flat[:, None], 1)[:, 0]
    return np.asarray(pos < cap)


def test_init_moe_shapes_and_axes_match_repro():
    """``repro``'s keys, shapes, dtypes and logical axes; each leaf's
    standard deviation within 10% of the scale both draw at (the numbers
    differ: ``torch.Generator`` against ``jax.random``)."""
    jcfg, tcfg = configs(num_layers=3, d_model=64, num_experts=16)
    jp, jaxes = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    tp, taxes = moe.init_moe(tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert taxes == jaxes
    assert set(tp) == set(jp)
    scale = {"router": 64 ** -0.5, "w_up": 64 ** -0.5, "w_gate": 64 ** -0.5,
             "w_down": (16 * 2 * 3) ** -0.5}
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32, k
        for leaf in (tp[k].double().numpy(), np.asarray(jp[k], np.float64)):
            assert abs(float(np.std(leaf)) - scale[k]) <= 0.1 * scale[k], k


@pytest.mark.parametrize("tokens,factor", [(64, 1.25), (3, 1.25), (37, 0.1), (512, 8.0)])
def test_capacity_equals_repro(tokens, factor):
    jcfg, tcfg = configs(num_experts=40, top_k=8, capacity_factor=factor)
    for shards in (1, 2, 16):
        assert moe._capacity(tokens, tcfg, shards) == jmoe._capacity(tokens, jcfg, shards)


def test_padded_experts():
    _, tcfg = configs(num_experts=40)
    assert moe.padded_experts(tcfg, 16) == 48
    assert moe.padded_experts(configs(num_experts=128)[1], 16) == 128


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_apply_moe_matches_repro(compute, dispatch):
    jcfg, tcfg = configs(compute_dtype=compute, moe_dispatch=dispatch, capacity_factor=2.0)
    jp, tp = pair(jcfg)
    x = inputs((2, 16, 32))
    want = np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg).astype(jnp.float32))
    with torch.inference_mode():
        got = moe.apply_moe(tp, torch.from_numpy(x), tcfg)
    assert got.dtype == tcfg.cdtype and tuple(got.shape) == (2, 16, 32)
    got = got.float().numpy()
    if compute == "float32":
        np.testing.assert_allclose(got, want, **FP32)
    else:
        assert float(np.abs(got - want).max()) <= BF16_SCALE * float(np.abs(want).max())


def test_routing_ids_equal_repro():
    jcfg, tcfg = configs()
    jp, tp = pair(jcfg)
    x = inputs((4, 16, 32), seed=2)
    logits = jnp.asarray(x).reshape(-1, 32) @ jp["router"]
    jw, jids = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    ids, wts = moe.route(tp["router"], torch.from_numpy(x), tcfg)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (64, 2)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(wts.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["test_moe.py factor 0.1", "perf_variants factor 0.25"])
@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_capacity_drops_the_same_assignments(case, dispatch):
    """The overflow cases of ``tests/test_moe.py`` (router column 0 + 100,
    factor 0.1, 64 tokens) and ``tests/test_perf_variants.py`` (+ 10,
    factor 0.25, 32 tokens of d 16): the kept assignments are ``repro``'s,
    and so are the outputs.  At + 100 most probabilities underflow, and
    XLA's CPU backend flushes subnormals to zero, so many tokens' second
    choice is a tie among zeros that both break toward the lower expert;
    the port's softmax runs with subnormals flushed too here, so it sees the
    same ties."""
    flush = torch.set_flush_denormal(True)
    try:
        _drops_match(case, dispatch)
    finally:
        torch.set_flush_denormal(False)
    assert flush


def _drops_match(case, dispatch):
    if case.startswith("test_moe"):
        jcfg, tcfg = configs(capacity_factor=0.1, moe_dispatch=dispatch)
        bias, x = 100.0, inputs((1, 64, 32))
    else:
        jcfg, tcfg = configs(d_model=16, num_heads=2, d_ff=8, num_experts=4,
                             capacity_factor=0.25, moe_dispatch=dispatch)
        bias, x = 10.0, inputs((1, 32, 16))
    jp, tp = pair(jcfg, bias)
    ids, _ = moe.route(tp["router"], torch.from_numpy(x), tcfg)
    cap = moe._capacity(ids.shape[0], tcfg, 1)
    keep = (moe.slots(ids, 0, tcfg.num_experts, cap) < tcfg.num_experts * cap).numpy()
    want_keep = repro_keep(jp, x, jcfg)
    np.testing.assert_array_equal(keep, want_keep)
    assert 0 < keep.sum() < keep.size                      # the capacity binds
    assert moe.dropped(ids, tcfg) == keep.size - keep.sum()
    want = np.asarray(jmoe.apply_moe(jp, jnp.asarray(x), jcfg))
    with torch.inference_mode():
        got = moe.apply_moe(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, **FP32)
    # the full-capacity output is larger, as repro's test has it
    with torch.inference_mode():
        full = moe.apply_moe(tp, torch.from_numpy(x), tcfg.replace(capacity_factor=8.0))
    assert float(np.linalg.norm(got)) < float(full.norm())


def test_high_capacity_matches_the_per_token_oracle():
    """Capacity ample enough never to drop: the dense per-token mixture
    sum_k w_k FFN_{e_k}(x), ``tests/test_moe.py``'s oracle."""
    jcfg, tcfg = configs(capacity_factor=8.0)
    _, tp = pair(jcfg)
    x = torch.from_numpy(inputs((1, 16, 32)))
    with torch.inference_mode():
        out = moe.apply_moe(tp, x, tcfg).reshape(16, 32)
        ids, wts = moe.route(tp["router"], x, tcfg)
        xs = x.reshape(16, 32)
        want = torch.zeros(16, 32)
        for t in range(16):
            for j in range(2):
                e = int(ids[t, j])
                h = torch.nn.functional.silu(xs[t] @ tp["w_gate"][e]) * (xs[t] @ tp["w_up"][e])
                want[t] += wts[t, j] * (h @ tp["w_down"][e])
    torch.testing.assert_close(out, want, **FP32)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("factor", [2.0, 0.25])
def test_gradients_match_jax_grad(dispatch, factor):
    """fp32 gradients of ``sum(apply_moe(p, x) ** 2)`` in every param and
    in x against ``jax.grad``, with and without drops."""
    jcfg, tcfg = configs(capacity_factor=factor, moe_dispatch=dispatch)
    jp, tp = pair(jcfg, bias=2.0)
    x = inputs((2, 16, 32))

    def jloss(p, v):
        return jnp.sum(jmoe.apply_moe(p, v, jcfg) ** 2)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (moe.apply_moe(live, xt, tcfg) ** 2).sum().backward()
    for k in jp:
        np.testing.assert_allclose(live[k].grad.numpy(), np.asarray(jg[k]), err_msg=k, **GRAD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), **GRAD)


def test_two_calls_are_bitwise_equal_and_dispatch_modes_agree():
    """The combine adds each token's k rows in one order: two calls give the
    same bits; the two dispatch modes give the same output and gradients
    (``tests/test_perf_variants.py``'s check, bitwise here)."""
    _, tcfg = configs(capacity_factor=0.5)
    jp, tp = pair(configs()[0], bias=1.0)
    x = torch.from_numpy(inputs((2, 16, 32)))
    outs, grads = [], []
    for dispatch in ("scatter", "scatter", "gather"):
        live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = moe.apply_moe(live, x, tcfg.replace(moe_dispatch=dispatch))
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([live[k].grad for k in sorted(live)])
    for o, g in zip(outs[1:], grads[1:]):
        assert torch.equal(o, outs[0])
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))
