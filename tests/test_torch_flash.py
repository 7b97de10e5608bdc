"""Attention of the port (kernel K9's entry ``ops.flash_attention_fused``,
its plain versions and the blockwise ``models.layers.flash_attention``)
against ``repro`` on the CPU.

On the CPU the K9 wrapper takes its plain version ``ref.flash_fwd_ref``; it
is held against ``repro``'s Pallas kernel ``flash_fwd`` in interpret mode at
``repro``'s own tolerances (fp32 rtol 2e-4 / atol 2e-5, bf16 3e-2), causal
Sq != Skv included.  Inputs are numpy draws from a seed, handed to both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_fwd as j_flash_fwd  # noqa: E402
from repro.kernels.flash_attention import flash_mha as j_flash_mha  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TOL = {np.float32: dict(rtol=2e-4, atol=2e-5), "bf16": dict(rtol=3e-2, atol=3e-2)}


def _qkv(b, h, kh, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(b, h, sq, d), f(b, kh, skv, d), f(b, kh, skv, d)


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 256, 256, True),     # GQA causal
    (1, 4, 4, 128, 384, False),    # MHA cross-length
    (1, 4, 2, 128, 384, True),     # causal, Sq < Skv
    (1, 4, 2, 384, 128, True),     # causal, Sq > Skv
    (1, 2, 2, 128, 128, True),     # test_kernels' dtype case
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_fused_matches_repro_kernel(shape, dtype):
    b, h, kh, sq, skv, causal = shape
    q, k, v = _qkv(b, h, kh, sq, skv, 128, seed=sq + skv)
    if dtype == "bf16":
        jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
        tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
        tol = TOL["bf16"]
    else:
        jq, jk, jv = q, k, v
        tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
        tol = TOL[np.float32]
    expect = j_flash_fwd(jq, jk, jv, causal=causal, q_block=128, kv_block=128,
                         interpret=True)
    got = ops.flash_attention_fused(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(expect, np.float32), **tol)


@pytest.mark.parametrize("sq,skv", [(128, 384), (384, 128), (64, 64)])
def test_causal_conventions(sq, skv):
    """K9's plain version masks top-left, as repro's kernel and its
    ``layers.flash_attention``; repro's oracle ``ref.flash_attention_ref``
    masks bottom-right, and the port keeps it so: the two agree only when
    Sq == Skv."""
    q, k, v = _qkv(1, 4, 2, sq, skv, 32, seed=3)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    kernel_plain = ref.flash_fwd_ref(*t, causal=True).numpy()
    blockwise = np.asarray(jlayers.flash_attention(q, k, v, causal=True))
    oracle = np.asarray(jref.flash_attention_ref(q, k, v, causal=True))
    np.testing.assert_allclose(kernel_plain, blockwise, **TOL[np.float32])
    np.testing.assert_allclose(ref.flash_attention_ref(*t, causal=True).numpy(), oracle,
                               **TOL[np.float32])
    if sq == skv:
        np.testing.assert_allclose(kernel_plain, oracle, **TOL[np.float32])
    else:
        assert np.abs(kernel_plain - oracle).max() > 1e-2


@pytest.mark.parametrize("case", [
    dict(q=(2, 4, 64, 16), kv=(2, 2, 64, 16), causal=True, q_block=16, kv_block=16),
    dict(q=(1, 2, 48, 8), kv=(1, 2, 96, 8), causal=False, q_block=32, kv_block=32),
    dict(q=(1, 4, 96, 16), kv=(1, 2, 160, 16), causal=True, q_block=32, kv_block=64),
])
@pytest.mark.parametrize("p_dtype", [None, "bf16"])
def test_blockwise_attention_matches_repro(case, p_dtype):
    rng = np.random.default_rng(0)
    q = rng.standard_normal(case["q"]).astype(np.float32)
    k = rng.standard_normal(case["kv"]).astype(np.float32)
    v = rng.standard_normal(case["kv"]).astype(np.float32)
    kw = dict(causal=case["causal"], q_block=case["q_block"], kv_block=case["kv_block"])
    expect = jlayers.flash_attention(q, k, v, p_dtype=p_dtype and jnp.bfloat16, **kw)
    got = layers.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 p_dtype=p_dtype and torch.bfloat16, **kw)
    assert got.shape == case["q"]
    # a bf16 probability tile: exp(s - m) near a rounding boundary may round
    # one bf16 step (2**-8 relative) apart in the two frameworks
    tol = TOL[np.float32] if p_dtype is None else dict(rtol=4e-3, atol=4e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_grads_match_repro(causal):
    """Gradients of flash_mha (K9 forward, blockwise recompute backward)
    against jax.grad of repro's flash_mha in interpret mode: both
    differentiate the same blockwise fp32 attention, in two frameworks'
    summation orders (rtol 1e-4, atol 1e-5)."""
    q, k, v = _qkv(1, 2, 2, 128, 128, 128, seed=7)
    w = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    jg = jax.grad(lambda a, b, c: (j_flash_mha(a, b, c, causal, True) * w).sum(),
                  argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    (ops.flash_attention_fused(*leaves, causal=causal) * torch.from_numpy(w)).sum().backward()
    for got, expect in zip(leaves, jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(expect), rtol=1e-4, atol=1e-5)


def test_flash_mha_grads_with_gqa_and_ragged_lengths():
    """GQA (H 6, KH 2) at Sq != Skv: the recompute backward equals plain
    autograd through K9's plain version."""
    q, k, v = _qkv(2, 6, 2, 40, 72, 16, seed=9)
    a = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    b = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    fa.flash_mha(*a, True).pow(2).sum().backward()
    ref.flash_fwd_ref(*b, causal=True).pow(2).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_flash_rejects_what_no_path_takes():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 3, 8, 8, 16))
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="differ"):
        fa.flash_fwd(q, k, v[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="4-d"):
        fa.flash_fwd(q[0], k[0], v[0])
