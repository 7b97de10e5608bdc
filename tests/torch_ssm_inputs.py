"""Inputs and bounds shared by the sub-quadratic models' parity tests
(``tests/test_torch_zamba2.py``, ``tests/test_torch_xlstm.py``): ``repro``'s
params carried over to the port, ``repro``'s forwards jitted whole, and the
rules the two packages' logits are held to.

fp32 compute: a whole model's logits to ``FP32_TOL`` (rtol and atol), as
``tests/test_torch_lm_transformer.py``.  bf16 compute: ``repro``'s own bf16
logits lie 4-8% of their scale from its fp32 logits on these recurrent
stacks, and XLA fuses elementwise chains in fp32 where PyTorch rounds each
operation, so the port's bf16 values are held to ``repro``'s fp32 values:
within ``BF16_SCALE`` of their scale (the transformer tests' bf16 bound),
or no further from them than ``BF16_FACTOR`` times ``repro``'s bf16 values
are (the rule of ``chip_smoke.py``'s meshed bf16 gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as j_registry
from repro.models import xlstm as jX
from repro.models import zamba2 as jZ
from repro_torch.configs import registry as t_registry
from repro_torch.convert import lm_params_from_numpy

FP32_TOL = 5e-5
BF16_FACTOR = 2.0
BF16_SCALE = 2e-2
J_INIT = {"zamba2-7b": jZ.init_zamba2, "xlstm-125m": jX.init_xlstm}
j_forward_zamba2 = jax.jit(jZ.forward_zamba2, static_argnames=("cfg", "decode"))
j_forward_xlstm = jax.jit(jX.forward_xlstm, static_argnames=("cfg", "decode"))


def ssm_pair(arch: str, vocab: str, compute: str = "float32", **kw):
    """(repro cfg, port cfg, repro params, port params) on the same weights:
    the arch's smoke config with ``vocab`` (QR at collision 8)."""
    kw = dict(compute_dtype=compute, embedding_kind=vocab, qr_collision=8, **kw)
    jcfg = j_registry.get(arch).smoke.replace(**kw)
    tcfg = t_registry.get(arch).smoke.replace(**kw)
    jp, _ = J_INIT[arch](jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def as64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def close_fp32(got, want) -> None:
    got, want = as64(got), as64(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def close_bf16(got, want16, want32) -> None:
    """The port's bf16 ``got`` within ``BF16_SCALE`` of the scale of
    ``repro``'s fp32 ``want32``, or no further from it than ``BF16_FACTOR``
    times ``repro``'s bf16 ``want16`` is."""
    got, want16, want32 = as64(got), as64(want16), as64(want32)
    assert got.shape == want16.shape == want32.shape
    ours = float(np.abs(got - want32).max())
    theirs = float(np.abs(want16 - want32).max())
    scale = float(np.abs(want32).max())
    assert ours <= max(BF16_FACTOR * theirs, BF16_SCALE * scale), (ours, theirs, scale)
