"""Inputs and bounds shared by the prefix models' parity tests
(``tests/test_torch_whisper.py``, ``tests/test_torch_pixtral.py``):
``repro``'s params carried over to the port, the same numpy prefix and
tokens, and ``repro``'s consistency bound, 1e-4 (rtol and atol), for fp32
logits and caches (``tests/test_models_consistency.py``)."""

import jax
import numpy as np
import torch

from repro.configs import registry as j_registry
from repro.models import pixtral as jP
from repro.models import whisper as jW
from repro_torch.configs import registry as t_registry
from repro_torch.convert import lm_params_from_numpy

TOL = 1e-4
LOSS_TOL = 1e-5
J_INIT = {"whisper-large-v3": jW.init_whisper, "pixtral-12b": jP.init_pixtral}


def prefix_pair(arch: str, vocab: str, compute: str = "float32", **kw):
    """(repro cfg, port cfg, repro params, port params) on the same weights:
    the arch's smoke config with ``vocab`` (QR at collision 8)."""
    kw = dict(compute_dtype=compute, embedding_kind=vocab, qr_collision=8, **kw)
    jcfg = j_registry.get(arch).smoke.replace(**kw)
    tcfg = t_registry.get(arch).smoke.replace(**kw)
    jp, _ = J_INIT[arch](jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def prefix_rows(b: int, n: int, d: int, seed: int = 2) -> np.ndarray:
    """(b, n, d) fp32 standard normal rows: whisper's frames, pixtral's
    patches."""
    return np.random.default_rng(seed).standard_normal((b, n, d)).astype(np.float32)


def close(got, want, tol: float = TOL) -> None:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def leaf_scale_close(got, want, tol: float = TOL) -> None:
    """Each leaf of the port's gradient tree within ``tol`` of the scale
    (max |.|) of ``repro``'s leaf at the same path.  A key projection's bias
    is held to its weight's scale instead: a softmax does not change when
    all of a query's scores move together, so that bias's gradient is zero
    but for rounding in both packages."""
    from repro_torch import tree

    tl, jl = list(tree.leaves_with_paths(got)), jax.tree.leaves(want)
    assert len(tl) == len(jl)
    scale = {path: float(np.abs(np.asarray(j, np.float64)).max())
             for (path, _), j in zip(tl, jl)}
    for (path, t), j in zip(tl, jl):
        err = float(np.abs(t.double().numpy() - np.asarray(j, np.float64)).max())
        ref = scale[path[:-1] + "w"] if path.endswith("wk/b") else scale[path]
        assert err <= tol * max(ref, 1e-30), (path, err)
