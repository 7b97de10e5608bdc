"""Inputs shared by the LM training parity tests: ``repro``'s LM params
and the port's on the same weights, and tokens from a seed."""

import jax
import numpy as np

from repro.configs import registry as j_registry
from repro.models import transformer as j_T
from repro_torch.configs import registry as t_registry
from repro_torch.convert import lm_params_from_numpy


def lm_pair(arch: str, vocab: str, compute: str = "float32", **kw):
    """(repro cfg, port cfg, repro params, port params) on the same weights:
    the arch's smoke config with ``vocab`` (QR at collision 8)."""
    kw = dict(compute_dtype=compute, embedding_kind=vocab, qr_collision=8, **kw)
    jcfg = j_registry.get(arch).smoke.replace(**kw)
    tcfg = t_registry.get(arch).smoke.replace(**kw)
    jp, _ = j_T.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab: int, b: int, s: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
