"""LM token batches, criteo-like long-tail traces, DLRM request and
training batches, the prefix models' batches (whisper's frames, pixtral's
patches) and the restart-safe batch pipeline (port of
``repro.data.synthetic``).

On a mesh every rank makes the global batch of (seed, step) and keeps its
block along the batch axes (``data_block``), as ``repro``'s meshed launcher
makes the global batch and lets XLA split it: the ranks train on the same
stream as one card, and a restart onto another ``data`` size replays it.

``zipf_probs`` / ``zipf_trace`` are numpy and copied verbatim, so both
packages plan from the same traces bit for bit.  ``dlrm_batch`` draws on an
explicit ``torch.Generator`` seeded from ``(seed, step)``: its numbers differ
from ``jax.random``'s, but the sampling law (inverse CDF of a continuous
Zipf density, then a multiplicative shuffle) is the same, and
``zipf_from_uniform`` applied to ``repro``'s uniforms reproduces its indices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig, ModelConfig

# the multiplicative shuffle constant of ``repro``'s zipf_batch_jax
_SHUFFLE = 2654435761


def zipf_probs(vocab: int, alpha: float = 1.05) -> np.ndarray:
    """Zipf(alpha) over a fixed random permutation of row ids (hot rows are
    scattered across the table, as the paper observes)."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    rng = np.random.default_rng(1234)
    perm = rng.permutation(vocab)
    out = np.empty_like(p)
    out[perm] = p
    return out


def zipf_trace(
    vocab: int, n: int, *, alpha: float = 1.05, seed: int = 0, step: int = 0
) -> np.ndarray:
    """n long-tail logical indices (host-side numpy, for profiling)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    return rng.choice(vocab, size=n, p=zipf_probs(vocab, alpha)).astype(np.int32)


def generator(seed: int, step: int, tag: int, device) -> torch.Generator:
    """A torch generator that is a pure function of ``(seed, step, tag)``: a
    restarted worker regenerates the same batch."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step, tag]).generate_state(1)[0]))
    return g


def lm_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0, step: int = 0,
             device="cpu") -> dict:
    """(batch, seq) int32 tokens drawn uniformly from [0, vocab), a pure
    function of ``(seed, step)`` (``repro``'s law; its numbers are
    ``jax.random``'s, these a ``torch.Generator``'s)."""
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=generator(seed, step, 0, device),
                           device=device, dtype=torch.int32)
    return {"tokens": tokens}


def _prefixed_batch(cfg: ModelConfig, key: str, rows: int, batch: int, seq: int, *,
                    seed: int, step: int, device) -> dict:
    """``lm_batch``'s tokens and, under ``key``, (batch, rows, d_model) fp32
    standard normal rows drawn with ``repro``'s tag 1: a pure function of
    ``(seed, step)``."""
    prefix = torch.randn((batch, rows, cfg.d_model), generator=generator(seed, step, 1, device),
                         device=device, dtype=torch.float32)
    return {key: prefix, **lm_batch(cfg, batch, seq, seed=seed, step=step, device=device)}


def whisper_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0, step: int = 0,
                  device="cpu") -> dict:
    """``{"frames": (batch, N_AUDIO, d_model) fp32, "tokens": (batch, seq)}``."""
    from repro_torch.models.whisper import N_AUDIO

    return _prefixed_batch(cfg, "frames", N_AUDIO, batch, seq, seed=seed, step=step,
                           device=device)


def pixtral_batch(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0, step: int = 0,
                  device="cpu") -> dict:
    """``{"patches": (batch, num_patches, d_model) fp32, "tokens": (batch, seq)}``."""
    return _prefixed_batch(cfg, "patches", cfg.num_patches, batch, seq, seed=seed, step=step,
                           device=device)


def zipf_from_uniform(u: torch.Tensor, vocab: int, alpha: float = 1.05) -> torch.Tensor:
    """Zipf-like indices from float32 uniforms in [1e-6, 1): the inverse CDF
    of the density x^-alpha on [1, vocab], then ``repro``'s multiplicative
    shuffle.  The shuffle wraps in uint32 there; here it runs in int64 and
    masks to 32 bits, which gives the same numbers."""
    a = 1.0 - alpha
    x = ((vocab ** a - 1.0) * u + 1.0) ** (1.0 / a)
    idx = (x.to(torch.int32) - 1).clamp_(0, vocab - 1).to(torch.int64)
    return (((idx * _SHUFFLE) & 0xFFFFFFFF) % vocab).to(torch.int32)


def zipf_batch(
    vocab: int, shape: tuple, *, alpha: float = 1.05, seed: int = 0, step: int = 0,
    device="cpu",
) -> torch.Tensor:
    """Device-side approximate Zipf sampling (``zipf_batch_jax``'s law)."""
    g = generator(seed, step, 2, device)
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    u = u * (1.0 - 1e-6) + 1e-6
    return zipf_from_uniform(u, vocab, alpha)


def dlrm_batch(
    cfg: DLRMConfig, batch: int, *, seed: int = 0, step: int = 0,
    alpha: float = 1.05, device="cpu",
) -> dict:
    """Dense features + per-table multi-hot Zipf indices + random labels."""
    dense = torch.randn((batch, cfg.num_dense), generator=generator(seed, step, 3, device),
                        device=device, dtype=torch.float32)
    idx = zipf_batch(
        cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
        alpha=alpha, seed=seed, step=step, device=device,
    )
    labels = (torch.rand((batch,), generator=generator(seed, step, 4, device),
                         device=device) < 0.25).to(torch.float32)
    return {"dense": dense, "idx": idx, "labels": labels}


def dlrm_truth(cfg: DLRMConfig, *, dim: int = 8, seed: int = 99, device="cpu") -> torch.Tensor:
    """Ground-truth item embeddings (vocab, dim) for planted-structure CTR
    labels: standard normal draws times 0.5, from a generator seeded with
    ``seed``."""
    g = generator(seed, 0, 5, device)
    return torch.randn((cfg.vocab_per_table, dim), generator=g, device=device) * 0.5


def dlrm_planted_batch(
    cfg: DLRMConfig, truth: torch.Tensor, batch: int, *, seed: int = 0, step: int = 0,
    alpha: float = 1.05, device="cpu",
) -> dict:
    """A CTR batch whose labels come from a planted embedding model, so the
    loss is learnable and AUC against it measures model quality: score =
    mean over ``truth``'s dim of the sum of the batch's truth rows, plus 0.1
    x the dense features' sum; label ~ Bernoulli(sigmoid(score - mean))."""
    dense = torch.randn((batch, cfg.num_dense), generator=generator(seed, step, 3, device),
                        device=device, dtype=torch.float32)
    idx = zipf_batch(
        cfg.vocab_per_table, (batch, cfg.num_tables, cfg.pooling),
        alpha=alpha, seed=seed, step=step, device=device,
    )
    score = truth.to(device)[idx.long()].sum(dim=(1, 2)).mean(dim=-1) + 0.1 * dense.sum(dim=-1)
    prob = torch.sigmoid(score - score.mean())
    u = torch.rand((batch,), generator=generator(seed, step, 4, device), device=device)
    return {"dense": dense, "idx": idx, "labels": (u < prob).to(torch.float32)}


def data_block(batch: dict, mesh) -> dict:
    """This rank's block of every tensor of the global ``batch`` along the
    batch axes of ``mesh`` that split its rows (``sharding.batch_split``):
    a batch the data ranks do not divide stays whole on every rank, as
    ``repro``'s ``resolve_spec`` leaves it."""
    from repro_torch.distributed import sharding as SH

    rows = next(iter(batch.values())).shape[0] if batch else 0
    axes = SH.batch_split(rows, mesh)
    if not axes:
        return batch
    spec = SH.P(axes if len(axes) > 1 else axes[0])
    return {k: SH.local_shard(v, mesh, spec) for k, v in batch.items()}


@dataclasses.dataclass
class Pipeline:
    """Deterministic, restart-safe batch iterator.

    ``state()`` is the cursor a checkpoint keeps; ``seek`` resumes from it.
    A worker of a multi-worker launch takes its own ``shard`` of
    ``num_shards`` and makes only its slice (another stream), the same on
    every retry.  A rank of a ``mesh`` instead makes the global batch and
    keeps its ``data_block`` of it."""

    make_batch: Callable
    seed: int = 0
    step: int = 0
    shard: int = 0
    num_shards: int = 1
    mesh: object = None

    def __iter__(self):
        return self

    def __next__(self):
        b = self.make_batch(seed=self.seed * self.num_shards + self.shard, step=self.step)
        self.step += 1
        return b if self.mesh is None else data_block(b, self.mesh)

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def seek(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])
