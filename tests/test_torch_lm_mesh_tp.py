"""The LM trained on a mesh against the single-rank step, no ``repro``:
the step checks of ``torch_lm_mesh_checks`` on (2, 2) (also with 2
microbatches) and on (1, 4), where qwen2 smoke's 2 kv heads do not divide
``model`` (the kv projections stay whole) and 6 q heads with ``d_ff`` 250
run replicated; and the vocab-parallel loss from four ranks' uneven
slices."""

import numpy as np
import torch
from torch_one_thread import one_thread  # noqa: F401

import torch_lm_mesh_ranks as R
from repro_torch.core import qr_embedding
from repro_torch.launch import mesh as M
from repro_torch.train import train_step as ts
from torch_lm_mesh_checks import (  # noqa: F401  (the checks run on this file's meshes)
    SPAWN_S, meshed_fixture, test_every_rank_issues_the_same_collectives,
    test_fp32_lookup_is_bitwise_the_single_card,
    test_kv_projections_split_only_at_head_granularity,
    test_meshed_lm_step_matches_the_single_rank_step,
)

meshed = meshed_fixture({"2x2": (2, 2), "1x4": (1, 4)})


def test_vocab_parallel_loss_is_next_token_loss(tmp_path):
    """The loss from four ranks' uneven slices of a dense and a QR tied
    head's logits (498 tokens; the padding columns cut, one rank's QR slice
    empty) is ``next_token_loss`` to 1e-6, and so is each slice's gradient;
    each rank issues one pmax and one psum."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((3, 9, R.VOCAB), generator=g) * 4
    toks = torch.randint(0, R.VOCAB, (3, 9), generator=g, dtype=torch.int32)
    want = logits.clone().requires_grad_(True)
    loss = ts.next_token_loss(want, toks)
    (grad,) = torch.autograd.grad(loss, want)
    loss = float(loss.detach())
    for kind, collision in (("dense", 64), ("qr", 4), ("qr", 64)):
        emb = qr_embedding.EmbeddingConfig(vocab=R.VOCAB, dim=8, kind=kind, collision=collision)
        ranges = [qr_embedding.vocab_shard_range(emb, 4, s) for s in range(4)]
        assert ranges[0][0] == 0 and ranges[-1][1] == R.VOCAB
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        res = [r for r in M.spawn(_loss_rank, (1, 4), axes=("data", "model"),
                                  args=(logits, toks, ranges), device="cpu", backend="gloo",
                                  init_file=tmp_path / f"rdv{kind}{collision}",
                                  timeout_s=SPAWN_S)]
        for r, (lo, hi) in zip(res, ranges):
            assert abs(r["loss"] - loss) <= 1e-6 * abs(loss), (kind, r["loss"])
            np.testing.assert_allclose(r["grad"], grad[..., lo:hi].numpy(), rtol=0, atol=1e-6)
            assert r["sites"] == {"pmax/model": 1, "loss/model": 1}, r["sites"]


def _loss_rank(mesh, logits, toks, ranges):
    from torch_lm_mesh_ranks import vocab_loss

    return vocab_loss(mesh, logits, toks, *ranges[mesh.axis_index("model")])
