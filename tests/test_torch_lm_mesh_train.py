"""The LM trained on a mesh against the single-rank step, no ``repro`` (this
file runs where jax is absent too): the step checks of
``torch_lm_mesh_checks`` on the meshes whose ``model`` axis is 1 or 2,
(1, 1), (2, 1) and (1, 2) (``tests/test_torch_lm_mesh_tp.py`` runs (2, 2)
and (1, 4)), on a dense, a QR ``twolevel`` (collision 4: every Q shard
holds tokens) and a QR ``gspmd`` vocabulary (collision 64: one Q shard
holds them all, the others' vocabulary slices are empty), and on (1, 2)
also an untied head, an MQA block and 6 q heads with ``d_ff`` 250.  The
refusals: TT and hashed vocabularies on a mesh, q heads that would
straddle two kv groups; qwen2-1.5b's head split at full width."""

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import torch_lm_mesh_ranks as R
from repro_torch.core import qr_embedding as QE
from repro_torch.core import sharded_embedding as SE
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.train import train_step as TS
from torch_lm_mesh_checks import (  # noqa: F401  (the checks run on this file's meshes)
    meshed_fixture, test_every_rank_issues_the_same_collectives,
    test_fp32_lookup_is_bitwise_the_single_card,
    test_kv_projections_split_only_at_head_granularity,
    test_meshed_lm_step_matches_the_single_rank_step,
)

meshed = meshed_fixture({"1x1": (1, 1), "2x1": (2, 1), "1x2": (1, 2)})


def _fake_mesh(model: int, shard: int = 0) -> M.Mesh:
    return M.Mesh(shape={"data": 1, "model": model}, coords={"data": 0, "model": shard},
                  groups={}, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("kind", ["tt", "hashed"])
def test_tt_and_hashed_vocabularies_on_a_mesh_raise(kind):
    cfg = R.config("dense", embedding_kind=kind)
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    toks = R.tokens(cfg, 2, 4)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 8"):
        SE.token_embed_inline(params["embed"], toks, cfg.emb_config, mesh=_fake_mesh(2))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 item 8"), \
            SH.use_rules(_fake_mesh(2), SH.DEFAULT_RULES):
        T.forward_train(params, toks, cfg)


def test_token_embed_inline_needs_a_model_axis():
    """Off a ``model`` axis the single card's lookup is ``embed_tokens``'s:
    the two-level GnR refuses a mesh without one."""
    cfg = R.config("qr-twolevel")
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    data_only = M.Mesh(shape={"data": 2}, coords={"data": 0}, groups={},
                       device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="'model' axis"):
        SE.token_embed_inline(params["embed"], R.tokens(cfg, 2, 4), cfg.emb_config,
                              mesh=data_only)


@pytest.mark.parametrize("kind", ["dense", "qr-twolevel"])
@pytest.mark.parametrize("shard", [0, 1])
def test_logits_head_range_is_the_whole_heads_slice(kind, shard):
    """The tied head over a row shard's vocabulary range is that range of
    the whole head, bit for bit, padding columns cut."""
    cfg = R.config(kind)
    emb = cfg.emb_config
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32))
    lo, hi = QE.vocab_shard_range(emb, 2, shard)
    local = SE.shard_qr_params(params["embed"], emb, _fake_mesh(2, shard))
    whole = QE.logits_head(params["embed"], x, emb)
    assert torch.equal(QE.logits_head(local, x, emb, lo=lo, hi=hi), whole[..., lo:hi])
    assert whole.shape[-1] == cfg.vocab


def test_a_range_of_a_hashed_head_and_an_lm_loss_without_its_range_raise():
    cfg = R.config("dense", embedding_kind="hashed")
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match="vocabulary range of the hashed head"):
        QE.logits_head(params["embed"], x, cfg.emb_config, lo=0, hi=cfg.vocab // 2)
    loss = TS.make_lm_loss(lambda p, t, c: torch.zeros(*t.shape, 4), cfg)
    with pytest.raises(ValueError, match="needs the forward's vocab_range"), \
            SH.use_rules(_fake_mesh(2), SH.DEFAULT_RULES):
        loss({}, {"tokens": R.tokens(cfg, 1, 3)})


def test_straddling_heads_are_refused():
    """6 q heads in 3 kv groups of 2 over a model axis of 2: a rank's 3 q
    heads would read 1.5 kv groups."""
    cfg = R.config("dense", num_heads=6, kv_heads=3)
    with pytest.raises(ValueError, match="straddle two kv groups"):
        SH.head_split(cfg, _fake_mesh(2))
    params, axes = T.init_lm(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="6 q heads in 3 kv groups"):
        SH.tree_specs(params, axes, _fake_mesh(2), SH.lm_param_rules(cfg, _fake_mesh(2)))
    # the same heads over 3 ranks hold one kv group each
    assert SH.head_split(cfg, _fake_mesh(3, 2)) == SH.HeadSplit(q0=4, q=2, kv0=2, kv=1,
                                                                 kv_local=True)


@pytest.mark.parametrize("model,want", [
    (2, SH.HeadSplit(q0=6, q=6, kv0=1, kv=1, kv_local=True)),
    (4, SH.HeadSplit(q0=9, q=3, kv0=1, kv=1, kv_local=False)),
    (8, None),
])
def test_qwen2_head_split_at_full_width(model, want):
    """qwen2-1.5b's 12 q / 2 kv heads on the last rank of a model axis: kv
    split on 2, whole on 4 (each rank reads the kv head of its 3 q heads),
    the block replicated on 8 (12 heads do not divide it)."""
    from repro_torch.configs import registry

    cfg = registry.get("qwen2-1.5b").config
    assert SH.head_split(cfg, _fake_mesh(model, model - 1)) == want
    rules = SH.lm_param_rules(cfg, _fake_mesh(model, model - 1))
    assert rules["heads"] == (("model",) if want else None)
    assert rules["kv_heads"] == (("model",) if want and want.kv_local else None)
    # training stores ``embed`` split over ``data`` (FSDP); serving keeps it whole
    assert rules["embed"] == ("data",)
    assert SH.lm_param_rules(cfg, _fake_mesh(model, model - 1), serve=True)["embed"] is None
