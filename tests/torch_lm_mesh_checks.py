"""The meshed LM's step checks, shared by the test files that run them on
their meshes (``tests/test_torch_lm_mesh_train.py``, ``..._tp.py``): each
binds ``meshed = meshed_fixture({...})`` and imports the ``test_*``
functions.  No jax.  One step on gloo ranks, fp32 compute, on the smoke
configs with the vocabulary cut to 498 tokens (``torch_lm_mesh_ranks``):
every gathered gradient, the loss, the gradient norm and the new params
within 1e-5 of each leaf's scale (the largest |x| of the single-rank
leaf); every rank issuing the same collectives; the fp32 lookup bitwise;
the kv projections split at head granularity only."""

import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as R
from repro_torch import tree
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T

SPAWN_S = 240
SCALE_TOL = 1e-5
NAMES = list(R.CASES)
VOCABS = ["dense", "qr-twolevel", "qr-gspmd"]


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


def _hold(got: list, want: list, what: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g - w).max()) / scale
        assert err <= SCALE_TOL, f"{what} leaf {i}: {err} of its scale"


_SINGLE: dict = {}


def _single(name: str, microbatches: int = 1) -> dict:
    if (name, microbatches) not in _SINGLE:
        cfg = R.config(name)
        params, _ = T.init_lm(cfg, seed=0, device="cpu")
        _SINGLE[name, microbatches] = R.single_step(cfg, params, R.tokens(cfg), microbatches)
    return _SINGLE[name, microbatches]


def meshed_fixture(meshes: dict):
    """A module-scoped ``meshed`` fixture over ``meshes`` (name -> shape):
    every case's meshed step on one mesh in one spawn (the vocabularies
    alone where ``model`` is 1), the (2, 2) mesh also with 2 microbatches."""

    @pytest.fixture(scope="module", params=list(meshes))
    def meshed(request, tmp_path_factory):
        shape = meshes[request.param]
        names = NAMES if shape[1] > 1 else VOCABS
        cases = [(n, 1) for n in names] + ([("qr-twolevel", 2)] if shape == (2, 2) else [])
        res = _spawn(tmp_path_factory.mktemp(request.param), R.meshed_steps, shape, cases)
        return shape, cases, res

    return meshed


def test_meshed_lm_step_matches_the_single_rank_step(meshed):
    shape, cases, res = meshed
    for i, (name, mb) in enumerate(cases):
        want = _single(name, mb)
        for r in res:
            got = r[i]
            _hold(got["grads"], want["grads"], f"{shape} {name} gradient")
            _hold(got["params"], want["params"], f"{shape} {name} new params")
            for key in ("loss", "step_loss", "gnorm"):
                _hold([np.float32(got[key])], [np.float32(want[key])], f"{shape} {name} {key}")


def test_every_rank_issues_the_same_collectives(meshed):
    """The same sites and counts on every rank (one that skipped a
    collective would hang the mesh): per microbatch one pmax and one psum
    of the loss, an entry psum a tensor-parallel block, the head and the QR
    embedding's R; one data mean where ``data`` splits the batch, one norm
    where ``model`` splits leaves; where ``data`` splits the batch, FSDP's
    gathers and reduce-scatters over it."""
    shape, cases, res = meshed
    data, model = shape
    for i, (name, mb) in enumerate(cases):
        sites = [r[i]["sites"] for r in res]
        assert all(s == sites[0] for s in sites), (name, sites)
        cfg = R.config(name)
        mesh = M.Mesh(shape={"data": data, "model": model}, coords={"data": 0, "model": 0},
                      groups={}, device=torch.device("cpu"), backend="gloo")
        blocks = int(SH.head_split(cfg, mesh) is not None) + int(SH.ffn_split(cfg, mesh))
        entries = cfg.num_layers * blocks + 1 + int(cfg.embedding_kind == "qr")
        s = sites[0]
        assert s["pmax/model"] == mb and s["loss/model"] == mb, s
        assert s["entry/model"] == mb * entries, s
        assert s.get("grad_mean/data", 0) == int(data > 1), s
        assert s.get("norm/model", 0) == int(model > 1), s
        assert (s.get("fsdp_gather/data", 0) > 0) == (s.get("fsdp_scatter/data", 0) > 0)
        assert (s.get("fsdp_scatter/data", 0) > 0) == (data > 1), s
        assert s["combine/model"] >= mb * (1 + cfg.num_layers * blocks), s


def test_fp32_lookup_is_bitwise_the_single_card(meshed):
    """The meshed token embedding (the two-level GnR, K8's plain version on
    the routed Q shard, one combine) is bitwise the single card's lookup in
    fp32: every partial but the owner's and the first rank's is zero."""
    shape, cases, res = meshed
    for i, (name, mb) in enumerate(cases):
        cfg = R.config(name)
        params, _ = T.init_lm(cfg, seed=0, device="cpu")
        with torch.no_grad():
            want = T.embed_tokens(params, R.tokens(cfg), cfg)
        blocks = [r[i]["embedded"] for r in res if r[i]["coords"]["model"] == 0]
        assert torch.equal(torch.cat(blocks), want), (shape, name)
        for r in res:        # every model rank holds its data block's whole lookup
            d = r[i]["coords"]["data"]
            assert torch.equal(r[i]["embedded"], blocks[d])


def test_kv_projections_split_only_at_head_granularity(meshed):
    """qwen2's 2 kv heads split over a model axis of 2 and stay whole on 4
    (``repro``'s first fit would cut each head in half there); q heads,
    ``d_ff`` and the vocabulary split; every ``embed`` dim names ``data``
    (FSDP, ``repro``'s ``PARAM_RULES``; a ``data`` axis of one rank keeps
    the leaf whole), the norms' included."""
    shape, cases, res = meshed
    cfg = R.config("dense")
    params, _ = T.init_lm(cfg, seed=0, device="cpu")
    paths = [p for p, _ in tree.leaves_with_paths(params)]
    specs = dict(zip(paths, res[0][NAMES.index("dense")]["specs"]))
    model = shape[1]
    kv = "model" if model in (1, 2) else None
    assert specs["layers/attn/wk/w"] == (None, "data", kv)
    assert specs["layers/attn/wv/b"] == (None, kv)
    assert specs["layers/attn/wq/w"] == (None, "data", "model")
    assert specs["layers/attn/wo/w"] == (None, "model", "data")
    assert specs["layers/mlp/w_down/w"] == (None, "model", "data")
    assert specs["embed/table"] == ("model", "data")
    assert specs["layers/ln1/scale"] == (None, "data")
