"""The port's LM registry and configs against ``repro``'s (mirrors
``tests/test_registry.py``), ``synthetic.lm_batch``, and the DLRM side's
loose names ported with them: ``configs.base.MeshConfig``,
``kernels.ops.tt_pooled`` and ``kernels.ref.tt_row_ref``.

Every ``CONFIG`` and ``SMOKE`` of the ten arch modules equals ``repro``'s
field by field (dtypes by name).  Every arch has a model: the
transformers, dense and MoE, zamba2, xlstm and the prefix models (whisper,
pixtral), whose bindings (init, loss, batch and serve family) work here.
The TT entries are held to ``repro``'s: fp32 to 1e-5 (two fp32 contraction
orders).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import tt_gather  # noqa: E402
from repro_torch.train import serve_step  # noqa: E402
from torch_tt_inputs import tt_args, tt_inputs  # noqa: E402

DENSE = ("qwen2-1.5b", "granite-34b", "chatglm3-6b", "minitron-4b")
MOE = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b")
SUB_QUADRATIC = ("zamba2-7b", "xlstm-125m")
PREFIX = ("whisper-large-v3", "pixtral-12b")
PORTED = DENSE + MOE + SUB_QUADRATIC + PREFIX


def test_ten_archs_present():
    assert len(registry.ARCHS) == 10
    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    for arch, b in registry.ARCHS.items():
        jb = jregistry.ARCHS[arch]
        assert (b.module, b.kind, b.sub_quadratic, b.has_decode) == (
            jb.module, jb.kind, jb.sub_quadratic, jb.has_decode)


def test_grid_is_40_cells():
    cells = list(registry.cells(include_skipped=True))
    assert len(cells) == 40
    assert len([c for c in cells if c[2] == "run"]) == 32
    want = [(b.arch_id, s.name, st) for b, s, st in jregistry.cells(include_skipped=True)]
    assert [(b.arch_id, s.name, st) for b, s, st in cells] == want


def test_skip_reasons():
    long = [s for s in tbase.LM_SHAPES if s.name == "long_500k"][0]
    assert "sub-quadratic" in registry.shape_status(registry.get("qwen2-1.5b"), long)
    assert registry.shape_status(registry.get("zamba2-7b"), long) == "run"
    assert registry.shape_status(registry.get("xlstm-125m"), long) == "run"
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get("gpt-5")


def test_lm_shapes_equal_repro():
    assert [dataclasses.astuple(s) for s in tbase.LM_SHAPES] == [
        dataclasses.astuple(s) for s in jbase.LM_SHAPES]


def test_assigned_config_numbers():
    c = registry.get("qwen2-1.5b").config
    assert (c.num_layers, c.d_model, c.num_heads, c.kv_heads, c.d_ff, c.vocab) == (
        28, 1536, 12, 2, 8960, 151936)
    c = registry.get("granite-34b").config
    assert (c.num_layers, c.d_model, c.num_heads, c.kv_heads, c.d_ff, c.vocab) == (
        88, 6144, 48, 1, 24576, 49152)
    c = registry.get("qwen3-moe-235b-a22b").config
    assert (c.num_layers, c.num_experts, c.top_k, c.vocab) == (94, 128, 8, 151936)
    c = registry.get("zamba2-7b").config
    assert (c.num_layers, c.d_model, c.ssm_state) == (81, 3584, 64)
    assert registry.get("minitron-4b").config.vocab == 256000
    c = registry.get("granite-moe-3b-a800m").config
    assert (c.num_experts, c.top_k, c.d_ff) == (40, 8, 512)
    c = registry.get("xlstm-125m").config
    assert (c.num_layers, c.d_model, c.d_ff) == (12, 768, 0)
    c = registry.get("whisper-large-v3").config
    assert (c.enc_layers, c.dec_layers, c.d_model, c.vocab) == (32, 32, 1280, 51866)
    c = registry.get("pixtral-12b").config
    assert (c.num_layers, c.d_model, c.kv_heads, c.vocab) == (40, 5120, 8, 131072)
    c = registry.get("chatglm3-6b").config
    assert (c.d_ff, c.vocab, c.partial_rotary) == (13696, 65024, 0.5)


@pytest.mark.parametrize("which", ["config", "smoke"])
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_configs_equal_repro_field_by_field(arch, which):
    got = getattr(registry.get(arch), which)
    want = getattr(jregistry.get(arch), which)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.head_dim_ == want.head_dim_
    assert str(got.pdtype).replace("torch.", "") == jnp.dtype(want.pdtype).name
    assert str(got.cdtype).replace("torch.", "") == jnp.dtype(want.cdtype).name
    ge, we = got.emb_config, want.emb_config
    for f in dataclasses.fields(we):
        if f.name not in ("param_dtype", "compute_dtype"):
            assert getattr(ge, f.name) == getattr(we, f.name), f.name
    assert ge.param_count() == we.param_count()
    assert got.replace(num_layers=3).num_layers == 3


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_unported_archs_raise_naming_their_roadmap_item(arch):
    """No arch is refused any more: every binding (init, batch, serve
    family, its cache) works, and nothing of the port's registry or serve
    step names a ``ROADMAP.md`` item that brings a model."""
    import inspect

    b = registry.get(arch)
    assert arch in PORTED
    for mod in (registry, serve_step):
        assert "item 5" not in inspect.getsource(mod)
    assert not hasattr(registry, "NOT_PORTED") and not hasattr(registry, "ported")
    params, _ = registry.init_fn(b)(b.smoke, seed=0, device="cpu")
    batch = registry.make_batch_fn(b, b.smoke)(2, 5, seed=1, step=2)
    assert batch["tokens"].shape == (2, 5)
    fam = serve_step.serve_family(b.kind)
    assert fam.prefill is not None and fam.decode is not None
    assert fam.make_cache(b.smoke, 2, 8, device="cpu") is not None
    if arch in MOE:              # an MoE layer where the dense ones have an MLP
        assert "mlp" not in params["layers"]
        assert params["layers"]["moe"]["w_up"].shape[:2] == (b.smoke.num_layers,
                                                              b.smoke.num_experts)
    if arch in SUB_QUADRATIC:        # their own model, cache and serve family
        assert ("mamba" in params) == (arch == "zamba2-7b")
        assert ("blocks" in params) == (arch == "xlstm-125m")
    if arch in PREFIX:               # the prefix rides in the batch
        key = "frames" if b.kind == "whisper" else "patches"
        assert set(batch) == {key, "tokens"} and batch[key].dtype == torch.float32
        assert ("enc" in params) == (b.kind == "whisper")
        with torch.inference_mode():
            lg, cache = fam.prefill(params, batch, b.smoke, 8)
        assert lg.shape == (2, 1, b.smoke.vocab)
        assert cache["k"].shape[2] == 8 + b.smoke.num_patches


def test_waiting_entry_points_raise():
    """``train_loss_fn`` gives the causal LM loss for every arch (the prefix
    models' behind their frames or patches); the dry run's entry points
    give meta tensors, nothing allocated."""
    import math

    for arch in PORTED:
        b = registry.get(arch)
        params, _ = registry.init_fn(b)(b.smoke, seed=0, device="cpu")
        batch = registry.make_batch_fn(b, b.smoke)(2, 6, seed=1, step=0)
        loss, metrics = registry.train_loss_fn(b, b.smoke)(params, batch)
        assert loss.shape == () and metrics["loss"] is loss
        assert abs(float(loss) - math.log(b.smoke.vocab)) < 2.0
    assert set(PORTED) == set(registry.ARCHS)
    b = registry.get("qwen2-1.5b")                                  # the dry run's
    params, axes = registry.abstract_params(b, b.config)
    leaves = tree.leaves(params) + tree.leaves(registry.batch_specs(b, b.config, 2, 6)) + \
        tree.leaves(registry.cache_specs(b, b.config, 2, 6))
    assert leaves and all(t.device.type == "meta" for t in leaves)
    assert sorted(axes) == sorted(params)


def test_lm_batch_is_a_pure_function_of_seed_and_step():
    cfg = registry.get("qwen2-1.5b").smoke
    a = synthetic.lm_batch(cfg, 3, 17, seed=4, step=2)["tokens"]
    assert a.dtype == torch.int32 and a.shape == (3, 17)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab
    assert torch.equal(a, synthetic.lm_batch(cfg, 3, 17, seed=4, step=2)["tokens"])
    assert not torch.equal(a, synthetic.lm_batch(cfg, 3, 17, seed=4, step=3)["tokens"])
    # uniform over the vocabulary, as repro's: bin counts spread as Poisson's
    big = synthetic.lm_batch(cfg, 64, 512, seed=0, step=0)["tokens"]
    counts = torch.bincount(big.reshape(-1).long(), minlength=cfg.vocab).double()
    assert counts.numel() == cfg.vocab
    assert float(counts.std()) < 1.25 * float(counts.mean()) ** 0.5


def test_mesh_config_matches_repro():
    for kw in ({}, {"shape": (2, 4), "axes": ("data", "model")}, {"shape": (8,),
                                                                  "axes": ("model",)}):
        got, want = tbase.MeshConfig(**kw), jbase.MeshConfig(**kw)
        assert (got.shape, got.axes, got.num_devices) == (want.shape, want.axes,
                                                           want.num_devices)


def test_tt_row_ref_matches_repro():
    a = tt_inputs(seed=3)
    rng = np.random.default_rng(4)
    idx = {n: rng.integers(0, a[n.replace("i", "g")].shape[0], (7, 3)).astype(np.int32)
           for n in ("i1", "i2", "i3")}
    args = [a["g1"], a["g2"], a["g3"], idx["i1"], idx["i2"], idx["i3"]]
    want = jref.tt_row_ref(*(jnp.asarray(x) for x in args), dims=(4, 4, 2, 4))
    got = ref.tt_row_ref(*(torch.from_numpy(x) for x in args), dims=(4, 4, 2, 4))
    assert got.shape == (7, 3, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dims", [(4, 4, 2, 4), (3, 1, 1, 2)])
def test_tt_pooled_matches_repro(dims, monkeypatch):
    """``tt_pooled`` against ``repro``'s (its kernel in interpret mode, or
    its jnp reference for a dim with no 8-wide tile, 3 here): the port calls
    K5 for every dim."""
    a = tt_inputs(dims=dims, seed=5)
    want = jops.tt_pooled(*tt_args(a, jnp.asarray), dims=dims, interpret=True)
    calls = []
    monkeypatch.setattr(tt_gather, "tt_bag",
                        lambda *x, **kw: calls.append(1) or ref.tt_bag_ref(*x, **kw))
    got = ops.tt_pooled(*tt_args(a, torch.from_numpy), dims=dims)
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
