"""The MoE transformers expert-parallel on gloo CPU ranks (no ``repro`` but
in the last test, which runs it in a child): the meshed step of
granite-moe-3b-a800m-smoke (dense vocabulary), qwen3-moe-235b-a22b-smoke
(QR ``twolevel``, collision 4) and granite-moe-smoke with 6 experts (split
over a ``model`` axis of 2, whole and padded to 8 on 4) on meshes (1, 2),
(2, 2) and (1, 4), at an ample capacity, against the single rank: every
gathered step-1 gradient (the router's included), the loss, the norm, the
new params and one MoE layer's output within 1e-5 of each leaf's scale.
Then ``repro``'s meshed ``apply_moe`` on a (2, 4) host mesh under a binding
capacity (each rank's capacity from its own tokens): the port's layer on
(2, 4) gloo ranks drops the same assignments, its output and gradients
within ``repro``'s bounds.  And ``repro``'s jitted meshed step-1 loss and
gradients of granite-moe-smoke on a (2, 2) host mesh (its params FSDP over
``data``) against the port's (2, 2) ranks in the training layout, FSDP over
``data`` too."""

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import torch_moe_mesh_ranks as MR
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.models import moe
from torch_lm_mesh_checks import SPAWN_S, _hold

MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
NAMES = list(MR.CASES)
_SINGLE: dict = {}


def _single(name: str) -> dict:
    if name not in _SINGLE:
        _SINGLE[name] = MR.single(name)
    return _SINGLE[name]


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


@pytest.fixture(scope="module", params=list(MESHES))
def ep(request, tmp_path_factory):
    shape = MESHES[request.param]
    return shape, _spawn(tmp_path_factory.mktemp(request.param), MR.ep_rank, shape, NAMES)


def test_meshed_moe_step_matches_the_single_rank(ep):
    shape, res = ep
    for name in NAMES:
        want = _single(name)
        for r in res:
            got = r[name]
            _hold(got["grads"], want["grads"], f"{shape} {name} gradient")
            _hold(got["params"], want["params"], f"{shape} {name} new params")
            _hold([got["layer"]], [want["layer"]], f"{shape} {name} MoE layer")
            for key in ("loss", "step_loss", "gnorm"):
                _hold([np.float32(got[key])], [np.float32(want[key])], f"{shape} {name} {key}")


def test_experts_split_over_model_and_the_router_stays_whole(ep):
    """The stacks split by ``experts`` where ``model`` divides them, else
    whole; never by ``expert_ffn``; their ``embed`` dim over ``data`` (FSDP;
    a ``data`` axis of one rank keeps it whole); the router whole; every
    rank issues the
    same collectives: one entry a layer for the MoE (x and the router in
    one all-reduce) beside the attention's, the head's and the QR lookup's
    R, and at least one combine a block and the token lookup's."""
    shape, res = ep
    model = shape[1]
    for name in NAMES:
        cfg = MR.config(name)
        split = "model" if cfg.num_experts % model == 0 else None
        specs = res[0][name]["specs"]
        assert specs["layers/moe/router"] == (None, None, None)
        for k in moe.STACKS:
            want = (None, split, None, "data") if k == "w_down" else (None, split, "data", None)
            assert specs[f"layers/moe/{k}"] == want, (name, k)
        sites = [r[name]["sites"] for r in res]
        assert all(s == sites[0] for s in sites), (name, sites)
        mesh = M.Mesh(shape={"data": shape[0], "model": model},
                      coords={"data": 0, "model": 0}, groups={}, device=torch.device("cpu"),
                      backend="gloo")
        attn = int(SH.head_split(cfg, mesh) is not None)
        qr = int(cfg.embedding_kind == "qr")
        assert sites[0]["entry/model"] == cfg.num_layers * (1 + attn) + 1 + qr, sites[0]
        assert sites[0]["combine/model"] >= cfg.num_layers * (1 + attn) + 1, sites[0]


def test_expert_split_and_blocks_of_a_padded_stack():
    """``expert_split`` follows divisibility; a rank's block of a stack the
    axis does not divide is its slice of the zero-padded stack."""
    cfg = MR.config("uneven")
    mesh = lambda m: M.Mesh(shape={"data": 1, "model": m}, coords={"data": 0, "model": 0},
                            groups={}, device=torch.device("cpu"), backend="gloo")
    assert SH.expert_split(cfg, mesh(2)) and SH.expert_split(cfg, mesh(3))
    assert not SH.expert_split(cfg, mesh(4)) and not SH.expert_split(cfg, None)
    assert moe.padded_experts(cfg, 4) == 8
    w = torch.arange(6.0).reshape(6, 1, 1)
    assert moe._block(w, 4, 2).flatten().tolist() == [4.0, 5.0]
    assert moe._block(w, 6, 2).flatten().tolist() == [0.0, 0.0]
    assert moe._block(w, 5, 2).flatten().tolist() == [5.0, 0.0]


REPRO_SHAPE = (2, 4)
BINDING = 1.0             # capacity factor: 4 slots an expert a rank for 16 tokens
# repro's meshed MoE layer (tests/test_moe.py::test_moe_ep_matches_single_device)
# at a binding capacity, jitted under DEFAULT_RULES on a (2, 4) host mesh;
# the single device's output and the meshed gradients of sum(out ** 2)
REPRO_CHILD = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.models import moe as moe_mod
from repro.distributed import sharding as SH
from repro.launch.mesh import make_mesh

cfg = ModelConfig(**__CFG__)
params, _ = moe_mod.init_moe(jax.random.PRNGKey(0), cfg)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, 32))
single = moe_mod.apply_moe(params, x, cfg)
mesh = make_mesh(__SHAPE__, ("data", "model"))
with SH.use_rules(mesh, SH.DEFAULT_RULES):
    ep = jax.jit(lambda p, v: moe_mod.apply_moe(p, v, cfg))(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, v: jnp.sum(moe_mod.apply_moe(p, v, cfg) ** 2),
                              argnums=(0, 1)))(params, x)
out = {k: np.asarray(v) for k, v in params.items()}
out.update({f"grad/{k}": np.asarray(v) for k, v in gp.items()})
np.savez(__PATH__, x=np.asarray(x), ep=np.asarray(ep), single=np.asarray(single),
         x_grad=np.asarray(gx), **out)
print("OK")
"""


def test_meshed_layer_drops_as_repros_mesh(mesh_runner, tmp_path):
    """A binding capacity: each rank sizes it from its 16 tokens (the single
    device from 32), so the mesh drops other assignments than the single
    device; the port's (2, 4) gloo ranks match ``repro``'s (2, 4) mesh, its
    output (rtol 2e-4 / atol 2e-5) and the gradients in x, the router and
    the stacks (rtol 1e-4 / atol 1e-5), and differ from the single device."""
    pytest.importorskip("jax")
    kw = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=4, kv_heads=2,
              d_ff=16, vocab=64, num_experts=8, top_k=2, capacity_factor=BINDING,
              compute_dtype="float32", param_dtype="float32")
    path = tmp_path / "repro_ep.npz"
    code = (REPRO_CHILD.replace("__CFG__", repr(kw)).replace("__SHAPE__", repr(REPRO_SHAPE))
            .replace("__PATH__", repr(str(path))))
    mesh_runner(code, n_devices=8, timeout=300)
    arrs = np.load(path)
    cfg = ModelConfig(**kw)
    res = _spawn(tmp_path, MR.repro_layer_rank, REPRO_SHAPE, str(path), cfg)
    assert res[0]["specs"] == {"router": (None, None), "w_down": ("model", None, None),
                               "w_gate": ("model", None, None), "w_up": ("model", None, None)}
    for r in res:
        np.testing.assert_allclose(r["out"], arrs["ep"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["x_grad"], arrs["x_grad"], rtol=1e-4, atol=1e-5)
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, arrs[f"grad/{k}"], rtol=1e-4, atol=1e-5, err_msg=k)
    assert float(np.abs(arrs["ep"] - arrs["single"]).max()) > 1e-3   # the capacity binds


def test_meshed_moe_step_matches_repros_fsdp_step(mesh_runner, tmp_path):
    """granite-moe-3b-a800m-smoke (dense vocabulary, fp32, ample capacity) on
    (2, 2): ``repro``'s jitted meshed loss on a host mesh (its params FSDP
    over ``data`` by ``PARAM_RULES``, XLA gathering them) and the port's
    gloo ranks in the training layout (each ``embed`` dim split over
    ``data``, gathered at its use; the router whole) from the same params
    and tokens: the loss to rtol 1e-5, the step-1 gradients, gathered, to
    rtol 1e-4 / atol 1e-5 (the layer check's bounds above)."""
    pytest.importorskip("jax")
    inputs, path = tmp_path / "inputs.npz", tmp_path / "repro_step.npz"
    MR.write_step_inputs(str(inputs))
    mesh_runner(MR.repro_step_child_code(inputs, path, (2, 2)), n_devices=4, timeout=300)
    ref = np.load(path)
    res = _spawn(tmp_path, MR.repro_step_rank, (2, 2), str(inputs))
    specs = res[0]["specs"]
    assert specs["layers/moe/router"] == (None, None, None)
    assert specs["layers/moe/w_up"] == (None, "model", "data", None)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(ref["loss"]), rtol=1e-5)
        assert len(r["grads"]) == len([k for k in ref.files if k.startswith("grad/")])
        for i, g in enumerate(r["grads"]):
            np.testing.assert_allclose(g, ref[f"grad/{i}"], rtol=1e-4, atol=1e-5,
                                       err_msg=f"gradient {i}")
