"""FSDP over ``data`` for LM training on a mesh, and K9's bf16 probability
tile, on the CPU.

The training layout (``sharding.lm_param_rules``, ``repro``'s
``PARAM_RULES``) stores every leaf's ``embed`` dim split over ``data``
where ``data`` divides it, and the serving layout keeps it whole, for every
LM arch (the MoE router stays whole: ``WHOLE``).  qwen2-1.5b-smoke (fp32,
QR ``twolevel``) on gloo ranks, (2, 1) and (2, 2): the step-1 gradients,
two steps' losses and new params within 1e-5 of each leaf's scale of the
single card's (``torch_lm_mesh_checks._hold``, the meshed bound: the ranks
sum their partials and the data blocks' gradients in another order), the
losses equal on every rank, each rank's params and AdamW moments half
along ``embed``.  A checkpoint saved on (2, 2) (the full logical arrays)
resumes on one card and on (4, 1) to the params of a (2, 2) run that never
stopped, to the same bound.

``flash_block_dtype="bf16"``: the port's qwen2-1.5b-smoke forward in fp32
compute (K9's ``p_bf16``, on the CPU its plain version, the blockwise
attention with bf16 probabilities) gives ``repro``'s forward logits (its
``_attn_block`` with ``p_dtype=bf16``) to rtol / atol 1e-5."""

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401

import torch_fsdp_ranks as FR
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch.train import place
from repro_torch.train import optimizer as opt
from torch_lm_mesh_checks import SPAWN_S, _hold

MESHES = {"2x1": (2, 1), "2x2": (2, 2)}


def _spawn(tmp_path, fn, shape, *args):
    return M.spawn(fn, shape, axes=("data", "model"), args=args, device="cpu",
                   backend="gloo", init_file=tmp_path / "rdv", timeout_s=SPAWN_S)


def _logical(tree_, axes) -> list:
    """Each leaf's logical axes (flatten order), as ``tree_specs`` walks
    them; None where ``axes`` does not describe the leaf."""
    out = []

    def walk(t, a):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], a.get(k) if isinstance(a, dict) else None)
        elif isinstance(t, (list, tuple)):
            for i, x in enumerate(t):
                walk(x, a[i] if isinstance(a, (list, tuple)) and i < len(a) else None)
        elif t is not None:
            out.append(a)

    walk(tree_, axes)
    return out


def _names_data(spec) -> bool:
    return any(e == "data" or (isinstance(e, tuple) and "data" in e) for e in spec)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_training_layout_splits_embed_over_data_and_serving_keeps_it_whole(arch):
    binding = registry.get(arch)
    cfg = binding.smoke
    mesh = M.abstract_mesh((2, 2), ("data", "model"), (0, 0))
    params, axes = registry.abstract_params(binding, cfg)
    local, specs, state_specs = place(params, registry.lm_axes(cfg, axes, mesh), mesh,
                                      SH.lm_param_rules(cfg, mesh))
    state = {"params": params, "opt": opt.init(params)}
    logical = _logical(state, {"params": axes, "opt": opt.opt_axes(axes)})
    assert len(logical) == len(state_specs) == len(tree.leaves(state))
    whole = [tuple(w) for w in SH.lm_param_rules(cfg, mesh).get(SH.WHOLE, ())]
    checked = 0
    for (path, leaf), log, spec in zip(tree.leaves_with_paths(state), logical, state_specs):
        if log is None or leaf.dim() == 0:
            assert not _names_data(spec), path
            continue
        router = any(tuple(log[len(log) - len(w):]) == w for w in whole)
        divisible = any(a == "embed" and n % 2 == 0 for a, n in zip(log, leaf.shape))
        assert _names_data(spec) == (divisible and not router), (path, log, spec)
        checked += divisible and not router
    assert checked > 0
    for spec in registry.lm_specs(cfg, params, axes, mesh, serve=True):
        assert not _names_data(spec), spec
    # the serving draw on the abstract mesh keeps ``embed`` whole
    served, _ = registry.abstract_params(binding, cfg, mesh=mesh)
    for a, b, spec in zip(tree.leaves(served), tree.leaves(params),
                          registry.lm_specs(cfg, params, axes, mesh, serve=True)):
        assert tuple(a.shape) == tuple(SH.local_shard(b, mesh, spec).shape)


@pytest.fixture(scope="module")
def single():
    return FR.single_two_steps()


@pytest.mark.parametrize("shape", list(MESHES.values()), ids=list(MESHES))
def test_fsdp_steps_match_the_single_card(single, shape, tmp_path):
    res = _spawn(tmp_path, FR.two_steps, shape)
    for r in res:
        _hold(r["grads"], single["grads"], f"{shape} step-1 gradient")
        _hold(r["params"], single["params"], f"{shape} params after two steps")
        _hold([np.float32(x) for x in r["losses"]], [np.float32(x) for x in single["losses"]],
              f"{shape} losses")
    assert all(r["losses"] == res[0]["losses"] and r["loss"] == res[0]["loss"] for r in res)
    cfg = FR.config()
    params, axes = registry.init_fn(registry.get("qwen2-1.5b"))(cfg, seed=0, device="meta")
    halved = 0
    for log, local, moment, full in zip(_logical(params, axes), res[0]["local"],
                                        res[0]["moments"], res[0]["full"]):
        assert local == moment
        for d, a in enumerate(log):
            if a == "embed" and full[d] % 2 == 0:
                assert local[d] == full[d] // 2, (log, local, full)
                halved += 1
                break
    assert halved > 0


def test_fsdp_blocks_gather_back_to_the_logical_leaves(tmp_path):
    assert all(_spawn(tmp_path, FR.local_blocks_hold, (2, 2)))


def test_a_checkpoint_of_2x2_resumes_on_one_card_and_on_4x1(tmp_path):
    saved = tmp_path / "saved"
    for sub in "abc":
        (tmp_path / sub).mkdir()
    _spawn(tmp_path / "a", FR.run_until, (2, 2), str(saved), 2, True)
    never = _spawn(tmp_path / "b", FR.run_until, (2, 2), str(tmp_path / "none"), FR.STEPS)[0]
    assert never["start"] == 0 and never["opt_step"] == FR.STEPS
    one = FR.run_until(None, str(saved), FR.STEPS)
    four = _spawn(tmp_path / "c", FR.run_until, (4, 1), str(saved), FR.STEPS)
    for got, what in [(one, "one card")] + [(r, "(4, 1)") for r in four]:
        assert got["start"] == 2 and got["opt_step"] == FR.STEPS, what
        _hold(got["params"], never["params"], f"{what} resumed from (2, 2)")
        _hold([np.float32(x) for x in got["losses"]],
              [np.float32(x) for x in never["losses"][2:]], f"{what} losses")


def test_bf16_probability_tile_matches_repros_forward():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.models import transformer as jT
    from repro_torch.models import transformer as T
    from torch_lm_inputs import lm_pair, tokens

    jcfg, tcfg, jp, tp = lm_pair("qwen2-1.5b", "qr", flash_block_dtype="bf16")
    toks = tokens(tcfg.vocab, 2, 16)
    with torch.inference_mode():
        got = T.forward_train(tp, torch.from_numpy(toks), tcfg)
        f32 = T.forward_train(tp, torch.from_numpy(toks), tcfg.replace(flash_block_dtype="f32"))
    want = np.asarray(jT.forward_train(jp, jnp.asarray(toks), jcfg))
    assert jax.default_backend() == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert not torch.equal(got, f32)              # the tile moves the logits


def test_data_mean_needs_a_spec_a_leaf():
    """Which gradients came reduce-scattered over ``data`` is read from the
    specs, so ``data_mean`` on a mesh that splits the batch refuses to run
    without one spec a leaf (all-reducing an FSDP gradient again would sum
    it twice); where the batch is not split there is nothing to average."""
    from repro_torch.train import train_step as ts

    grads, loss = {"w": torch.ones(4, 2)}, torch.tensor(1.0)
    mesh = M.abstract_mesh((2, 1), ("data", "model"), (0, 0))
    for specs in (None, []):
        with pytest.raises(ValueError, match="one spec a gradient leaf"):
            ts.data_mean(grads, loss, mesh, specs)
    one = M.abstract_mesh((1, 2), ("data", "model"), (0, 0))
    assert ts.data_mean(grads, loss, one, None) == (grads, loss)
