"""Rank body of the dry run's collectives test (``tests/test_torch_dryrun.py``).
No jax and no tests: every rank of ``repro_torch.launch.mesh.spawn`` imports
this module, not the test file that spawns it."""

from __future__ import annotations

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as SH
from repro_torch.launch.train import place
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step

ARCH = "qwen2-1.5b"
BATCH, SEQ = 4, 16


def step_sites(mesh) -> dict:
    """One smoke training step of ``ARCH`` on this gloo rank, as
    ``launch.train`` builds it (``OptConfig()``, the params placed by
    ``sharding.lm_param_rules``): the collectives it issued, ``{"site/axis":
    [calls, bytes]}``."""
    binding = registry.get(ARCH)
    cfg = binding.smoke
    params, axes = registry.init_fn(binding)(cfg, seed=0, device="cpu")
    local, specs, _ = place(params, axes, mesh, SH.lm_param_rules(cfg, mesh))
    batch = synthetic.data_block(synthetic.lm_batch(cfg, BATCH, SEQ, seed=0, step=0), mesh)
    step = make_train_step(registry.train_loss_fn(binding, cfg), opt.OptConfig(), mesh=mesh,
                           specs=specs)
    collectives.reset_counts()
    step(local, opt.init(local), batch)
    return {f"{site}/{axis}": list(v) for (site, axis), v in collectives.SITES.items()}
