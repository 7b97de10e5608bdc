"""EngineSpec — the declarative request half of plan/compile/execute (port of
``repro.engine.spec``).

``exec_backend`` is kept so that ``plan.summary()`` matches ``repro``'s.  The
port's dispatch does not read it: a CUDA tensor launches the kernel, a CPU
tensor takes the kernel's plain version.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.embedding_bag import BagConfig


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Declarative description of one embedding layer for the engine.

    * ``cache_slots`` / ``cache_slot_policy`` / ``cache_vmem_mb`` — the
      prefetch-cache budget (0 slots = no cache);
    * ``duplication`` / ``dup_budget_mb`` — run the replicate-vs-shard planner
      under a per-device byte budget;
    * ``packing`` — ``"auto"`` packs uniform bag sets into the one-launch
      layout, ``"off"`` forces the per-table path.
    """

    bags: tuple[BagConfig, ...]
    # prefetch-cache policy
    cache_slots: int = 0
    cache_slot_policy: str = "adaptive"     # adaptive | uniform
    cache_vmem_mb: int = 8
    # duplication policy
    duplication: bool = False
    dup_budget_mb: int = 64
    dup_budget_bytes: int | None = None     # byte-granular override of the MB knob
    # execution policy
    packing: str = "auto"                   # auto | off
    exec_backend: str = "auto"              # repro's backend name (summary only)

    def __post_init__(self):
        if not self.bags:
            raise ValueError("EngineSpec needs at least one bag")
        if self.packing not in ("auto", "off"):
            raise ValueError(f"unknown packing policy {self.packing!r}")
        if self.exec_backend not in ("auto", "kernel", "jnp"):
            raise ValueError(f"unknown exec backend {self.exec_backend!r}")
        if self.cache_slot_policy not in ("adaptive", "uniform"):
            raise ValueError(f"unknown slot policy {self.cache_slot_policy!r}")

    @property
    def num_tables(self) -> int:
        return len(self.bags)

    @property
    def kind(self) -> str:
        return self.bags[0].emb.kind

    def replace(self, **kw) -> "EngineSpec":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_bags(cls, bags, **kw) -> "EngineSpec":
        return cls(bags=tuple(bags), **kw)

    @classmethod
    def from_dlrm(cls, cfg, *, serving: bool = False, **kw) -> "EngineSpec":
        """Spec for a ``DLRMConfig``.  ``serving=True`` turns on the config's
        cache and duplication policies (the offline pass)."""
        from repro_torch.models import dlrm

        bags = tuple(dlrm.make_bags(cfg))
        if serving:
            kw.setdefault("cache_slots", cfg.cache_slots)
            kw.setdefault("cache_slot_policy", cfg.cache_slot_policy)
            kw.setdefault("cache_vmem_mb", cfg.cache_vmem_mb)
            kw.setdefault("duplication", True)
            kw.setdefault("dup_budget_mb", cfg.dup_budget_mb)
            kw.setdefault("exec_backend", "kernel")
        return cls(bags=bags, **kw)
