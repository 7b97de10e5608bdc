"""The tunable decisions of ``plan()`` as one dataclass (port of
``repro.tune.knobs``, minus the tuner's knob space).

``dim_block`` is ``repro``'s TPU lane tile.  The port keeps the field and
its default (``valid_dim_blocks`` / ``default_dim_block``) only so that
``plan.summary()`` matches ``repro``'s; no kernel of the port reads it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.cache import intra_gnr


def valid_dim_blocks(dim: int) -> tuple[int, ...]:
    """``repro``'s lane-tile ladder for ``dim`` (summary parity only)."""
    blocks = [bd for bd in (512, 256, 128) if bd <= dim and dim % bd == 0]
    if dim % 8 == 0 and dim not in blocks:
        blocks.append(dim)
    return tuple(blocks)


def default_dim_block(dim: int) -> int | None:
    blocks = valid_dim_blocks(dim)
    return blocks[0] if blocks else None


@dataclasses.dataclass(frozen=True)
class Knobs:
    """One setting of every tunable decision in the offline pass."""

    dim_block: int | None = None      # repro's TPU lane tile (summary only)
    cache_slots: int = 0              # per-table cache-slot allowance
    cache_slot_policy: str = "adaptive"   # adaptive (waterfill) | uniform
    dup_budget_bytes: int = 0         # duplication byte budget (0 = off)
    backend: str = "pertable"         # packed | pertable

    def describe(self) -> dict:
        """JSON-serializable form (plan summaries)."""
        return {
            "dim_block": self.dim_block,
            "cache_slots": int(self.cache_slots),
            "cache_slot_policy": self.cache_slot_policy,
            "dup_budget_bytes": int(self.dup_budget_bytes),
            "backend": self.backend,
        }


def spec_dup_budget_bytes(spec) -> int:
    """The spec's duplication budget in bytes (0 when duplication is off)."""
    if not spec.duplication:
        return 0
    if spec.dup_budget_bytes is not None:
        return int(spec.dup_budget_bytes)
    return int(spec.dup_budget_mb) * 2**20


def default_knobs(spec, *, packable: bool) -> Knobs:
    """The heuristic knob setting (``repro``'s zero-trace defaults)."""
    return Knobs(
        dim_block=default_dim_block(spec.bags[0].emb.dim),
        cache_slots=int(spec.cache_slots),
        cache_slot_policy=spec.cache_slot_policy,
        dup_budget_bytes=spec_dup_budget_bytes(spec),
        backend="packed" if (spec.packing == "auto" and packable) else "pertable",
    )


def slot_budgets(spec, knobs: Knobs, values: "list[np.ndarray] | None"
                 ) -> tuple[int, ...]:
    """Per-table cache-slot budgets under a knob setting and the cache-block
    ceiling ``spec.cache_vmem_mb``."""
    num_t = spec.num_tables
    if knobs.cache_slots <= 0:
        return tuple(0 for _ in range(num_t))
    emb = spec.bags[0].emb
    width = emb.tt_spec.g2_width if emb.kind == "tt" else emb.dim
    row_bytes = width * emb.param_dtype.itemsize
    block_slots = (spec.cache_vmem_mb * 2**20) // max(1, row_bytes)
    total = min(knobs.cache_slots * num_t, block_slots)
    if total <= 0:
        raise ValueError(
            f"cache_vmem_mb={spec.cache_vmem_mb} fits no cache row "
            f"(row_bytes={row_bytes}) but knobs.cache_slots="
            f"{knobs.cache_slots} asks for a cache; raise cache_vmem_mb or "
            f"set cache_slots=0"
        )
    if knobs.cache_slot_policy == "adaptive" and values is not None:
        budgets = intra_gnr.split_slot_budget(values, total)
    else:
        budgets = [min(knobs.cache_slots, total // num_t)] * num_t
    rows = [_big_rows_count(b.emb) for b in spec.bags]
    return tuple(max(1, min(b, r)) for b, r in zip(budgets, rows))


def _big_rows_count(emb) -> int:
    """Row count of the streamed big subtable (``plan.big_subtable``)."""
    if emb.kind == "qr":
        return emb.qr_spec.q_rows
    if emb.kind == "tt":
        return emb.tt_spec.v2
    return emb.physical_hashed_rows if emb.kind == "hashed" else emb.vocab
