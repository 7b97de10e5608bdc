"""Hot-tier planning over access profiles (port of ``repro.core.placement``):
the hot (replicated) row set of a table, its split from the cold rows, the
TT-aware tier plan, and the paper's hot-vector reduction curve."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """Placement decision for one table."""

    hot_rows: np.ndarray        # row ids in the replicated tier
    hot_slot: np.ndarray        # (rows,) int32: slot in hot table, -1 if cold
    hot_fraction: float         # fraction of rows replicated
    expected_hot_hit: float     # fraction of *requests* served by the hot tier

    @property
    def num_hot(self) -> int:
        return int(self.hot_rows.size)


def profile_counts(q_indices: np.ndarray, q_rows: int) -> np.ndarray:
    """Access-frequency profile from a trace of row indices."""
    return np.bincount(np.asarray(q_indices).reshape(-1), minlength=q_rows)


def bandwidth_balanced_fraction(
    *,
    counts: np.ndarray,
    hbm_gbps: float = 819.0,
    ici_gbps_per_link: float = 50.0,
    ici_links: int = 4,
    safety: float = 1.0,
) -> float:
    """The replicated-tier request share that balances local-memory service
    against the cross-shard combine (``repro``'s balance rule; the default
    rates are ``repro``'s, kept so both packages pick the same share)."""
    ici = ici_gbps_per_link * ici_links
    target_cold_share = min(1.0, (ici / hbm_gbps) * safety)
    return float(np.clip(1.0 - target_cold_share, 0.0, 0.999))


def plan_tiers(
    counts: np.ndarray,
    *,
    request_share: float | None = None,
    hot_fraction: float | None = None,
    max_hot_rows: int | None = None,
) -> TierPlan:
    """Choose the hot (replicated) row set from an access profile."""
    counts = np.asarray(counts, dtype=np.int64)
    q_rows = counts.size
    order = np.argsort(-counts, kind="stable")
    total = max(1, counts.sum())
    if hot_fraction is not None:
        num_hot = int(round(hot_fraction * q_rows))
    else:
        share = 0.8 if request_share is None else request_share
        cum = np.cumsum(counts[order]) / total
        num_hot = int(np.searchsorted(cum, share) + 1) if share > 0 else 0
        num_hot = min(num_hot, q_rows)
    if max_hot_rows is not None:
        num_hot = min(num_hot, max_hot_rows)
    hot_rows = np.sort(order[:num_hot])
    hot_slot = np.full((q_rows,), -1, dtype=np.int32)
    hot_slot[hot_rows] = np.arange(num_hot, dtype=np.int32)
    hit = float(counts[hot_rows].sum() / total)
    return TierPlan(
        hot_rows=hot_rows,
        hot_slot=hot_slot,
        hot_fraction=num_hot / max(1, q_rows),
        expected_hot_hit=hit,
    )


def split_table(table: torch.Tensor, plan: TierPlan) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a Q table into (hot_table, cold_table_with_zeroed_hot_rows).

    The cold table keeps full shape (contiguous row-sharding and checkpoint
    layout stay as they are); hot rows are zeroed there so hot + cold
    lookups never double-count."""
    hot = table[torch.as_tensor(plan.hot_rows, dtype=torch.long, device=table.device)]
    mask = torch.as_tensor(plan.hot_slot < 0, device=table.device).to(table.dtype)[:, None]
    return hot, table * mask


# ---------------------------------------------------------------------------
# TT-Rec tiered placement (the paper's bg-PIM SRAM cache + subtable duplication)
# ---------------------------------------------------------------------------

# Default per-core SRAM budget of the outer-core pin (repro's figure, a few
# hundred KB, the paper's bg-PIM cache size class).
DEFAULT_SRAM_BUDGET = 512 * 1024


@dataclasses.dataclass(frozen=True)
class TTTierPlan:
    """Placement decision for one TT table.

    The outer cores (G1/G3) are duplicated whole into every bank group's SRAM
    (replication across ranks): every lookup touches them, so duplication
    removes both their memory traffic and their share of the combine.  The
    middle core is the "big table": its rows are row-sharded, and the hottest
    rows (by i2 request skew) are replicated as the hot tier, the Q-table
    treatment of the QR path.
    """

    mid_plan: TierPlan          # hot tier over middle-core (i2) rows
    sram_bytes: int             # G1 + G3 pinned footprint per replica
    sram_budget: int            # budget the pin was checked against
    duplication: int            # replicas of the outer cores ("bank groups")

    @property
    def sram_fits(self) -> bool:
        return self.sram_bytes <= self.sram_budget

    @property
    def num_hot(self) -> int:
        return self.mid_plan.num_hot


def fold_counts_tt(counts_logical: np.ndarray, spec) -> np.ndarray:
    """Fold a logical-row access profile onto middle-core (i2) rows:
    ``i2 = (idx // v3) % v2``, so each middle row serves ``v1 * v3`` logical
    rows."""
    counts_logical = np.asarray(counts_logical, dtype=np.int64)
    idx = np.arange(counts_logical.size, dtype=np.int64)
    i2 = (idx // spec.v3) % spec.v2
    return np.bincount(i2, weights=counts_logical, minlength=spec.v2).astype(np.int64)


def plan_tt_tiers(
    counts_logical: np.ndarray,
    spec,
    *,
    request_share: float | None = None,
    hot_fraction: float | None = None,
    max_hot_rows: int | None = None,
    sram_budget: int = DEFAULT_SRAM_BUDGET,
    bytes_per_elem: int = 4,
    duplication: int = 1,
) -> TTTierPlan:
    """TT-aware tier plan from a logical access profile: the outer cores'
    pin checked against ``sram_budget``, the middle core hot-tiered by its
    folded i2 skew; ``duplication`` is the replica count of the pinned
    cores."""
    folded = fold_counts_tt(counts_logical, spec)
    mid = plan_tiers(folded, request_share=request_share, hot_fraction=hot_fraction,
                     max_hot_rows=max_hot_rows)
    return TTTierPlan(mid_plan=mid, sram_bytes=spec.sram_bytes(bytes_per_elem),
                      sram_budget=sram_budget, duplication=duplication)


def hot_vector_reduction_curve(
    counts_logical: np.ndarray, collisions: list[int], request_share: float = 0.8
) -> dict[int, int]:
    """The paper's shortcoming analysis: hot vectors against the hash
    collision value.  Quotient hashing folds ``c`` consecutive logical rows
    into one Q row; hot logical rows stay hot but rarely cluster, so the
    hot-row count shrinks sub-linearly in ``c``.  Returns {collision:
    num_hot_rows}."""
    counts_logical = np.asarray(counts_logical, dtype=np.int64)
    out: dict[int, int] = {}
    for c in collisions:
        pad = (-counts_logical.size) % c
        folded = np.pad(counts_logical, (0, pad)).reshape(-1, c).sum(axis=1)
        out[c] = plan_tiers(folded, request_share=request_share).num_hot
    return out
