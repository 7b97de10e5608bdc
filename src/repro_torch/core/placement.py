"""Hot-tier planning over access profiles (port of the numpy part of
``repro.core.placement`` that the duplication planner needs; ``plan_tt_tiers``
waits for the sharded slice)."""

from __future__ import annotations

import dataclasses

import numpy as np


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


def fold_counts_tt(counts_logical: np.ndarray, spec) -> np.ndarray:
    """Fold a logical-row access profile onto middle-core (i2) rows:
    ``i2 = (idx // v3) % v2``, so each middle row serves ``v1 * v3`` logical
    rows."""
    counts_logical = np.asarray(counts_logical, dtype=np.int64)
    idx = np.arange(counts_logical.size, dtype=np.int64)
    i2 = (idx // spec.v3) % spec.v2
    return np.bincount(i2, weights=counts_logical, minlength=spec.v2).astype(np.int64)
