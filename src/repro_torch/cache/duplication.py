"""Subtable duplication planner (port of ``repro.cache.duplication``).

ProactivePIM duplicates the weight-sharing subtables into every bank group
so a whole reconstruction completes where the big-table row lives.  The
planner decides, per subtable, replicate-on-every-shard vs row-shard, under
a per-device byte budget, by a greedy knapsack, highest traffic per byte
first: the whole small shared subtables (QR's R, TT's outer cores) first,
then big-table rows, hottest first across all tables.  Serving specs turn it on even on one
device (``EngineSpec.from_dlrm(serving=True)``), where it only reports.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core import hashing, placement

DEFAULT_BUDGET = 64 * 2**20


def _fold_quotient(counts: np.ndarray, collision: int, q_rows: int) -> np.ndarray:
    pad = (-counts.size) % collision
    folded = np.pad(counts, (0, pad)).reshape(-1, collision).sum(axis=1)
    if folded.size < q_rows:
        folded = np.pad(folded, (0, q_rows - folded.size))
    return folded[:q_rows]


@dataclasses.dataclass(frozen=True)
class SubtableDecision:
    """Replicate-vs-shard verdict for one subtable (or its hot slice)."""

    name: str                   # "r", "q", "g1", "g2", "g3", "table"
    rows: int                   # rows this decision covers
    bytes_per_replica: int
    replicated: bool
    request_share: float        # fraction of *observed* accesses served
    covers_all_rows: bool = True  # every row replicated (unseen indices too)


@dataclasses.dataclass(frozen=True)
class TableDupPlan:
    """Placement decision for one table's subtables."""

    kind: str                               # qr | tt | dense
    big: str                                # name of the row-sharded subtable
    decisions: tuple[SubtableDecision, ...]
    hot_plan: placement.TierPlan            # hot tier over big-table rows
    touches_per_lookup: int                 # subtable fetches one lookup makes
    cache_slots: int = 0                    # prefetch-cache slot budget (0 = unset)

    @property
    def replicated_bytes(self) -> int:
        return sum(d.bytes_per_replica for d in self.decisions if d.replicated)

    @property
    def comm_free(self) -> bool:
        """True when a lookup never leaves the device: every subtable
        replicated whole, unseen big-table rows included."""
        return all(d.replicated and d.covers_all_rows for d in self.decisions)

    @property
    def local_share(self) -> float:
        """Expected fraction of one lookup's subtable fetches served locally."""
        served = sum(d.request_share for d in self.decisions if d.replicated)
        return served / self.touches_per_lookup


@dataclasses.dataclass(frozen=True)
class DuplicationPlan:
    """Whole-model duplication decision + modeled communication effect."""

    tables: tuple[TableDupPlan, ...]
    num_shards: int
    budget_bytes: int

    @property
    def replicated_bytes(self) -> int:
        return sum(t.replicated_bytes for t in self.tables)

    @property
    def comm_free(self) -> bool:
        return all(t.comm_free for t in self.tables)

    def ici_bytes_per_batch(
        self, batch: int, dim: int, *, bytes_per_elem: int = 4
    ) -> dict:
        """Modeled cross-shard combine bytes for one serving batch.

        Baseline two-level GnR: one pooled vector per (sample, table) rides
        the cross-shard sum — ``(n-1)/n`` of it leaves the shard.
        Duplication removes the sum for comm-free tables entirely.
        """
        n = self.num_shards
        frac = (n - 1) / max(1, n)
        vec = dim * bytes_per_elem
        base = batch * len(self.tables) * vec * frac
        dup = batch * sum(1 for t in self.tables if not t.comm_free) * vec * frac
        return {"baseline": base, "duplicated": dup, "saved": base - dup}


def _table_candidates(bag, counts: np.ndarray, bytes_per_elem: int):
    """-> (small candidates [(name, rows, bytes)], big name, folded counts,
    big row bytes, big total rows, touches per lookup)."""
    emb = bag.emb
    if emb.kind == "qr":
        spec = emb.qr_spec
        rb = emb.dim * bytes_per_elem
        smalls = [("r", spec.r_rows, spec.r_rows * rb)]
        folded = _fold_quotient(counts, emb.collision, spec.q_rows)
        return smalls, "q", folded, rb, spec.q_rows, 2
    if emb.kind == "tt":
        spec = emb.tt_spec
        smalls = [
            ("g1", spec.v1, spec.v1 * spec.g1_width * bytes_per_elem),
            ("g3", spec.v3, spec.v3 * spec.g3_width * bytes_per_elem),
        ]
        folded = placement.fold_counts_tt(counts, spec)
        return smalls, "g2", folded, spec.g2_width * bytes_per_elem, spec.v2, 3
    rb = emb.dim * bytes_per_elem
    if emb.kind == "hashed":
        # fold logical counts onto physical rows through the k-ary hash
        rows = emb.physical_hashed_rows
        hs = hashing.k_ary_hash(np.arange(counts.size), rows, emb.hashed_k)  # (vocab, k)
        folded = np.bincount(
            hs.reshape(-1), weights=np.repeat(counts, emb.hashed_k), minlength=rows,
        ).astype(np.int64)
        return [], "table", folded, rb, rows, emb.hashed_k
    rows = emb.vocab
    c = np.asarray(counts, dtype=np.int64)
    if c.size < rows:
        c = np.pad(c, (0, rows - c.size))
    return [], "table", c[:rows], rb, rows, 1


def plan_duplication(
    bags: Sequence,
    counts_per_table: Sequence[np.ndarray],
    *,
    num_shards: int = 1,
    budget_bytes: int = DEFAULT_BUDGET,
    bytes_per_elem: int = 4,
    slot_budgets: Sequence[int] | None = None,
) -> DuplicationPlan:
    """Choose replicated vs row-sharded subtables under a per-device budget.

    ``counts_per_table``: logical-row access profiles, one per bag; folding
    onto physical subtable rows happens here.  ``slot_budgets`` (optional)
    records the prefetch-cache slot split on the plan.
    """
    infos = [
        _table_candidates(bag, np.asarray(cnt, dtype=np.int64), bytes_per_elem)
        for bag, cnt in zip(bags, counts_per_table)
    ]

    budget = budget_bytes
    small_decisions: list[list[SubtableDecision]] = []
    # Phase 1: whole shared subtables, cheapest (highest traffic/byte) first.
    order = sorted(
        ((b, t, i) for t, (smalls, *_rest) in enumerate(infos)
         for i, (_n, _r, b) in enumerate(smalls)),
    )
    chosen: set[tuple[int, int]] = set()
    for b, t, i in order:
        if b <= budget:
            budget -= b
            chosen.add((t, i))
    for t, (smalls, *_rest) in enumerate(infos):
        small_decisions.append([
            SubtableDecision(
                name=n, rows=r, bytes_per_replica=b,
                replicated=(t, i) in chosen, request_share=1.0,
            )
            for i, (n, r, b) in enumerate(smalls)
        ])

    # Phase 2: big-table rows, hottest first across all tables.  A row is
    # taken when its bytes fit the remaining budget; once the budget is
    # below the narrowest row nothing more can fit, so the scan stops there
    # (repro scans on to the end and takes nothing more: the same plan).
    row_tables, row_counts = [], []
    for t, (_s, _big, folded, rb, rows, _tpl) in enumerate(infos):
        row_tables.append(np.full(rows, t, dtype=np.int64))
        row_counts.append(folded / rb)             # traffic density per byte
    all_t = np.concatenate(row_tables) if row_tables else np.empty(0, np.int64)
    all_v = np.concatenate(row_counts) if row_counts else np.empty(0)
    order2 = np.argsort(-all_v, kind="stable")
    num_hot = [0] * len(infos)
    widths = {info[3] for info in infos}
    if len(widths) == 1:
        # one row width (every packable set): the scan below takes exactly
        # the first budget // width rows of the order, so count them at once
        # (scanning 26M dense rows in Python under a budget that fits them
        # all takes ~15 s)
        rb = widths.pop()
        taken = order2[:min(order2.size, budget // rb)]
        num_hot = np.bincount(all_t[taken], minlength=len(infos)).tolist()
        budget -= taken.size * rb
    else:
        min_rb = min((info[3] for info in infos), default=0)
        for j in order2:
            if budget < min_rb:
                break
            t = int(all_t[j])
            rb = infos[t][3]
            if rb <= budget:
                budget -= rb
                num_hot[t] += 1

    tables = []
    for t, (smalls, big, folded, rb, rows, touches) in enumerate(infos):
        hot = _top_rows_plan(folded, num_hot[t])
        decs = list(small_decisions[t])
        decs.append(
            SubtableDecision(
                name=big, rows=hot.num_hot, bytes_per_replica=hot.num_hot * rb,
                replicated=hot.num_hot > 0,
                request_share=1.0 if hot.num_hot >= rows else hot.expected_hot_hit,
                covers_all_rows=hot.num_hot >= rows,
            )
        )
        tables.append(
            TableDupPlan(
                kind=bags[t].emb.kind, big=big, decisions=tuple(decs),
                hot_plan=hot, touches_per_lookup=touches,
                cache_slots=0 if slot_budgets is None else int(slot_budgets[t]),
            )
        )
    return DuplicationPlan(
        tables=tuple(tables), num_shards=num_shards, budget_bytes=budget_bytes
    )


def _top_rows_plan(counts: np.ndarray, num_hot: int) -> placement.TierPlan:
    """TierPlan replicating exactly the ``num_hot`` hottest rows."""
    counts = np.asarray(counts, dtype=np.int64)
    order = np.argsort(-counts, kind="stable")
    hot_rows = np.sort(order[:num_hot])
    hot_slot = np.full(counts.size, -1, dtype=np.int32)
    hot_slot[hot_rows] = np.arange(hot_rows.size, dtype=np.int32)
    total = max(1, int(counts.sum()))
    return placement.TierPlan(
        hot_rows=hot_rows,
        hot_slot=hot_slot,
        hot_fraction=hot_rows.size / max(1, counts.size),
        expected_hot_hit=float(counts[hot_rows].sum() / total),
    )
