"""plan() — the offline half of the engine: analyze, budget, place, pack
(port of ``repro.engine.plan``).

``plan(spec, trace=..., mesh=...)`` runs the intra-GnR locality analyzer, the
cache-slot waterfill, the duplication planner and the packed-layout build
once and freezes the result into an ``EmbeddingPlan``.  Every tunable
decision is a ``tune.Knobs`` frozen into the plan: an explicit ``knobs=``,
a fitted tuner's argmin (``tuner=``), or the heuristic defaults.  All
host-side numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.cache import duplication, intra_gnr
from repro_torch.cache.sram_cache import PrefetchScheduler
from repro_torch.core import packed_tables, placement
from repro_torch.engine.spec import EngineSpec
from repro_torch.tune.knobs import Knobs, default_knobs, slot_budgets as _knob_budgets


def big_subtable(emb) -> tuple[str, int]:
    """(name, rows) of the streamed big subtable the cache covers."""
    if emb.kind == "qr":
        return "q", emb.qr_spec.q_rows
    if emb.kind == "tt":
        return "g2", emb.tt_spec.v2
    rows = emb.physical_hashed_rows if emb.kind == "hashed" else emb.vocab
    return "table", rows


def big_rows(idx: np.ndarray, emb) -> np.ndarray:
    """Map a logical-index batch (bags, pooling) onto big-subtable rows (the
    cached stream)."""
    name, _rows = big_subtable(emb)
    trace, _r, _b = intra_gnr.subtable_traces(idx, emb)[name]
    return trace


def _bag_shaped(trace: np.ndarray, pooling: int) -> np.ndarray:
    """Normalize a per-table trace to (bags, pooling) logical indices."""
    trace = np.asarray(trace)
    if trace.ndim == 2:
        return trace
    n = trace.size - trace.size % pooling
    return trace[:n].reshape(-1, pooling)


@dataclasses.dataclass(frozen=True)
class EmbeddingPlan:
    """Frozen output of the offline pass.  Eq/hash cover the static fields;
    the numpy planning payloads are ``compare=False``."""

    spec: EngineSpec
    num_shards: int
    backend: str                                  # packed | pertable
    layout: packed_tables.PackedLayout | None
    slot_budgets: tuple[int, ...]
    knobs: Knobs | None = None
    dup: duplication.DuplicationPlan | None = dataclasses.field(
        default=None, compare=False, repr=False
    )
    values: tuple = dataclasses.field(default=(), compare=False, repr=False)
    locality: tuple = dataclasses.field(default=(), compare=False, repr=False)
    # per-table logical-id access profile (the trace's popularity counts) —
    # the plan's own notion of "hot"; the online re-planner pins against it
    counts: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def bags(self):
        return self.spec.bags

    @property
    def kind(self) -> str:
        return self.spec.kind

    @property
    def packed(self) -> bool:
        return self.backend == "packed"

    @property
    def dim_block(self) -> int | None:
        """``repro``'s TPU lane tile frozen into this plan (checked by the
        ``ops`` entry points, read by no kernel of the port)."""
        return self.knobs.dim_block if self.knobs is not None else None

    @property
    def has_cache(self) -> bool:
        return sum(self.slot_budgets) > 0

    @property
    def comm_free(self) -> tuple[bool, ...]:
        """Per-table: True when the duplication planner killed the combine."""
        if self.dup is None:
            return tuple(False for _ in self.bags)
        return tuple(t.comm_free for t in self.dup.tables)

    def fresh_schedulers(self) -> list[PrefetchScheduler]:
        """One prefetch scheduler per table (stateful — fresh per session)."""
        if not self.has_cache:
            raise ValueError("plan has no cache slots; set spec.cache_slots")
        scheds = []
        for t, bag in enumerate(self.bags):
            _name, rows = big_subtable(bag.emb)
            value = self.values[t] if self.values else None
            scheds.append(PrefetchScheduler(rows, self.slot_budgets[t], value))
        return scheds

    def summary(self) -> dict:
        """JSON-serializable description (the same keys as ``repro``'s)."""
        out = {
            "kind": self.kind,
            "num_tables": self.spec.num_tables,
            "backend": self.backend,
            "exec_backend": self.spec.exec_backend,
            "num_shards": self.num_shards,
            "slot_budgets": list(self.slot_budgets),
            "total_slots": int(sum(self.slot_budgets)),
            "packed_rows": self.layout.total_rows if self.layout else 0,
            "comm_free": list(self.comm_free),
            "knobs": self.knobs.describe() if self.knobs is not None else None,
        }
        if self.dup is not None:
            out["replicated_bytes_per_chip"] = int(self.dup.replicated_bytes)
            out["dup_budget_bytes"] = int(self.dup.budget_bytes)
        if self.locality:
            big = big_subtable(self.bags[0].emb)[0]
            out["mean_intra_reuse_big"] = [
                round(float(loc[big].mean_intra_reuse), 4) for loc in self.locality
            ]
        return out


def plan(
    spec: EngineSpec,
    trace: Sequence[np.ndarray] | None = None,
    *,
    mesh=None,
    num_shards: int | None = None,
    dup: duplication.DuplicationPlan | None = None,
    knobs: Knobs | None = None,
    tuner=None,
) -> EmbeddingPlan:
    """Run the offline pipeline once: analyze -> budget -> duplicate -> pack.

    ``trace`` is one logical-index trace per table, flat ``(N,)`` or
    bag-shaped ``(bags, pooling)``, positional or by keyword
    (``plan(spec, traces, tuner=...)``).  ``mesh`` (a ``launch.mesh.Mesh``)
    or ``num_shards`` sizes the row-shard axis the duplication planner
    models: the mesh's ``spec.row_axis`` size, else 1.  A pre-built ``dup``
    plan may be adopted instead of re-planning.

    Knob resolution, as in ``repro``: an explicit ``knobs=`` wins; else a
    fitted ``tuner=`` (:func:`repro_torch.tune.fit`) picks the
    predicted-latency argmin over the knob space; else the heuristic
    defaults (``tune.default_knobs``).  Without a trace, cache budgets take
    the uniform policy; serving specs, which plan duplication, need one.
    """
    bags = spec.bags
    if num_shards is None:
        num_shards = 1
        if mesh is not None and spec.row_axis in mesh.shape:
            num_shards = mesh.shape[spec.row_axis]
    locs: list[dict] = []
    values: list[np.ndarray] | None = None
    counts: list[np.ndarray] | None = None
    if trace is not None:
        if len(trace) != len(bags):
            raise ValueError(f"need one trace per table: {len(trace)} vs {len(bags)}")
        values, counts = [], []
        big = big_subtable(bags[0].emb)[0]
        for bag, tr in zip(bags, trace):
            shaped = _bag_shaped(tr, bag.pooling)
            loc = intra_gnr.analyze_table(shaped, bag.emb)
            locs.append(loc)
            values.append(loc[big].prefetch_value().astype(np.float64))
            counts.append(
                placement.profile_counts(shaped.reshape(-1), bag.emb.vocab)
            )

    packable = packed_tables.packable(bags)
    if knobs is None and tuner is not None:
        knobs = tuner.choose(spec, packable=packable)
    if knobs is None:
        knobs = default_knobs(spec, packable=packable)
    if knobs.backend == "packed" and not packable:
        raise ValueError("knobs.backend='packed' but the bag set is not packable")
    budgets = _knob_budgets(spec, knobs, values)

    if dup is None and spec.duplication:
        if counts is None:
            raise ValueError(
                "spec.duplication=True needs an access profile: pass trace= "
                "(one per table) or adopt a pre-built plan via dup="
            )
        dup = duplication.plan_duplication(
            list(bags), counts,
            num_shards=num_shards,
            budget_bytes=int(knobs.dup_budget_bytes),
            slot_budgets=list(budgets),
        )

    packed = knobs.backend == "packed"
    layout = packed_tables.build_layout(bags, budgets) if packed else None

    return EmbeddingPlan(
        spec=spec,
        num_shards=num_shards,
        backend="packed" if packed else "pertable",
        layout=layout,
        slot_budgets=budgets,
        knobs=knobs,
        dup=dup,
        values=tuple(values) if values is not None else (),
        locality=tuple(locs),
        counts=tuple(counts) if counts is not None else (),
    )
