"""Per-stage roofline attribution: where did a serving batch's time go, and
does the cost model agree?  (Port of ``repro.obs.attribution``, priced from
the H100 constants of ``repro_torch.launch.mesh``.)

The paper's 2.2x is an attribution argument (traffic and CPU-PIM transfer,
stage by stage), so the reproduction needs the same decomposition as a
continuously-producible artifact.  This module joins three things the
serving loop measures separately:

* **tracer spans** (``repro_torch.obs.tracer``) — measured per-stage
  durations of the serving loop (``prefetch -> pack -> h2d -> dispatch ->
  device_compute -> interact``), honest for the device stages only when the
  run is fenced;
* **traffic accounting** (``repro_torch.obs.traffic``) — exact per-batch
  byte movement: HBM stream (misses + staging copy), staged rows, modeled
  cross-shard comm bytes;
* **the cost model** (``repro_torch.tune.cost_model.KernelCostModel``) —
  the fitted (or analytic) per-feature latency prediction.

The output is one table: per stage, measured seconds/batch, its share,
the bytes it moved, achieved GB/s (bytes / measured time), the modeled
seconds (cost-model term or bandwidth bound), and the predicted-vs-measured
residual — with the bottleneck stage and the largest residual flagged.  The
row schema is ``repro``'s, so the two packages' tables join.

As in ``repro``, the ``h2d`` stage is priced at HBM bandwidth; on the card
the upload crosses the host link (PCIe), so its modeled seconds are a floor
far below the real copy.

:func:`model_terms` is the single source of truth for converting byte/flop
counts into roofline seconds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.tune.cost_model import FEATURES, KernelCostModel

# canonical serving-stage order (the tracer's span names); device_compute and
# device_head only exist on fenced runs (their own synchronize)
STAGES = ("prefetch", "pack", "h2d", "dispatch", "device_compute",
          "interact", "device_head")

SCHEMA = "stage-attribution/v1"


# ---------------------------------------------------------------------------
# shared roofline terms
# ---------------------------------------------------------------------------

def _hw():
    from repro_torch.launch.mesh import HBM_BW, ICI_BW_PER_LINK, PEAK_FLOPS_BF16

    return PEAK_FLOPS_BF16, HBM_BW, 2 * ICI_BW_PER_LINK


def model_terms(*, flops: float = 0.0, hbm_bytes: float = 0.0,
                wire_bytes: float = 0.0, peak_flops: float | None = None,
                hbm_bw: float | None = None, wire_bw: float | None = None
                ) -> dict:
    """Byte/flop counts -> perfect-overlap roofline seconds.

    One source of truth for the compute / memory / collective terms: the
    card's bf16 peak, its HBM rate and the two-link NVLink wire rate of
    ``repro_torch.launch.mesh`` unless the caller passes others.
    """
    dpeak, dhbm, dwire = _hw()
    peak_flops = peak_flops or dpeak
    hbm_bw = hbm_bw or dhbm
    wire_bw = wire_bw or dwire
    compute = flops / peak_flops
    memory = hbm_bytes / hbm_bw
    collective = wire_bytes / wire_bw
    step = max(compute, memory, collective, 1e-12)
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "step_s": step,
        "dominant": dominant,
    }


def term_rows(terms: dict, *, hbm_bytes: float = 0.0, wire_bytes: float = 0.0
              ) -> list[dict]:
    """Roofline terms in the attribution row schema (modeled-only rows), so
    rooflines and serving attributions share one consumer format."""
    rows = []
    for stage, key, nbytes in (
        ("compute", "compute_s", None),
        ("memory", "memory_s", hbm_bytes),
        ("collective", "collective_s", wire_bytes),
    ):
        sec = terms[key]
        rows.append({
            "stage": stage,
            "measured_s": None,
            "share": None,
            "bytes_per_batch": nbytes,
            "achieved_gbps": None,
            "modeled_s": sec,
            "modeled_gbps": (
                nbytes / sec / 1e9 if nbytes and sec > 0 else None
            ),
            "residual_s": None,
            "basis": "roofline",
        })
    return rows


# ---------------------------------------------------------------------------
# the analytic fallback model (serving sessions without a fitted tuner)
# ---------------------------------------------------------------------------

def analytic_cost_model(backend: str = "packed") -> KernelCostModel:
    """A :class:`KernelCostModel` priced from the card's constants instead
    of a fit: dispatch at the launch overhead measured on the card
    (``launch.mesh.DISPATCH_OVERHEAD_S``), bytes at HBM bandwidth, comm at
    the two-link NVLink wire rate (tiles free).  Used when a serving session
    has no fitted tuner — attribution still reports modeled GB/s."""
    from repro_torch.launch.mesh import DISPATCH_OVERHEAD_S, HBM_BW, ICI_BW_PER_LINK

    coef = {
        "dispatches": DISPATCH_OVERHEAD_S,
        "hbm_bytes": 1.0 / HBM_BW,
        "row_tiles": 0.0,
        "comm_bytes": 1.0 / (2 * ICI_BW_PER_LINK),
    }
    return KernelCostModel(
        coef=tuple(coef[f] for f in FEATURES), backend=backend,
        source="analytic", num_samples=0,
    )


# ---------------------------------------------------------------------------
# measured stage durations from the tracer's events
# ---------------------------------------------------------------------------

def stage_durations(events, *, skip_batches=(0,)) -> dict[str, list[float]]:
    """Span name -> per-occurrence durations (seconds) over steady-state
    batches.  Batch 0 (the compile/warm-up batch) is skipped by default —
    its spans time compilation, not serving."""
    skip = set(skip_batches)
    out: dict[str, list[float]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        batch = args.get("batch")
        if batch is None or batch in skip or ev["name"] == "batch":
            continue
        out.setdefault(ev["name"], []).append(ev["dur"] * 1e-6)
    return out


# ---------------------------------------------------------------------------
# per-batch cost-model features from the traffic report + plan
# ---------------------------------------------------------------------------

def batch_features(plan, traffic, *, batch: int) -> dict:
    """Per-batch byte/feature accounting from an ``EmbeddingPlan`` + its
    session :class:`~repro_torch.obs.traffic.TrafficReport`.

    Returns the cost model's feature vector (``dispatches``, ``hbm_bytes``,
    ``row_tiles``, ``comm_bytes``) plus the auxiliary per-stage byte counts
    attribution prices (``staged_bytes`` for the prefetch DMA, ``h2d_bytes``
    for the index upload).  All values are *per batch* — session totals are
    divided by the scheduler-observed batch count, so they reconcile exactly
    with ``TrafficReport.describe()``.
    """
    batches = max(1, traffic.batches)
    dispatches = 1.0 if plan.packed else float(len(plan.bags))
    hbm = traffic.hbm_cached_bytes / batches
    staged = sum(
        t["staged_rows"] * t["row_bytes"] for t in traffic.tables
    ) / batches
    tiles = 0.0
    for t in traffic.tables:
        width = max(1, t["row_bytes"] // 4)
        bd = plan.dim_block or width
        tiles += (t["accesses"] / batches) * max(1.0, width / min(bd, width))
    # index upload: idx + slot (int32 per access) + the packed cache-row list
    accesses = traffic.accesses / batches
    h2d = accesses * 4 * 2 + sum(plan.slot_budgets) * 4
    comm = 0.0
    if plan.dup is not None:
        dim = plan.bags[0].emb.dim
        comm = float(plan.dup.ici_bytes_per_batch(batch, dim)["duplicated"])
    return {
        "dispatches": dispatches,
        "hbm_bytes": float(hbm),
        "row_tiles": float(tiles),
        "comm_bytes": comm,
        "staged_bytes": float(staged),
        "h2d_bytes": float(h2d),
    }


# ---------------------------------------------------------------------------
# the attribution table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageRow:
    """One where-did-time-go row.  ``basis`` says where ``modeled_s`` came
    from: "cost_model" (a fitted/analytic KernelCostModel term),
    "bandwidth_bound" (bytes at peak HBM bandwidth), or None (no model)."""

    stage: str
    measured_s: float | None
    share: float | None
    bytes_per_batch: float | None
    modeled_s: float | None
    basis: str | None

    @property
    def achieved_gbps(self) -> float | None:
        if self.bytes_per_batch and self.measured_s:
            return self.bytes_per_batch / self.measured_s / 1e9
        return None

    @property
    def modeled_gbps(self) -> float | None:
        if self.bytes_per_batch and self.modeled_s:
            return self.bytes_per_batch / self.modeled_s / 1e9
        return None

    @property
    def residual_s(self) -> float | None:
        if self.measured_s is None or self.modeled_s is None:
            return None
        return self.measured_s - self.modeled_s

    def describe(self) -> dict:
        return {
            "stage": self.stage,
            "measured_s": self.measured_s,
            "share": self.share,
            "bytes_per_batch": self.bytes_per_batch,
            "achieved_gbps": self.achieved_gbps,
            "modeled_s": self.modeled_s,
            "modeled_gbps": self.modeled_gbps,
            "residual_s": self.residual_s,
            "basis": self.basis,
        }


@dataclasses.dataclass
class Attribution:
    """The joined table + verdicts."""

    rows: list                          # StageRow, canonical stage order
    bottleneck: str | None              # stage with the largest measured share
    total_s: float                      # summed measured stage seconds/batch
    model: KernelCostModel | None
    features: dict                      # batch_features() output
    fenced: bool                        # were span durations device-honest?

    @property
    def largest_residual(self) -> dict | None:
        """The stage where the cost model misses measurement the most."""
        cand = [
            r for r in self.rows
            if r.basis == "cost_model" and r.residual_s is not None
        ]
        if not cand:
            return None
        worst = max(cand, key=lambda r: abs(r.residual_s))
        return {
            "stage": worst.stage,
            "residual_s": worst.residual_s,
            "measured_s": worst.measured_s,
            "modeled_s": worst.modeled_s,
        }

    def modeled_total_s(self) -> float:
        """Sum of the cost-model stage terms — equals
        ``model.predict(features)`` by construction (tested)."""
        return sum(
            r.modeled_s for r in self.rows
            if r.basis == "cost_model" and r.modeled_s is not None
        )

    def describe(self) -> dict:
        return {
            "schema": SCHEMA,
            "fenced": self.fenced,
            "bottleneck": self.bottleneck,
            "total_s": self.total_s,
            "modeled_total_s": self.modeled_total_s(),
            "largest_residual": self.largest_residual,
            "model": self.model.describe() if self.model else None,
            "features": dict(self.features),
            "rows": [r.describe() for r in self.rows],
        }

    def format_table(self) -> str:
        """Markdown where-did-time-go table (the report artifact's core)."""
        def ms(v):
            return f"{v * 1e3:.3f}" if v is not None else "—"

        def gb(v):
            return f"{v:.2f}" if v is not None else "—"

        lines = [
            "| stage | measured ms | share | bytes/batch | achieved GB/s | "
            "modeled ms | modeled GB/s | residual ms | basis |",
            "|---|---|---|---|---|---|---|---|---|",
        ]
        for r in self.rows:
            mark = " **(bottleneck)**" if r.stage == self.bottleneck else ""
            share = f"{r.share * 100:.1f}%" if r.share is not None else "—"
            nbytes = (f"{r.bytes_per_batch:.0f}"
                      if r.bytes_per_batch is not None else "—")
            lines.append(
                f"| {r.stage}{mark} | {ms(r.measured_s)} | {share} | "
                f"{nbytes} | {gb(r.achieved_gbps)} | {ms(r.modeled_s)} | "
                f"{gb(r.modeled_gbps)} | {ms(r.residual_s)} | "
                f"{r.basis or '—'} |"
            )
        return "\n".join(lines)


def attribute(events, traffic, plan, *, batch: int,
              model: KernelCostModel | None = None,
              fenced: bool = False) -> Attribution:
    """Join tracer ``events`` + a session :class:`TrafficReport` + the plan
    into the per-stage attribution table.

    ``model=None`` falls back to :func:`analytic_cost_model` so a session
    without a fitted tuner still reports modeled seconds/GB/s.  Unfenced
    runs attribute *enqueue* cost to the device stages; the table records
    ``fenced`` so consumers know which they got.
    """
    if model is None:
        model = analytic_cost_model(
            "packed" if getattr(plan, "packed", True) else "pertable"
        )
    feats = batch_features(plan, traffic, batch=batch)
    coef = dict(zip(FEATURES, model.coef))
    durs = stage_durations(events)
    measured = {name: float(np.mean(vals)) for name, vals in durs.items()}
    total = sum(measured.values())

    # per-stage byte + model assignment
    _, hbm_bw, _ = _hw()
    modeled: dict[str, tuple[float, str]] = {
        "dispatch": (coef["dispatches"] * feats["dispatches"], "cost_model"),
        "device_compute": (
            coef["hbm_bytes"] * feats["hbm_bytes"]
            + coef["row_tiles"] * feats["row_tiles"],
            "cost_model",
        ),
        "prefetch": (feats["staged_bytes"] / hbm_bw, "bandwidth_bound"),
        "h2d": (feats["h2d_bytes"] / hbm_bw, "bandwidth_bound"),
    }
    stage_bytes = {
        "prefetch": feats["staged_bytes"],
        "h2d": feats["h2d_bytes"],
        "device_compute": feats["hbm_bytes"],
    }

    names = [s for s in STAGES if s in measured]
    names += sorted(set(measured) - set(STAGES))
    rows = []
    for name in names:
        m_s, basis = modeled.get(name, (None, None))
        rows.append(StageRow(
            stage=name,
            measured_s=measured[name],
            share=measured[name] / total if total > 0 else None,
            bytes_per_batch=stage_bytes.get(name),
            modeled_s=m_s,
            basis=basis,
        ))
    # keep the cost-model decomposition complete even when a stage had no
    # span (unfenced runs): modeled-only rows, so the sum of cost_model
    # terms always equals model.predict(features)
    for name in ("dispatch", "device_compute"):
        if name not in measured:
            m_s, basis = modeled[name]
            rows.append(StageRow(
                stage=name, measured_s=None, share=None,
                bytes_per_batch=stage_bytes.get(name),
                modeled_s=m_s, basis=basis,
            ))
    # the cross-shard combine has no host-side span at all
    rows.append(StageRow(
        stage="comm", measured_s=None, share=None,
        bytes_per_batch=feats["comm_bytes"] or None,
        modeled_s=coef["comm_bytes"] * feats["comm_bytes"],
        basis="cost_model",
    ))

    bottleneck = max(
        (r for r in rows if r.measured_s is not None),
        key=lambda r: r.measured_s, default=None,
    )
    return Attribution(
        rows=rows,
        bottleneck=bottleneck.stage if bottleneck else None,
        total_s=total,
        model=model,
        features=feats,
        fenced=fenced,
    )
