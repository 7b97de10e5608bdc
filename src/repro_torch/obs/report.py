"""One serving-report artifact: snapshot + SLO state + attribution, rendered
as markdown (for humans/CI summaries) and JSON (for dashboards/joins); port
of ``repro.obs.report`` with the same schema.

The observatory's terminal product.  ``serve_rec --report report.md`` builds
it from the session's metric snapshot, the :class:`~repro_torch.obs.slo.SLOEngine`
state, the :class:`~repro_torch.obs.attribution.Attribution` table, and the flight
recorder's dump index; the markdown lands at the given path and the JSON
twin next to it (``report.md`` -> ``report.json``).  The JSON schema is
versioned (``serving-report/v1``) and its attribution rows use the
``stage-attribution/v1`` row schema of ``repro``'s reports, so the two
packages' reports join on one vocabulary.
"""

from __future__ import annotations

import json
import os


SCHEMA = "serving-report/v1"


def build(*, snapshot=None, slo_state: dict | None = None,
          attribution=None, traffic: dict | None = None,
          results: dict | None = None, flight_dumps: list | None = None,
          meta: dict | None = None) -> dict:
    """Assemble the JSON report.  Every section is optional — the report
    carries what the session produced (``snapshot`` a ``RegistrySnapshot``,
    ``attribution`` an ``Attribution``, ``results`` the per-mode serve_rec
    records minus bulk arrays)."""
    return {
        "schema": SCHEMA,
        "meta": dict(meta or {}),
        "slo": slo_state,
        "attribution": attribution.describe() if attribution else None,
        "traffic": traffic,
        "results": results,
        "flight_dumps": list(flight_dumps or []),
        "metrics": snapshot.to_json() if snapshot is not None else None,
    }


def _fmt(v, spec: str = ".3f") -> str:
    return format(v, spec) if isinstance(v, (int, float)) else "—"


def _slo_md(slo: dict) -> list[str]:
    spec = slo["spec"]
    target = spec["p99_latency_s"]
    lines = [
        "## SLO",
        "",
        f"**{spec['name']}** — objective {spec['objective']}, "
        f"p99 target {_fmt(target * 1e3 if target else None)} ms, "
        f"windows {spec['fast_window']}/{spec['slow_window']} batches: "
        + ("**BREACHED**" if slo["breached"] else "met"),
        "",
        "| observations | bad | budget spent | budget remaining | "
        "fast burn | slow burn |",
        "|---|---|---|---|---|---|",
        f"| {slo['observations']} | {slo['bad_events']} | "
        f"{slo['budget_spent']} / {_fmt(slo['budget_allowed'], '.2f')} | "
        f"{_fmt(slo['budget_remaining_frac'] * 100, '.1f')}% | "
        f"{_fmt(slo['fast_burn'], '.2f')}x | "
        f"{_fmt(slo['slow_burn'], '.2f')}x |",
    ]
    if slo["alerts"]:
        lines += ["", "Alerts:", ""]
        lines += [
            f"- `{a['severity']}` at batch {a['at_batch']}: fast burn "
            f"{a['fast_burn']:.1f}x / slow burn {a['slow_burn']:.1f}x "
            f"(threshold {a['threshold']}x)"
            for a in slo["alerts"]
        ]
    for name, f in (slo.get("floors") or {}).items():
        verdict = "**BREACHED**" if f["breached"] else "met"
        lines.append(
            f"- {name} floor {f['floor']}: measured "
            f"{_fmt(f['measured'])} — {verdict}"
        )
    return lines


def render_markdown(report: dict, *, attribution=None) -> str:
    """The human-facing artifact.  ``attribution`` (the live object) renders
    its own table when given; otherwise the table is rebuilt from the JSON
    rows so a stored report re-renders identically."""
    meta = report.get("meta", {})
    out = [f"# Serving report — {meta.get('config', 'unknown config')}", ""]
    if meta:
        out += [
            "```",
            *(f"{k}: {v}" for k, v in sorted(meta.items())),
            "```",
            "",
        ]
    if report.get("slo"):
        out += _slo_md(report["slo"]) + [""]
    att = report.get("attribution")
    if att:
        out += [
            "## Where did the time go (per steady-state batch)",
            "",
            f"Bottleneck stage: **{att['bottleneck']}** — measured stage "
            f"total {_fmt(att['total_s'] * 1e3)} ms/batch, cost-model total "
            f"{_fmt(att['modeled_total_s'] * 1e3)} ms/batch"
            + ("" if att["fenced"] else
               " *(unfenced: device stages show enqueue cost)*"),
            "",
        ]
        if attribution is not None:
            out.append(attribution.format_table())
        else:
            out.append(_rows_table(att["rows"], att["bottleneck"]))
        lr = att.get("largest_residual")
        if lr:
            out += [
                "",
                f"Largest predicted-vs-measured residual: **{lr['stage']}** "
                f"({_fmt(lr['residual_s'] * 1e3)} ms — measured "
                f"{_fmt(lr['measured_s'] * 1e3)} ms vs modeled "
                f"{_fmt(lr['modeled_s'] * 1e3)} ms)",
            ]
        out.append("")
    tr = report.get("traffic")
    if tr:
        out += [
            "## Traffic",
            "",
            f"- cache hit rate {_fmt(tr['hit_rate'])} over "
            f"{tr['accesses']} accesses ({tr['batches']} batches)",
            f"- HBM {tr['hbm_cached_bytes']} B vs uncached baseline "
            f"{tr['hbm_baseline_bytes']} B "
            f"({_fmt(tr['hbm_reduction'], '.2f')}x)",
        ]
        if "comm_saved_bytes_per_batch" in tr:
            out.append(
                f"- comm killed by duplication: "
                f"{_fmt(tr['comm_saved_bytes_per_batch'], '.0f')} B/batch"
            )
        out.append("")
    res = report.get("results")
    if res:
        out += ["## Modes", ""]
        out += [
            "| mode | QPS | p50 ms | p95 ms | p99 ms | compile s |",
            "|---|---|---|---|---|---|",
        ]
        for mode, r in sorted(res.items()):
            out.append(
                f"| {mode} | {_fmt(r['qps'], '.1f')} | "
                f"{_fmt(r['lat_p50_s'] * 1e3)} | "
                f"{_fmt(r['lat_p95_s'] * 1e3)} | "
                f"{_fmt(r['lat_p99_s'] * 1e3)} | "
                f"{_fmt(r['compile_s'], '.2f')} |"
            )
        out.append("")
    dumps = report.get("flight_dumps")
    if dumps:
        out += ["## Flight-recorder dumps", ""]
        out += [
            f"- `{d.get('path', '<memory>')}` — {d['reason']} "
            f"(trigger batch {d.get('trigger_batch')}, "
            f"{d['records']} records)"
            for d in dumps
        ]
        out.append("")
    return "\n".join(out)


def _rows_table(rows: list[dict], bottleneck: str | None) -> str:
    """Re-render the attribution table from stored JSON rows."""
    def ms(v):
        return f"{v * 1e3:.3f}" if v is not None else "—"

    lines = [
        "| stage | measured ms | share | bytes/batch | achieved GB/s | "
        "modeled ms | modeled GB/s | residual ms | basis |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        mark = " **(bottleneck)**" if r["stage"] == bottleneck else ""
        share = (f"{r['share'] * 100:.1f}%" if r["share"] is not None
                 else "—")
        nbytes = (f"{r['bytes_per_batch']:.0f}"
                  if r["bytes_per_batch"] is not None else "—")
        gba = (f"{r['achieved_gbps']:.2f}"
               if r["achieved_gbps"] is not None else "—")
        gbm = (f"{r['modeled_gbps']:.2f}"
               if r["modeled_gbps"] is not None else "—")
        lines.append(
            f"| {r['stage']}{mark} | {ms(r['measured_s'])} | {share} | "
            f"{nbytes} | {gba} | {ms(r['modeled_s'])} | {gbm} | "
            f"{ms(r['residual_s'])} | {r['basis'] or '—'} |"
        )
    return "\n".join(lines)


def json_twin_path(md_path: str) -> str:
    root, ext = os.path.splitext(md_path)
    return (root if ext == ".md" else md_path) + ".json"


def write(report: dict, md_path: str, *, attribution=None) -> tuple[str, str]:
    """Write markdown to ``md_path`` and the JSON twin next to it; returns
    both paths."""
    with open(md_path, "w") as f:
        f.write(render_markdown(report, attribution=attribution))
        f.write("\n")
    jpath = json_twin_path(md_path)
    with open(jpath, "w") as f:
        json.dump(report, f, indent=1)
    return md_path, jpath
