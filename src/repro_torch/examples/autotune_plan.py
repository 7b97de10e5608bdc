"""Walkthrough of the trace-driven autotuner (port of
``examples/autotune_plan.py``): trace -> fit cost model -> rank the knob
space -> freeze the winner into an EmbeddingPlan.

Run:  PYTHONPATH=src python -m repro_torch.examples.autotune_plan [--device cpu]

On the card ``mode="auto"`` times the packed kernel (K1 on this QR spec)
under each sampled knob setting with CUDA events; on the CPU it prices the
bytes and flops of each sampled batch at the card's constants.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import device as device_mod
from repro_torch import engine, tune
from repro_torch.configs.dlrm_qr import SMOKE
from repro_torch.data.synthetic import zipf_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (analytic pricing, no card)")
    ap.add_argument("--cache", default=os.path.join(tempfile.gettempdir(),
                                                    "repro_torch_autotune_memo.json"),
                    help="tuner memo-cache JSON (keyed by spec digest, device "
                         "kind and source)")
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)

    # 1. The spec declares WHAT to serve; the knobs decide HOW.
    spec = engine.EngineSpec.from_dlrm(SMOKE, serving=True).replace(
        duplication=False
    )
    traces = [
        zipf_trace(b.emb.vocab, 16_384, alpha=1.05, seed=t)
        for t, b in enumerate(spec.bags)
    ]

    # The heuristic defaults are what plan() picks with no tuner at all.
    base = tune.default_knobs(spec, packable=True)
    print("heuristic knobs:", base.describe())
    print("knob space size:", len(tune.knob_space(spec, packable=True)))

    # 2. Fit a per-kernel linear cost model from the trace.  mode="auto"
    #    times real runs on the card and prices sampled batches analytically
    #    on the CPU; the fit memoizes to the cache keyed by (spec digest,
    #    device kind, source), so re-running is free.
    tuner = tune.fit(spec, traces, mode="auto", batch=16, max_samples=8,
                     cache_path=args.cache, device=dev)
    print(f"\nfit: source={tuner.source} samples={len(tuner.samples)} "
          f"cached={tuner.from_cache} device={tuner.metadata['device_kind']}")
    for backend, model in tuner.models.items():
        coefs = {f: f"{c:.3g}" for f, c in zip(tune.FEATURES, model.coef)}
        print(f"  {backend}: {coefs}")

    # 3. Rank every candidate by predicted latency.
    ranked = tuner.rank(spec, packable=True)
    print("\npredicted latency per candidate (best first):")
    for knobs, pred in ranked[:5]:
        tag = " <- heuristic" if knobs == base else ""
        print(f"  {pred * 1e6:9.1f} us  {knobs.describe()}{tag}")

    # 4. plan() freezes the winner; the knobs are part of the plan's
    #    equality, so differently-tuned plans never compare equal.
    eplan = engine.plan(spec, traces, tuner=tuner)
    print("\ntuned plan knobs:", eplan.knobs.describe())
    print("slot budgets:", eplan.slot_budgets)
    assert eplan.knobs in tune.knob_space(spec, packable=True)

    # The zero-trace fallback is the heuristic plan.
    assert engine.plan(spec) == engine.plan(spec, knobs=base)
    print("no-trace plan == heuristic-knobs plan: OK")
    return {"source": tuner.source, "from_cache": tuner.from_cache,
            "samples": len(tuner.samples), "knobs": eplan.knobs,
            "slot_budgets": eplan.slot_budgets,
            "best_predicted_s": ranked[0][1]}


if __name__ == "__main__":
    main()
