"""The ``serve_rec --adapt`` session: pinned serving + online re-planning
(port of ``repro.adapt.loop``).

The adaptive loop serves the same packed-kernel pipeline as
``run_pipeline`` but with **pinned** cache residency (no oracle next-batch
prefetch — see :class:`repro_torch.adapt.replan.PinnedCache`): steady-state
batches stage nothing, residency only changes when the
:class:`AdaptController` decides a swap pays.  Per batch it:

1. folds the batch's logical indices into the frequency sketches (O(bag));
2. routes through the pinned slot maps and launches the SAME engine's
   ``serve_gather`` on the same packed buffers — swaps change runtime-arg
   *contents* only, and ``engine/compile/serve_gather`` (the first
   ``serve_gather`` of each distinct plan) proves it stays at one plan;
3. runs the controller's trigger; an incremental re-plan re-pins in place,
   a full re-plan / drift refit rebuilds plan, engine and packed buffers
   mid-loop without restarting the session.

The drift-refit hook closes the autotuner loop: ``DriftMonitor`` flips
``refit_recommended``, the hook re-fits the tuner cost model on
sketch-sampled traffic, re-plans, rebuilds the engine, re-arms the monitor —
all between two batches of the same ``while`` loop.

The batches come from ``synthetic.dlrm_batch`` (dense features, drawn by a
``torch.Generator`` on the session's device) and the shared drift law
(indices, numpy), or from ``idx_override``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import engine as engine_mod
from repro_torch import obs
from repro_torch.adapt.policy import AdaptController, AdaptPolicy
from repro_torch.adapt.replan import sampled_traces
from repro_torch.adapt.schedule import DriftSchedule, drifting_zipf_batches
from repro_torch.data import synthetic
from repro_torch.engine import big_rows
from repro_torch.launch.serve_rec import ServeState, make_packed_gather
from repro_torch.models import dlrm


def make_refit_hook(state: ServeState, params, *, mode: str = "auto",
                    sample_n: int = 4096, max_samples: int = 3,
                    repeats: int = 1, seed: int = 0):
    """Build the drift-refit callback: re-fit cost model, re-plan, rebuild.

    Runs the full autotuner path on sketch-sampled traffic — the expensive
    but complete answer to a cost model whose predictions stopped ranking
    reality.  ``mode`` is ``tune.fit``'s (``auto``: timed on the card,
    analytic on the CPU), on the state's device.  Mutates ``state`` in place
    (new engine, new prediction, fresh re-armed monitor) so the serving loop
    continues against the same object.
    """
    from repro_torch import tune

    def hook(controller: AdaptController) -> dict:
        spec = state.eplan.spec
        traces = sampled_traces(controller.sketches, n=sample_n, seed=seed)
        with obs.span("adapt_refit_fit", cat="adapt"):
            tuner = tune.fit(
                spec, traces, mode=mode, num_shards=state.eplan.num_shards,
                max_samples=max_samples, repeats=repeats, device=state.device,
            )
            knobs = tuner.choose(spec, backend="packed")
            eplan = engine_mod.plan(
                spec, num_shards=state.eplan.num_shards, trace=traces,
                knobs=knobs,
            )
        state.engine = engine_mod.compile(eplan)
        state.predicted_s = tuner.predict(spec, knobs)
        state.drift = obs.DriftMonitor()      # re-arm on the fresh model
        controller.eplan = eplan
        return {"knobs": knobs.describe(),
                "predicted_s": state.predicted_s}

    return hook


def make_full_hook(state: ServeState, *, sample_n: int = 4096, seed: int = 0):
    """Build the full-replan callback: offline ``plan()`` on sketch traffic.

    Re-derives budgets/duplication/packing (keeping the frozen knobs) — a
    new plan, hence a new engine and packed buffers on the next launch.
    Incremental swaps handle residency; this handles *structure*.
    """

    def hook(controller: AdaptController) -> dict:
        spec = state.eplan.spec
        traces = sampled_traces(controller.sketches, n=sample_n, seed=seed)
        with obs.span("adapt_replan_full", cat="adapt"):
            eplan = engine_mod.plan(
                spec, num_shards=state.eplan.num_shards, trace=traces,
                knobs=state.eplan.knobs,
            )
        state.engine = engine_mod.compile(eplan)
        controller.eplan = eplan
        return {"slot_budgets": list(eplan.slot_budgets)}

    return hook


def serve_adaptive(
    cfg, *, batch: int = 16, batches: int = 24, alpha: float = 1.05,
    seed: int = 0, state: ServeState, params,
    schedule: DriftSchedule | None = None,
    controller: AdaptController | None = None,
    policy: AdaptPolicy | None = None,
    refit: bool = False, refit_kw: dict | None = None,
    full_replan: bool = False,
    idx_override: list[np.ndarray] | None = None,
) -> dict:
    """Serve ``batches`` batches with online adaptation; returns the record.

    Traffic comes from the shared drift-schedule helper
    (:func:`drifting_zipf_batches`, per-table seeds matching what
    ``build_serve_state`` profiled — seed+7+t), so a stationary schedule
    means the offline plan's bet is *right* and the policy correctly holds;
    ``schedule`` rotates the hot set per batch index.  ``idx_override``
    (one (B, T, K) array per batch) substitutes an explicit index stream —
    the parity tests feed ``run_pipeline``'s exact batches through it.
    ``refit=True`` arms the drift-refit hook against ``state.drift``;
    ``full_replan=True`` allows policy-triggered full ``plan()`` rebuilds.
    Sequential dispatch (gather -> head -> wait per batch) on the state's
    device: adaptation decisions happen on the host between batches, which
    is exactly where the admission queue would sit in the front end.
    """
    dev = state.device
    schedule = schedule or DriftSchedule()
    if controller is None:
        controller = AdaptController(state.eplan, policy=policy, seed=seed)
    if refit and controller.refit_hook is None:
        controller.refit_hook = make_refit_hook(
            state, params, seed=seed, **(refit_kw or {})
        )
    if full_replan and controller.full_hook is None:
        controller.full_hook = make_full_hook(state, seed=seed)

    emb = state.bags[0].emb
    vocab = emb.vocab
    dense = [
        synthetic.dlrm_batch(cfg, batch, seed=seed, step=t, alpha=alpha,
                             device=dev)["dense"]
        for t in range(batches)
    ]                                      # dense features
    if idx_override is not None:
        idx_np = [np.asarray(x, dtype=np.int32) for x in idx_override]
    else:
        # per-table streams under the shared drift law, seeded exactly like
        # the offline profile (seed+7+t) — same marginal, rotated hot set
        per_table = [
            drifting_zipf_batches(
                vocab, batches, batch * cfg.pooling,
                schedule=schedule, alpha=alpha, seed=seed + 7 + t,
            )
            for t in range(cfg.num_tables)
        ]
        idx_np = [
            np.stack(
                [pt[b].reshape(batch, cfg.pooling) for pt in per_table],
                axis=1,
            ).astype(np.int32)
            for b in range(batches)
        ]
    rows_np = [
        np.stack(
            [big_rows(idx_np[t][:, i], emb) for i in range(cfg.num_tables)],
            axis=1,
        )
        for t in range(batches)
    ]

    gather = make_packed_gather(params, state)
    caches = controller.fresh_caches()

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev, non_blocking=True)

    def dispatch(t):
        with obs.span("pack", batch=t):
            slot = np.stack(
                [caches[i].slots_for(rows_np[t][:, i])
                 for i in range(cfg.num_tables)],
                axis=1,
            )
            cache_rows = state.engine.packed_cache_rows(caches)
        with obs.span("dispatch", batch=t):
            pooled = gather(upload(idx_np[t]), upload(slot), upload(cache_rows))
        with obs.span("interact", batch=t):
            return dlrm.forward_from_pooled(params, dense[t], pooled, cfg)

    logits = [None] * batches
    lats: list[float] = []
    hit_series: list[float] = []
    staged_series: list[int] = []

    device_mod.synchronize(dev)
    tc = time.perf_counter()
    with obs.span("compile_warmup", cat="offline"):
        logits[0] = dispatch(0).cpu().numpy()    # waits for the warm-up batch
    compile_s = time.perf_counter() - tc
    controller.observe(idx_np[0])

    t0 = time.perf_counter()
    for t in range(1, batches):
        tb = time.perf_counter()
        prev_hits, prev_acc = (
            sum(c.stats.hits for c in caches),
            sum(c.stats.accesses for c in caches),
        )
        prev_staged = sum(c.stats.staged_rows for c in caches)
        with obs.span("batch", batch=t, mode="adaptive"):
            out = dispatch(t)
            with obs.span("block", batch=t):
                device_mod.synchronize(dev)
        lat = time.perf_counter() - tb
        lats.append(lat)
        logits[t] = out.cpu().numpy()
        obs.observe_batch(batch=t, mode="adaptive", latency_s=lat)
        hits = sum(c.stats.hits for c in caches) - prev_hits
        acc = sum(c.stats.accesses for c in caches) - prev_acc
        hit_series.append(hits / max(1, acc))
        if state.drift is not None and state.predicted_s is not None:
            state.drift.observe(state.predicted_s, lat)

        # host-side adaptation, between batches (where the queue would sit)
        controller.observe(idx_np[t])
        engine_before = state.engine
        ev = controller.step(caches)
        rev = controller.maybe_refit(state.drift)
        if state.engine is not engine_before:
            # a full re-plan / refit swapped the engine: rebuild the packed
            # buffers + pinned caches against the new plan
            gather = make_packed_gather(params, state)
            caches = controller.fresh_caches()
        if (ev or rev) and obs.enabled():
            obs.trace_counter("serve/adaptive/events",
                              events=len(controller.events))
        staged_series.append(
            sum(c.stats.staged_rows for c in caches) - prev_staged
            if state.engine is engine_before else 0
        )
    wall_s = time.perf_counter() - t0

    for lat in lats:
        obs.observe("serve/adaptive/batch_latency_s", lat)
    obs.inc("serve/adaptive/batches", len(lats))

    stats = [c.stats for c in caches]
    acc = sum(s.accesses for s in stats)
    hits = sum(s.hits for s in stats)
    served = batch * max(0, batches - 1)
    return {
        "config": cfg.name,
        "device": str(dev),
        "mode": "adaptive",
        "batch": batch,
        "batches": batches,
        "served": served,
        "compile_s": compile_s,
        "wall_s": wall_s,
        "qps": served / max(wall_s, 1e-9),
        **obs.latency_percentiles(lats),
        "latencies_s": lats,
        "hit_rate": hits / max(1, acc),
        "hit_series": hit_series,
        "staged_series": staged_series,
        "schedule": schedule.describe(),
        "events": list(controller.events),
        "adapt": controller.summary(),
        "drift": state.drift.summary() if state.drift is not None else None,
        "logits": logits,
    }
