"""Admission control + deadline batching over the engine's serving seam
(port of ``repro.serve.frontend``).

The front end closes the loop between open-loop traffic (``arrival``) and
the packed-gather pipeline: a bounded queue admits requests, a deadline-aware
assembler closes batches on size-or-timeout, and every dispatched batch runs
through the degradation ladder's current rung (``degrade``) under the fault
injector's schedule (``faults``).

**Virtual clock.**  Arrivals, deadlines, SLO burns, backoff, and injected
stalls all live in virtual seconds.  Real wall time (a batch's host work,
its kernel launch and its head, until the device has finished) enters only
through calibration: the warm-up median wall ``s0`` maps to one
``service_unit_s`` of virtual time, so a batch that measures ``w`` seconds
of wall is charged ``w / s0 × service_unit_s`` of virtual service
(``service_mode="measured"``), or exactly one unit
(``service_mode="fixed"`` — the chaos CI configuration, where behavior must
be host-independent).  Injected stalls are virtual seconds added on top, so
a scheduled 0.5 s stall is ~50 service units regardless of host speed — SLO
burn alerts and ladder steps fire deterministically.  In ``measured`` mode a
full-width batch's wall is mostly the host's (the 26 prefetch calls), so
virtual latency follows the host.

**Accounting identity** (the invariant the chaos gate asserts): every
generated request ends in exactly one bucket —

    generated = served + deadline_missed + shed_reject + shed_evict
                + shed_mode + abandoned

``unaccounted`` in the report is the residual and must be zero.  Requests in
a batch that exhausts its gather retries are *abandoned*; dispatched
requests are classified at completion (late completions count as
``deadline_missed``, not served).

Only the injector's :class:`TransientGatherError` is retried: any other
error of a launch (a CUDA build or launch failure) propagates out of
:meth:`Frontend.run`, never counted as a transient fault and never walking
the ladder.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.data import synthetic
from repro_torch.engine import big_rows
from repro_torch.models import dlrm
from repro_torch.serve.arrival import Request
from repro_torch.serve.degrade import RUNGS, DegradationLadder, DegradePolicy
from repro_torch.serve.faults import FaultInjector, FaultSpec, TransientGatherError


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Queue, batching, and virtual-clock policy."""

    batch_size: int = 8
    queue_cap: int = 64
    shed_policy: str = "reject_new"      # reject_new | drop_oldest
    queue_order: str = "fifo"            # fifo | edf (deadline-earliest-first)
    residency: str = "prefetch"          # prefetch (oracle) | pinned (static)
    assembly_timeout_s: float = 0.02     # close a partial batch after this wait
    service_unit_s: float = 0.01         # virtual service per calibrated batch
    service_mode: str = "measured"       # measured | fixed (CI determinism)
    warmup_batches: int = 3              # calibration dispatches (not counted)

    def __post_init__(self):
        if self.shed_policy not in ("reject_new", "drop_oldest"):
            raise ValueError(f"unknown shed policy {self.shed_policy!r}")
        if self.queue_order not in ("fifo", "edf"):
            raise ValueError(f"unknown queue order {self.queue_order!r}")
        if self.residency not in ("prefetch", "pinned"):
            raise ValueError(f"unknown residency {self.residency!r}")
        if self.service_mode not in ("measured", "fixed"):
            raise ValueError(f"unknown service mode {self.service_mode!r}")
        if self.batch_size <= 0 or self.queue_cap <= 0:
            raise ValueError("batch_size and queue_cap must be positive")

    def describe(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FrontendStats:
    """Every request's final bucket + the dispatch-path counters."""

    generated: int = 0
    admitted: int = 0            # entered the queue (may later be evicted)
    served: int = 0
    deadline_missed: int = 0
    shed_reject: int = 0         # reject_new at a full queue
    shed_evict: int = 0          # drop_oldest evictions
    shed_mode: int = 0           # rejected while the ladder sheds
    abandoned: int = 0           # batch dropped after retry exhaustion
    batches: int = 0
    retries: int = 0
    stall_s_injected: float = 0.0

    @property
    def shed_total(self) -> int:
        return (self.shed_reject + self.shed_evict + self.shed_mode
                + self.abandoned)

    @property
    def unaccounted(self) -> int:
        """Must be zero: the conservation law of the front end."""
        return (self.generated - self.served - self.deadline_missed
                - self.shed_total)

    def describe(self) -> dict:
        d = dataclasses.asdict(self)
        d["shed_total"] = self.shed_total
        d["unaccounted"] = self.unaccounted
        return d


class Frontend:
    """One serving session: queue → batches → ladder → accounting.

    ``state``/``params`` are the offline pass's ``ServeState`` + DLRM params
    (the same objects ``run_pipeline`` uses, on the state's device); ``slo``
    an optional ``obs.SLOEngine`` whose burn signals drive the ladder.
    """

    def __init__(self, cfg, fcfg: FrontendConfig, state, params, *,
                 slo=None, faults: FaultInjector | None = None,
                 policy: DegradePolicy | None = None, adapt=None):
        self.cfg = cfg
        self.fcfg = fcfg
        self.state = state
        self.params = params
        self.slo = slo
        self.faults = faults or FaultInjector(FaultSpec())
        self.ladder = DegradationLadder(state, params, policy)
        # optional online adaptation: an ``repro_torch.adapt.AdaptController``
        # fed per dispatched batch; its re-plans re-pin residency (pinned) or
        # refresh the schedulers' value arrays (prefetch) in place — runtime
        # args only, the rungs' engines and buffers are untouched
        self.adapt = adapt
        self.scheds = self._fresh_residency()
        self.stats = FrontendStats()
        self._emb = state.bags[0].emb
        self._dev = state.device
        self._s0 = fcfg.service_unit_s        # wall seconds per service unit
        self._calibrated = False

    def _fresh_residency(self):
        """New cache state per the configured residency mode.

        ``prefetch`` is the oracle next-batch scheduler; ``pinned`` is static
        residency pinned to the offline plan's bet
        (:func:`repro_torch.adapt.replan.pinned_from_plan`) — the mode online
        adaptation exists to keep honest under drift.
        """
        if self.fcfg.residency == "pinned":
            from repro_torch.adapt import replan

            eplan = (self.adapt.eplan if self.adapt is not None
                     else self.state.eplan)
            return replan.pinned_from_plan(eplan)
        return self.state.fresh_schedulers()

    # -- execution ------------------------------------------------------------

    def _rows_for(self, idx: np.ndarray) -> np.ndarray:
        """(B, T, K) logical indices -> big-subtable rows (the cached stream)."""
        return np.stack(
            [big_rows(idx[:, t], self._emb) for t in range(self.cfg.num_tables)],
            axis=1,
        )

    def _head(self, dense: np.ndarray, pooled: torch.Tensor) -> torch.Tensor:
        dense_t = torch.from_numpy(np.ascontiguousarray(dense, dtype=np.float32))
        return dlrm.forward_from_pooled(self.params, dense_t.to(self._dev), pooled,
                                        self.cfg)

    def _dispatch_wall(self, idx: np.ndarray, dense: np.ndarray,
                       rows: np.ndarray) -> float:
        """Execute one batch end-to-end (gather + head), wait for the device;
        return wall seconds."""
        t0 = time.perf_counter()
        with obs.span("dispatch", cat="serve", rung=self.ladder.rung):
            pooled = self.ladder.pooled(idx, rows, self.scheds)
        with obs.span("interact", cat="serve"):
            self._head(dense, pooled)
        device_mod.synchronize(self._dev)
        return time.perf_counter() - t0

    def calibrate(self) -> float:
        """Warm every rung (first calls: builds, per-table engines) and fit
        the wall→virtual scale ``s0``.

        Runs on synthetic batches (``synthetic.dlrm_batch``, drawn on the
        CPU) so the arrival stream is untouched; the schedulers are rebuilt
        afterwards, so warm-up never pollutes the session's hit-rate
        accounting.
        """
        fcfg = self.fcfg
        b = synthetic.dlrm_batch(self.cfg, fcfg.batch_size, seed=17, step=0)
        idx = b["idx"].numpy()
        dense = b["dense"].numpy()
        rows = self._rows_for(idx)
        with obs.span("frontend_warmup", cat="offline"):
            self.ladder.warm(idx, rows, self.scheds)
            # warm the head on every rung's pooled dtype
            here = self.ladder.rung_i
            try:
                for i in range(len(RUNGS) - 1):
                    self.ladder.rung_i = i
                    pooled = self.ladder.pooled(idx, rows, self.scheds)
                    self._head(dense, pooled)
                    device_mod.synchronize(self._dev)
            finally:
                self.ladder.rung_i = here
            walls = []
            for k in range(max(1, fcfg.warmup_batches)):
                walls.append(self._dispatch_wall(idx, dense, rows))
        self._s0 = float(np.median(walls))
        self._calibrated = True
        self.scheds = self._fresh_residency()
        return self._s0

    def _service_s(self, wall_s: float) -> float:
        """Measured wall -> virtual service time per the configured mode."""
        if self.fcfg.service_mode == "fixed":
            return self.fcfg.service_unit_s
        return wall_s / max(self._s0, 1e-9) * self.fcfg.service_unit_s

    # -- admission ------------------------------------------------------------

    def _admit(self, pending, queue, now_s: float) -> None:
        st, fcfg = self.stats, self.fcfg
        while pending and pending[0].t_arrive_s <= now_s:
            r = pending.popleft()
            if self.ladder.shedding:
                st.shed_mode += 1
                obs.inc("serve/frontend/shed_mode")
            elif len(queue) >= fcfg.queue_cap:
                if fcfg.shed_policy == "reject_new":
                    st.shed_reject += 1
                    obs.inc("serve/frontend/shed_reject")
                else:                    # drop_oldest: evict, admit the new
                    queue.popleft()
                    st.shed_evict += 1
                    st.admitted += 1
                    queue.append(r)
                    obs.inc("serve/frontend/shed_evict")
            else:
                st.admitted += 1
                queue.append(r)

    # -- the serving loop -----------------------------------------------------

    def run(self, requests: list[Request]) -> dict:
        """Serve one request stream to completion; returns the full report."""
        fcfg, st = self.fcfg, self.stats
        if not self._calibrated:
            self.calibrate()
        pending = collections.deque(
            sorted(requests, key=lambda r: r.t_arrive_s)
        )
        st.generated = len(pending)
        queue: collections.deque = collections.deque()
        now = 0.0
        batch_i = 0
        req_lat: list[float] = []        # per-served/missed request latency
        batch_lat: list[float] = []
        guard = 0

        while pending or queue:
            guard += 1
            if guard > 100 * max(1, st.generated):
                raise RuntimeError("frontend made no progress (loop guard)")
            self._admit(pending, queue, now)

            if self.ladder.shedding:
                # drain tick: shed everything, let time pass, probe recovery
                while queue:
                    queue.popleft()
                    st.shed_mode += 1
                    obs.inc("serve/frontend/shed_mode")
                now += fcfg.service_unit_s
                self.faults.advance(now)
                self.ladder.on_batch(
                    batch_i=batch_i, now_s=now, alerts=(), fast_burn=0.0,
                    replica_lost=self.faults.replica_lost(),
                )
                batch_i += 1
                continue

            if not queue:
                if not pending:
                    break
                now = max(now, pending[0].t_arrive_s)
                continue

            # close on size-or-deadline: wait for a full batch only while the
            # oldest request's assembly window is still open
            close_t = queue[0].t_arrive_s + fcfg.assembly_timeout_s
            if len(queue) < fcfg.batch_size:
                nxt = pending[0].t_arrive_s if pending else float("inf")
                if nxt <= close_t:
                    now = max(now, nxt)
                    continue                 # admit the arrival first
                now = max(now, close_t)      # window expired: dispatch partial

            batch = self._take_batch(queue)
            done = self._dispatch_batch(batch, batch_i, now)
            if done is not None:
                now, blat = done
                batch_lat.append(blat)
                for r in batch:
                    lat = now - r.t_arrive_s
                    req_lat.append(lat)
                    if now <= r.deadline_s:
                        st.served += 1
                    else:
                        st.deadline_missed += 1
                obs.inc("serve/frontend/served_batch")
            batch_i += 1
            st.batches += 1

        return self._report(req_lat, batch_lat, now)

    def _take_batch(self, queue: collections.deque) -> list[Request]:
        """Pop the next batch per the configured queue order.

        ``fifo`` serves arrival order; ``edf`` picks the ``batch_size``
        requests with the earliest absolute deadlines (ties broken by
        arrival) — urgent requests jump the line, so under backlog the
        requests most likely to miss are exactly the ones dispatched first.
        Removal keeps the deque arrival-ordered either way, so the
        size-or-deadline assembly window (anchored at ``queue[0]``) and
        ``drop_oldest`` eviction are unaffected.
        """
        k = min(self.fcfg.batch_size, len(queue))
        if self.fcfg.queue_order == "fifo":
            return [queue.popleft() for _ in range(k)]
        picks = sorted(
            range(len(queue)),
            key=lambda i: (queue[i].deadline_s, queue[i].t_arrive_s),
        )[:k]
        batch = [queue[i] for i in picks]
        for i in sorted(picks, reverse=True):
            del queue[i]
        return batch

    def _dispatch_batch(self, batch: list[Request], batch_i: int,
                        now: float):
        """Dispatch with retry/backoff; returns (completion_s, batch_latency)
        or None when the batch is abandoned.  Advances fault state, feeds the
        SLO engine and the ladder either way."""
        fcfg, st = self.fcfg, self.stats
        spec = self.faults.spec
        B = fcfg.batch_size
        idx = np.stack([r.idx for r in batch]
                       + [batch[-1].idx] * (B - len(batch)))
        dense = np.stack([r.dense for r in batch]
                         + [batch[-1].dense] * (B - len(batch)))
        rows = self._rows_for(idx)
        if self.adapt is not None:          # sketch feed: O(bag) per batch
            self.adapt.observe(idx)

        self.faults.advance(now)
        stall = self.faults.consume_stall_s()
        if stall > 0:
            st.stall_s_injected += stall
            obs.inc("serve/frontend/stalls")

        if self.ladder.prefetch_enabled:
            if self.faults.consume_prefetch_drop():
                obs.inc("serve/frontend/prefetch_dropped")
            else:
                with obs.span("prefetch", cat="serve"):
                    for t in range(self.cfg.num_tables):
                        self.scheds[t].prefetch(rows[:, t])

        wall = None
        for attempt in range(spec.max_retries + 1):
            try:
                self.faults.check_gather()
                wall = self._dispatch_wall(idx, dense, rows)
                break
            except TransientGatherError:
                st.retries += 1
                obs.inc("serve/frontend/retries")
                if attempt >= spec.max_retries:
                    break
                now += spec.backoff_s(attempt)
                self.faults.advance(now)

        replica_lost = self.faults.replica_lost()
        if wall is None:                      # retries exhausted: abandon
            st.abandoned += len(batch)
            obs.inc("serve/frontend/abandoned", len(batch))
            # a failed batch is a bad event for the SLO — the ladder must see
            # the failure even though no latency was produced
            bad = 10.0 * (self.slo.spec.p99_latency_s or 1.0) if self.slo else 0.0
            alerts = self.slo.observe(bad) if self.slo else []
            fast = (self.slo.burn_rate(self.slo.spec.fast_window)
                    if self.slo else self.ladder.policy.enter_burn)
            self.ladder.on_batch(batch_i=batch_i, now_s=now, alerts=alerts,
                                 fast_burn=fast, replica_lost=replica_lost)
            return None

        service = self._service_s(wall) + stall
        done = now + service
        blat = done - min(r.t_arrive_s for r in batch)   # worst request
        alerts = self.slo.observe(blat) if self.slo else []
        fast = self.slo.burn_rate(self.slo.spec.fast_window) if self.slo else 0.0
        obs.observe("serve/frontend/batch_latency_s", blat)
        obs.observe_batch(batch=batch_i, mode="frontend", latency_s=blat)
        self.ladder.on_batch(batch_i=batch_i, now_s=done, alerts=alerts,
                             fast_burn=fast, replica_lost=replica_lost)
        if self.adapt is not None:
            self.adapt.step(self.scheds)
            self.adapt.maybe_refit(getattr(self.state, "drift", None))
        return done, blat

    # -- report ---------------------------------------------------------------

    def _report(self, req_lat: list[float], batch_lat: list[float],
                end_s: float) -> dict:
        st = self.stats
        stats = [s.stats for s in self.scheds]
        hits = sum(s.hits for s in stats)
        acc = sum(s.accesses for s in stats)
        recoveries = recovery_times(self.ladder.transitions)
        report = {
            "requests": st.describe(),
            "deadline_miss_rate": st.deadline_missed / max(1, st.generated),
            "shed_rate": st.shed_total / max(1, st.generated),
            "virtual_end_s": end_s,
            "virtual_qps": st.served / max(end_s, 1e-9),
            **{f"req_{k}": v
               for k, v in obs.latency_percentiles(req_lat).items()},
            **{f"batch_{k}": v
               for k, v in obs.latency_percentiles(batch_lat).items()},
            "hit_rate": hits / max(1, acc),
            "degrade": self.ladder.describe(),
            "recoveries_s": recoveries,
            "time_to_recover_s": max(recoveries) if recoveries else None,
            "faults_injected": list(self.faults.injected),
            "calibration": {
                "s0_wall_s": self._s0,
                "service_unit_s": self.fcfg.service_unit_s,
                "service_mode": self.fcfg.service_mode,
            },
            "frontend": self.fcfg.describe(),
        }
        if self.adapt is not None:
            report["adapt"] = {
                **self.adapt.summary(), "event_log": list(self.adapt.events),
            }
        if self.slo is not None:
            report["slo"] = self.slo.state()
        return report


def recovery_times(transitions: list[dict]) -> list[float]:
    """Virtual seconds from each departure-from-full to the next return.

    A degradation episode opens when the ladder leaves ``full`` and closes
    when it next arrives back; unfinished episodes are excluded (the report's
    ``time_to_recover_s`` is None when nothing recovered).
    """
    out: list[float] = []
    open_t: float | None = None
    for tr in transitions:
        if tr["from"] == "full" and open_t is None:
            open_t = tr["t_s"]
        if tr["to"] == "full" and open_t is not None:
            out.append(tr["t_s"] - open_t)
            open_t = None
    return out

