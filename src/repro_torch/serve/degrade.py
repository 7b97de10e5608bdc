"""The graceful-degradation ladder: trade technique for survivability (port
of ``repro.serve.degrade``).

ProactivePIM's serving wins stack three techniques — the packed kernel, the
proactive SRAM cache, and subtable duplication.  Each is also a dependency
that can misbehave under stress, so the ladder orders the execution paths
from fastest to most conservative and walks down one rung at a time when the
SLO burns or a fault lands:

====  ==========  ====================================================
rung  name        execution path
====  ==========  ====================================================
0     full        packed kernel (K1 / K3 / K2) + prefetch cache (the
                  normal path): one launch a batch
1     nocache     the same launch, all-miss slot map, prefetch stopped
2     pertable    one single-table packed plan per table: the same
                  kernel launched once per table (no shared layout, no
                  cross-table blast radius)
3     baseline    ``embedding_bag.multi_bag_lookup``, the per-table
                  semantic loop (plain gathers in the compute dtype; a TT
                  table with ``tt_exec="pallas"`` runs K5)
4     shed        stop admitting; drain and recover
====  ==========  ====================================================

Numerics contract (``repro``'s, held by ``tests/test_torch_frontend.py`` on
the CPU and ``tests/test_torch_gpu.py`` on the card): rungs 0–2 run the same
kernel and sum each bag in the same order (a cache hit loads the cache
row, a bit copy of the table row; one table's launch sums as the 26-table
launch does), so their pooled outputs are **bitwise identical** — a
mid-stream rung change is invisible to the model.  Rung 3 is a different
numeric program (sums in the compute dtype), so it matches the kernel rungs
only to float tolerance — documented, by design.

Transitions are governed by hysteresis (no rung change within
``hysteresis_batches`` of the last one) and recover by probing: after
``probe_after`` consecutive good batches the ladder steps *up* one rung and
watches whether the burn returns.  Replica loss clamps the ladder at
``floor_on_replica_loss`` or below until the replica's heartbeat returns.
Every transition goes through ``repro_torch.obs`` (a counter + an instant
event), so flight-recorder dumps show exactly when and why the ladder moved.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import engine as engine_mod
from repro_torch import obs
from repro_torch.core import embedding_bag, packed_tables

RUNGS = ("full", "nocache", "pertable", "baseline", "shed")


@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """When the ladder moves.

    ``enter_burn`` — a fast-window burn rate at/above this (or any page
    alert) steps down one rung; ``recover_burn`` — a batch only counts
    toward the recovery streak when the fast burn is strictly below it.
    """

    enter_burn: float = 10.0
    recover_burn: float = 1.0
    hysteresis_batches: int = 2
    probe_after: int = 4
    floor_on_replica_loss: str = "pertable"

    def __post_init__(self):
        if self.floor_on_replica_loss not in RUNGS:
            raise ValueError(
                f"unknown floor rung {self.floor_on_replica_loss!r}"
            )

    def describe(self) -> dict:
        return {
            "enter_burn": self.enter_burn,
            "recover_burn": self.recover_burn,
            "hysteresis_batches": self.hysteresis_batches,
            "probe_after": self.probe_after,
            "floor_on_replica_loss": self.floor_on_replica_loss,
        }


class DegradationLadder:
    """Owns every rung's executable path plus the transition state machine.

    ``state`` is the serve-front ``ServeState`` (the engine and its device);
    ``params`` the DLRM params whose tables the rungs gather from.  The
    per-table engines and their packed buffers are built lazily on first
    use and kept; :meth:`warm` runs every rung once so a mid-storm
    transition never pays a first call inside a latency sample.
    """

    def __init__(self, state, params, policy: DegradePolicy | None = None):
        self.state = state
        self.params = params
        self.policy = policy or DegradePolicy()
        self.rung_i = 0
        self.transitions: list[dict] = []
        self.batches_at = {r: 0 for r in RUNGS}
        self._good_streak = 0
        self._last_transition_batch = -10**9
        self._replica_floor_active = False

        eng = state.engine
        self._dev = state.device
        self._packed = eng.pack(params["tables"])
        total_slots = int(sum(state.slot_budgets))
        # all-miss launches still pass a cache block of the plan's shape
        # (values unreachable: slot=-1)
        self._zero_cache_rows = torch.zeros(max(1, total_slots), dtype=torch.int32,
                                            device=self._dev)
        self._pertable = None       # built lazily: [(engine, packed, zeros)]

    # -- rung state ------------------------------------------------------------

    @property
    def rung(self) -> str:
        return RUNGS[self.rung_i]

    @property
    def shedding(self) -> bool:
        return self.rung == "shed"

    @property
    def prefetch_enabled(self) -> bool:
        """Only the full rung stages rows (the cache is bypassed below it)."""
        return self.rung == "full"

    # -- execution paths -------------------------------------------------------

    def _pertable_paths(self):
        if self._pertable is None:
            spec = self.state.engine.spec
            paths = []
            for t, bag in enumerate(self.state.bags):
                spec_t = spec.replace(bags=(bag,), duplication=False)
                eng_t = engine_mod.compile(engine_mod.plan(spec_t, num_shards=1))
                packed_t = eng_t.pack([self.params["tables"][t]])
                zeros_t = torch.zeros(max(1, int(sum(eng_t.plan.slot_budgets))),
                                      dtype=torch.int32, device=self._dev)
                paths.append((eng_t, packed_t, zeros_t))
            self._pertable = paths
        return self._pertable

    def pooled(self, idx_np: np.ndarray, rows_np: np.ndarray, scheds):
        """One batch's pooled embeddings via the current rung.

        ``idx_np`` (B, T, K) logical indices; ``rows_np`` (B, T, K) the
        big-subtable rows (the cached stream); ``scheds`` the live prefetch
        schedulers (consumed only on the full rung).  Returns (B, T, dim)
        on the state's device: fp32 on the kernel rungs, the compute dtype
        on ``baseline``.
        """
        rung = self.rung
        if rung == "shed":
            raise RuntimeError("ladder is shedding; no batches may dispatch")
        eng = self.state.engine
        idx = torch.from_numpy(np.array(idx_np, dtype=np.int32)).to(self._dev)
        if rung == "full":
            slot = np.stack(
                [scheds[i].slots_for(rows_np[:, i])
                 for i in range(len(scheds))], axis=1,
            )
            cache_rows = eng.packed_cache_rows(scheds)
            return eng.serve_gather(
                self._packed, idx, torch.from_numpy(slot).to(self._dev),
                torch.from_numpy(cache_rows).to(self._dev),
            )
        if rung == "nocache":
            return eng.serve_gather(
                self._packed, idx, packed_tables.miss_slots(idx),
                self._zero_cache_rows,
            )
        if rung == "pertable":
            parts = []
            for t, (eng_t, packed_t, zeros_t) in enumerate(self._pertable_paths()):
                idx_t = idx[:, t:t + 1]
                parts.append(eng_t.serve_gather(
                    packed_t, idx_t, packed_tables.miss_slots(idx_t), zeros_t,
                ))
            return torch.cat(parts, dim=1)
        with torch.no_grad():
            return embedding_bag.multi_bag_lookup(
                self.params["tables"], idx, list(self.state.bags))

    def warm(self, idx_np: np.ndarray, rows_np: np.ndarray, scheds) -> None:
        """Run every executable rung once on a sample batch (setup time)."""
        here = self.rung_i
        try:
            for i, r in enumerate(RUNGS[:-1]):
                self.rung_i = i
                self.pooled(idx_np, rows_np, scheds)
                device_mod.synchronize(self._dev)
        finally:
            self.rung_i = here

    # -- transition state machine ---------------------------------------------

    def _floor_i(self) -> int:
        if self._replica_floor_active:
            return RUNGS.index(self.policy.floor_on_replica_loss)
        return 0

    def _move(self, to_i: int, *, batch_i: int, now_s: float, reason: str):
        frm, to = self.rung, RUNGS[to_i]
        self.rung_i = to_i
        self._good_streak = 0
        self._last_transition_batch = batch_i
        self.transitions.append({
            "at_batch": batch_i, "t_s": float(now_s),
            "from": frm, "to": to, "reason": reason,
        })
        obs.inc(f"serve/degrade/to_{to}")
        obs.inc("serve/degrade/transitions")
        obs.instant("degrade_transition", cat="serve",
                    frm=frm, to=to, reason=reason, batch=batch_i)

    def on_batch(self, *, batch_i: int, now_s: float, alerts=(),
                 fast_burn: float = 0.0, replica_lost: bool = False) -> None:
        """Feed one completed (or attempted) batch's signals; maybe move.

        ``alerts`` are the SLO engine's fired alerts for this observation,
        ``fast_burn`` its current fast-window burn rate.  Replica loss is
        level-triggered: while asserted the ladder cannot sit above the
        policy floor, and its onset bypasses hysteresis (a half-lost mesh
        cannot wait politely).
        """
        pol = self.policy
        self.batches_at[self.rung] += 1

        if replica_lost and not self._replica_floor_active:
            self._replica_floor_active = True
            floor = RUNGS.index(pol.floor_on_replica_loss)
            if self.rung_i < floor:
                self._move(floor, batch_i=batch_i, now_s=now_s,
                           reason="replica_loss")
                return
        elif not replica_lost:
            self._replica_floor_active = False

        burning = (fast_burn >= pol.enter_burn
                   or any(a.get("severity") == "page" for a in alerts))
        settled = batch_i - self._last_transition_batch >= pol.hysteresis_batches

        if burning:
            self._good_streak = 0
            if settled and self.rung_i < len(RUNGS) - 1:
                self._move(self.rung_i + 1, batch_i=batch_i, now_s=now_s,
                           reason=f"burn={fast_burn:.1f}")
            return

        if fast_burn < pol.recover_burn and not alerts:
            self._good_streak += 1
            floor = self._floor_i()
            if (self._good_streak >= pol.probe_after and settled
                    and self.rung_i > floor):
                self._move(self.rung_i - 1, batch_i=batch_i, now_s=now_s,
                           reason=f"recovery_probe(streak={self._good_streak})")
        else:
            self._good_streak = 0

    def describe(self) -> dict:
        """JSON state: rung occupancy + the full transition log."""
        return {
            "rung": self.rung,
            "policy": self.policy.describe(),
            "batches_at": dict(self.batches_at),
            "transitions": list(self.transitions),
        }
