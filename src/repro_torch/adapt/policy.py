"""The "is re-planning worthwhile?" trigger and the adaptation controller
(port of ``repro.adapt.policy``).

Swapping cache residency is cheap but not free (the swap stages rows over
the same copy path the prefetcher uses), and the full offline ``plan()``
rebuild costs whole batches of wall clock plus a new engine and packed
buffers.  The policy
prices both against the sketch-predicted hit-rate gain:

    act  iff  gain >= min_gain  and  gain * horizon_batches >= cost_batches

— the gain must clear a hysteresis floor *and* pay back its modeled cost
within the payback horizon.  A cooldown after every action keeps flapping
traffic (a hot set oscillating faster than the cooldown) from thrashing the
cache; together floor + cooldown are the two anti-thrash guards.

:class:`AdaptController` owns the loop-facing state: per-table frequency
sketches over *logical* ids (updated O(bag) per batch), the cached
logical->big-row fold, trigger evaluation every ``check_every`` batches, and
the drift-refit hook — when ``obs.drift.DriftMonitor.refit_recommended``
flips, the controller invokes a caller-supplied refit callback (re-fit the
tuner cost model, full re-plan, swap the engine) *from inside the serving
loop*, then re-arms.  Every decision lands in obs as a counter bump + an
instant event, so re-plan activity is visible in flight-recorder dumps (the
recorder snapshots counter deltas per batch) and Chrome traces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch import obs
from repro_torch.engine.plan import big_subtable as _big_subtable
from repro_torch.adapt import replan
from repro_torch.adapt.sketch import FrequencySketch


@dataclasses.dataclass(frozen=True)
class AdaptPolicy:
    """Trigger thresholds and modeled costs (all in batch-equivalents).

    ``min_gain`` doubles as the sampling-noise floor: the sketch's own top-k
    always looks better than the true-distribution pin under the sketch's
    empirical estimate (ranking and evaluation share the sample), an overfit
    bias that decays as mass accumulates but plateaus near 0.04-0.08 on
    stationary Zipf smoke traffic.  The default floor sits ~2x above that
    plateau and ~2x below the post-rotation gain (0.2+), so stationary
    traffic holds and real drift fires; ``min_batches`` keeps the trigger
    quiet while the bias is still warmup-sized.
    """

    check_every: int = 8          # batches between trigger evaluations
    min_batches: int = 12         # sketch warmup before any action
    min_gain: float = 0.10        # hysteresis floor on predicted hit-rate gain
    horizon_batches: int = 64     # payback horizon for the cost model
    swap_cost_batches: float = 1.0    # modeled cost of an incremental swap
    full_gain: float = 0.30       # floor before a full plan() rebuild
    full_cost_batches: float = 32.0   # modeled cost of plan() + a new engine
    cooldown_batches: int = 8     # quiet period after any action
    refit_cooldown_batches: int = 64  # quiet period after a drift refit

    def swap_worthwhile(self, gain: float) -> bool:
        return (
            gain >= self.min_gain
            and gain * self.horizon_batches >= self.swap_cost_batches
        )

    def full_worthwhile(self, gain: float) -> bool:
        return (
            gain >= self.full_gain
            and gain * self.horizon_batches >= self.full_cost_batches
        )

    def describe(self) -> dict:
        return dataclasses.asdict(self)


class AdaptController:
    """Online adaptation driver: sketches -> trigger -> runtime-arg swap.

    ``full_hook``/``refit_hook`` are optional callbacks owning the expensive
    paths (they typically rebuild the plan and the engine); the controller
    only decides *when*.  Without hooks it degrades gracefully to
    incremental-only adaptation.
    """

    def __init__(
        self,
        eplan,
        *,
        policy: AdaptPolicy | None = None,
        sketch_kw: dict | None = None,
        full_hook: Callable[["AdaptController"], dict] | None = None,
        refit_hook: Callable[["AdaptController"], dict] | None = None,
        seed: int = 0,
    ):
        self.eplan = eplan
        self.policy = policy or AdaptPolicy()
        self.full_hook = full_hook
        self.refit_hook = refit_hook
        kw = dict(sketch_kw or {})
        self.sketches = [
            FrequencySketch(bag.emb.vocab, seed=seed * 100 + t, **kw)
            for t, bag in enumerate(eplan.bags)
        ]
        self._big_ids = [replan.big_id_map(bag.emb) for bag in eplan.bags]
        self._big_rows = [
            _big_subtable(bag.emb)[1] for bag in eplan.bags
        ]
        self.batch_i = 0
        self._last_action = -(10**9)
        self._last_refit = -(10**9)
        self.events: list[dict] = []

    # ---- observation ----------------------------------------------------

    def fresh_caches(self) -> list[replan.PinnedCache]:
        """Pinned caches seeded from the (possibly re-planned) offline bet."""
        return replan.pinned_from_plan(self.eplan)

    def observe(self, idx: np.ndarray) -> None:
        """Fold one batch of logical indices in: ``idx`` is (B, T, K)."""
        idx = np.asarray(idx)
        for t, sk in enumerate(self.sketches):
            sk.update(idx[:, t])
        self.batch_i += 1

    def big_estimates(self) -> list[np.ndarray]:
        """Sketch estimates folded onto big-subtable rows, per table."""
        return [
            replan.fold_to_big(sk.estimate_all(), ids, rows)
            for sk, ids, rows in zip(self.sketches, self._big_ids, self._big_rows)
        ]

    # ---- decisions ------------------------------------------------------

    def evaluate(self, caches) -> dict:
        """Predicted gain of re-pinning now (no side effects).

        Gain is the access-mass-weighted coverage delta between the sketch's
        best pin and the currently resident rows, under the sketch's own
        estimate of live traffic.
        """
        ests = self.big_estimates()
        update = replan.incremental_update(ests, self.eplan.slot_budgets)
        cur_mass, mass = 0.0, 0.0
        for est, cache in zip(ests, caches):
            rows = (
                cache.pinned_rows()
                if hasattr(cache, "pinned_rows")
                else cache.cache_rows()
            )
            cur_mass += float(est[np.asarray(rows, dtype=np.int64)].sum())
            mass += float(est.sum())
        current_hit = cur_mass / mass if mass > 0 else 0.0
        return {
            "batch": self.batch_i,
            "predicted_hit": update.predicted_hit,
            "current_hit": current_hit,
            "gain": update.predicted_hit - current_hit,
            "update": update,
        }

    def step(self, caches) -> dict | None:
        """Run the trigger; apply + record an action when it fires.

        Returns the event dict (kind ``replan`` or ``replan_full``) or None.
        """
        pol = self.policy
        if self.batch_i < pol.min_batches or self.batch_i % pol.check_every:
            return None
        if self.batch_i - self._last_action < pol.cooldown_batches:
            obs.inc("serve/adapt/cooldown_skips")
            return None
        ev = self.evaluate(caches)
        gain = ev["gain"]
        obs.set_gauge("serve/adapt/predicted_gain", gain)
        if self.full_hook is not None and pol.full_worthwhile(gain):
            result = self.full_hook(self)
            event = {
                "kind": "replan_full", "batch": self.batch_i,
                "gain": round(gain, 4), **(result or {}),
            }
            obs.inc("serve/adapt/replan_full")
            obs.instant("adapt_replan_full", cat="adapt",
                        batch=self.batch_i, gain=round(gain, 4))
        elif pol.swap_worthwhile(gain):
            staged = ev["update"].apply(caches)
            event = {
                "kind": "replan", "batch": self.batch_i,
                "gain": round(gain, 4), "staged_rows": int(staged),
                "predicted_hit": round(ev["predicted_hit"], 4),
            }
            obs.inc("serve/adapt/replan")
            obs.inc("serve/adapt/staged_rows", int(staged))
            obs.instant("adapt_replan", cat="adapt", batch=self.batch_i,
                        gain=round(gain, 4), staged_rows=int(staged))
        else:
            obs.inc("serve/adapt/holds")
            return None
        self._last_action = self.batch_i
        self.events.append(event)
        return event

    def maybe_refit(self, monitor) -> dict | None:
        """Act on ``DriftMonitor.refit_recommended`` — the autotuner's online
        re-fit, executed mid-serve through ``refit_hook`` (no restart)."""
        if monitor is None or self.refit_hook is None:
            return None
        if not monitor.refit_recommended:
            return None
        if self.batch_i - self._last_refit < self.policy.refit_cooldown_batches:
            return None
        summary = monitor.summary()
        result = self.refit_hook(self)
        event = {
            "kind": "refit", "batch": self.batch_i,
            "drift": summary, **(result or {}),
        }
        obs.inc("serve/adapt/refit")
        obs.instant(
            "adapt_refit", cat="adapt", batch=self.batch_i,
            reasons=",".join(summary.get("reasons", [])) or "drift",
        )
        self._last_refit = self.batch_i
        self._last_action = self.batch_i
        self.events.append(event)
        return event

    def summary(self) -> dict:
        counts: dict[str, int] = {}
        for ev in self.events:
            counts[ev["kind"]] = counts.get(ev["kind"], 0) + 1
        return {
            "batches": self.batch_i,
            "events": counts,
            "policy": self.policy.describe(),
        }
