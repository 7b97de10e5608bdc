"""Elastic scaling and fault-tolerance runtime policies (port of
``repro.distributed.elastic``).

* **Checkpoint/restart** — atomic checkpoints of full logical arrays
  (``repro_torch.checkpoint``), auto-resume from the newest step, the data
  pipeline's cursor kept beside them, batches a function of (seed, step):
  a restart replays the same batches.
* **Elastic re-mesh** — ``reshard_tree`` places a whole training state on a
  mesh of another shape (``(2, 2)`` -> ``(4, 1)``, or a degraded mesh after
  losing cards).  ``repro`` moves jax arrays between shardings inside one
  process; the port runs one process a rank (``launch.mesh.spawn``), so a
  new mesh is a new set of processes: each takes the full logical tree (a
  checkpoint's arrays) and keeps its own blocks on the new mesh.  The
  on-disk arrays are mesh-agnostic; only the blocks change.
* **Straggler mitigation** — bounded-staleness gradient exchange across
  pods: the ``pod`` axis all-reduce may be skipped for ``stale_limit``
  steps (``PodAsyncState``), trading exactness for tail-latency immunity.
* **Failure detection** — ``Heartbeat`` tracks per-host progress
  watermarks; a watermark that stalls past the deadline marks the host
  failed.  The serving fault harness (``repro_torch.serve.faults``) drives
  it on its virtual clock; ``degraded_mesh_shapes`` lists the meshes to
  restart on.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.distributed import sharding as SH


def reshard_tree(tree, axes_tree, new_mesh, rules=None):
    """This rank's blocks on ``new_mesh`` of every leaf of the full logical
    ``tree``, each leaf placed by its logical axes in ``axes_tree`` under
    ``rules`` (default ``DEFAULT_RULES``, as ``repro``'s); leaves that
    ``axes_tree`` does not describe are replicated.  ``sharding.gather``
    rebuilds a full leaf from the blocks."""
    rules = SH.DEFAULT_RULES if rules is None else rules
    return SH.shard_tree(tree, SH.tree_specs(tree, axes_tree, new_mesh, rules), new_mesh)


@dataclasses.dataclass
class Heartbeat:
    """Progress watermarks per host; a stalled watermark marks a failure.

    In a real deployment the watermark store is etcd/GCS; here it is an
    in-process dict with the same semantics, exercised by tests and the
    serving fault harness (``repro_torch.serve.faults``).

    ``clock`` is injectable (defaults to ``time.monotonic``) so tests and the
    fault harness can drive the watermarks on a virtual clock; per-call
    ``now=`` overrides still win.  A host may be :meth:`register`-ed before
    its first beat — such an *empty-beat* host counts as stalled once the
    deadline passes its registration time, and holds :meth:`min_step` at 0
    (it has proven no progress), instead of being invisible.
    """

    deadline_s: float = 300.0
    marks: dict = dataclasses.field(default_factory=dict)
    clock: "object" = time.monotonic          # () -> float, injectable

    def _now(self, now: float | None) -> float:
        return self.clock() if now is None else now

    def register(self, host: int, now: float | None = None) -> None:
        """Declare a host expected to beat (step ``None`` until it does).

        Without registration a host that dies before its first beat is
        invisible to :meth:`failed_hosts`; registering starts its deadline
        clock immediately.  Re-registering a beating host is a no-op.
        """
        if host not in self.marks:
            self.marks[host] = (None, self._now(now))

    def beat(self, host: int, step: int, now: float | None = None) -> None:
        self.marks[host] = (int(step), self._now(now))

    def failed_hosts(self, now: float | None = None) -> list[int]:
        """Hosts whose last beat (or registration) stalled past the deadline."""
        now = self._now(now)
        return [h for h, (_, t) in self.marks.items() if now - t > self.deadline_s]

    def min_step(self) -> int:
        """The fleet's progress watermark: the smallest step any known host
        has proven.  Empty-beat (registered, never beat) hosts pin it at 0;
        no hosts at all is also 0."""
        steps = [s for s, _ in self.marks.values()]
        if any(s is None for s in steps):
            return 0
        return min(steps, default=0)

    def alive_hosts(self, now: float | None = None) -> list[int]:
        """Complement of :meth:`failed_hosts` over the known hosts."""
        failed = set(self.failed_hosts(now))
        return [h for h in self.marks if h not in failed]


@dataclasses.dataclass
class PodAsyncState:
    """Bounded-staleness cross-pod gradient exchange.

    Within a pod, gradients all-reduce synchronously over ICI every step.
    Across pods (slow DCN), the exchange may lag up to ``stale_limit`` steps:
    each pod applies its local gradient immediately and folds in the other
    pods' *delayed* contribution when it arrives.  ``should_sync`` is the
    policy hook the train loop consults; tests assert convergence parity at
    stale_limit=0 and bounded divergence at small limits.
    """

    stale_limit: int = 4
    last_sync: int = 0

    def should_sync(self, step: int, *, pod_slow: bool = False) -> bool:
        if step - self.last_sync >= self.stale_limit:
            return True
        return not pod_slow

    def mark_synced(self, step: int) -> None:
        self.last_sync = step


def degraded_mesh_shapes(num_devices: int, model_axis: int) -> list[tuple[int, int]]:
    """Usable (data, model) shapes after losing devices (elastic fallback).

    Keeps the model axis intact (weights stay shardable) and shrinks data.
    """
    shapes = []
    d = num_devices // model_axis
    while d >= 1:
        shapes.append((d, model_axis))
        d //= 2
    return shapes
