"""Mesh construction and the hardware constants of one NVIDIA H100 (port of
``repro.launch.mesh``).

``repro`` runs its mesh programs SPMD inside one process (``shard_map`` over
``jax.make_mesh``).  The port runs one process per mesh rank under
``torch.distributed``: ``spawn`` starts the ranks (a ``file://``
rendezvous, so side-by-side runs need no TCP port) and ``make_mesh`` gives
each rank its ``Mesh``: the axis sizes, its coordinates and one process
group per axis (its line of ranks along that axis), over which
``distributed.collectives.psum`` is ``repro``'s ``jax.lax.psum``.

Rates are the NVIDIA H100 Tensor Core GPU datasheet's, SXM5 column (dense,
without sparsity), at the card's full power limit of 700 W; a card set
below it runs slower under load.  The names ``obs.attribution`` reads
(``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW_PER_LINK``) are ``repro``'s, so
the attribution reads like the reference.  ``DISPATCH_OVERHEAD_S`` is the
one number measured here rather than read from the datasheet.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import signal
import sys
import time
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

# datasheet, H100 SXM5: bf16 Tensor Core 989 TFLOP/s (dense)
PEAK_FLOPS_BF16 = 989e12
# datasheet, H100 SXM5: FP32 67 TFLOP/s (CUDA cores)
PEAK_FLOPS_FP32 = 67e12
# datasheet, H100 SXM5: GPU memory bandwidth 3.35 TB/s (HBM3)
HBM_BW = 3.35e12
# datasheet, H100 SXM5: GPU memory 80 GB
HBM_PER_CHIP = 80e9
# datasheet, H100 SXM5: NVLink 900 GB/s, the sum over its 18 NVLink-4 links
# of both directions
NVLINK_BW = 900e9
NVLINK_LINKS = 18
# one NVLink link, both directions: 900 GB/s / 18 = 50 GB/s (the attribution
# prices a cross-card combine at two of them, as repro prices two ICI links)
ICI_BW_PER_LINK = NVLINK_BW / NVLINK_LINKS
# datasheet, H100 SXM5: PCIe Gen5 128 GB/s (x16, both directions); the host
# link one way is half of it
HOST_LINK_BW = 128e9 / 2

# Host cost of one kernel launch through the port's wrappers: a one-table
# bag's back-to-back time minus its time replayed in a CUDA graph, the median
# over K4b, K6, K4a and K7 at (2,048, 32) (0.0372, 0.0316, 0.0343, 0.0139 ms),
# read from chip_smoke.py's "launch overhead" line on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit.  It varies from run to run with the host.
DISPATCH_OVERHEAD_S = 33.0e-6


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the device mesh.

    ``shape`` maps each axis name to its size, in mesh order (as
    ``jax.sharding.Mesh.shape`` does); ``coords`` holds this rank's
    coordinate along each axis (``jax.lax.axis_index``); ``groups`` the
    process group of this rank's line along each axis (the ranks a ``psum``
    over that axis combines).  ``device`` is the rank's device, ``backend``
    the process groups' (``gloo`` or ``nccl``; ``meta`` for an
    ``abstract_mesh``, which has no groups).
    """

    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device=None) -> Mesh:
    """This rank's ``Mesh`` over the initialized default process group.

    Ranks are laid out row-major over ``shape`` (rank = its coordinates'
    row-major index, as ``jax.make_mesh`` orders devices).  Every rank must
    call it with the same arguments: each axis gets one ``new_group`` per
    line of ranks along it, created by all ranks in one order.  ``device``
    is the rank's device (the card unless ``"cpu"``)."""
    from repro_torch import device as device_mod

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(launch.mesh.spawn, or torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the group has {world}")
    coords = [int(c) for c in np.unravel_index(rank, shape)]
    groups = {}
    for a, ax in enumerate(axes):
        others = [range(s) for i, s in enumerate(shape) if i != a]
        for rest in itertools.product(*others):
            members = []
            for c in range(shape[a]):
                full = list(rest)
                full.insert(a, c)
                members.append(int(np.ravel_multi_index(full, shape)))
            group = dist.new_group(members)
            if rank in members:
                groups[ax] = group
    return Mesh(shape=dict(zip(axes, shape)), coords=dict(zip(axes, coords)),
                groups=groups, device=device_mod.resolve(device),
                backend=dist.get_backend())


def abstract_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
                  coords: tuple[int, ...] | None = None) -> Mesh:
    """One rank's ``Mesh`` with no process group: the rank at ``coords``
    (default the first) of a ``shape`` mesh, on the ``meta`` device, with
    backend ``"meta"``.  The dry run traces a rank's step on it: the
    collectives count their calls on meta tensors and call nothing in
    ``torch.distributed``."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    coords = tuple(0 for _ in shape) if coords is None else tuple(int(c) for c in coords)
    if len(coords) != len(shape) or any(not 0 <= c < n for c, n in zip(coords, shape)):
        raise ValueError(f"coordinates {coords} are not a rank of the mesh {shape}")
    return Mesh(shape=dict(zip(axes, shape)), coords=dict(zip(axes, coords)), groups={},
                device=torch.device("meta"), backend="meta")


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         coords: tuple[int, ...] | None = None) -> Mesh:
    """``repro``'s production mesh shape, (16, 16) or (2, 16, 16); on
    ``device="meta"`` the ``abstract_mesh`` of the rank at ``coords``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is not None and torch.device(device).type == "meta":
        return abstract_mesh(shape, axes, coords)
    return make_mesh(shape, axes, device=device)


# ---------------------------------------------------------------------------
# one process per rank
# ---------------------------------------------------------------------------

def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _result_path(init_file: str, rank: int) -> Path:
    return Path(f"{init_file}.rank{rank}.pt")


def _rank_main(rank, fn, shape, axes, args, device_type, backend, init_file, timeout_s,
               threads):
    world = math.prod(shape)
    if device_type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        # the ranks share the parent's intra-op threads (the host's cores
        # unless the caller asked for fewer)
        torch.set_num_threads(max(1, threads // world))
    dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(shape, axes, device=dev)
        result = fn(mesh, *args)
        torch.save(_to_cpu(result), _result_path(init_file, rank))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, shape: tuple[int, ...], *, axes: tuple[str, ...] = ("data", "model"),
          args: Sequence = (), device=None, backend: str, init_file: str | os.PathLike,
          timeout_s: float = 300.0, forward_signals: Sequence[int] = ()) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``shape`` mesh, one process
    per rank (``torch.multiprocessing``, ``spawn`` start method), and return
    each rank's return value in rank order, its tensors moved to the CPU.

    ``fn`` must be importable by name (a module-level function); ``args``
    are pickled to every rank.  ``backend`` is explicit: ``nccl`` where each
    rank has a card of its own, ``gloo`` where ranks share one card or run
    on the CPU (NCCL refuses two ranks on one device); with ``gloo`` on the
    card the kernels run on the card and only the combine crosses the host.
    ``device`` is the ranks' device type (the card unless ``"cpu"``): rank r
    takes card ``r % device_count``.  ``init_file`` is the rendezvous file
    (it must not be in use; results land beside it).  Every process group
    has ``timeout_s``, so a rank stuck in a collective fails the run, and
    the whole run fails with ``TimeoutError`` past ``timeout_s``; a rank's
    exception ends every rank and is raised here.  Build the CUDA kernels
    before spawning, so that the ranks do not race the build.  Each signal
    of ``forward_signals`` that reaches this process while the ranks run is
    sent on to every rank (a preempted launcher's SIGTERM: the ranks decide
    together when to stop).
    """
    import torch.multiprocessing as mp

    from repro_torch import device as device_mod

    world = math.prod(shape)
    dev_type = device_mod.resolve(device).type
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: choose gloo or nccl")
    if backend == "nccl" and (dev_type != "cuda" or world > torch.cuda.device_count()):
        raise ValueError(f"nccl needs one card a rank: {world} ranks, "
                         f"{torch.cuda.device_count() if dev_type == 'cuda' else 0} cards; "
                         f"use gloo")
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    where = f"{min(world, cards)} card(s)" if dev_type == "cuda" else "the CPU"
    print(f"[mesh] {world} ranks, mesh {tuple(shape)} over {tuple(axes)}, backend "
          f"{backend}, on {where}", file=sys.stderr, flush=True)
    init_file = str(Path(init_file).resolve())
    for path in [Path(init_file)] + [_result_path(init_file, r) for r in range(world)]:
        path.unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(shape), tuple(axes), tuple(args), dev_type, backend,
                          init_file, timeout_s, torch.get_num_threads()),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s

    def _forward(signum, frame):
        for p in ctx.processes:
            if p.is_alive():
                os.kill(p.pid, signum)

    previous = {s: signal.signal(s, _forward) for s in forward_signals}
    try:
        while not ctx.join(timeout=0.5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish within {timeout_s} s")
    finally:
        for s, handler in previous.items():
            signal.signal(s, handler)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r in range(world):
        path = _result_path(init_file, r)
        # written by this function's own ranks just above
        results.append(torch.load(path, weights_only=False))
        path.unlink()
    return results
