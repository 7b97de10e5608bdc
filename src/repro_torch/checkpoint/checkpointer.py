"""Atomic checkpointing with auto-resume (port of
``repro.checkpoint.checkpointer``), in ``repro``'s on-disk layout.

Layout: ``<dir>/step_<N:08d>/`` holding one ``leaf_<i:05d>.npy`` per leaf of
the tree and a ``manifest.json`` (step, each leaf's path, file, shape and
dtype, and the caller's ``extra``, such as the data-pipeline cursor).  Leaves
are in JAX's flatten order and named by their paths (``repro_torch.tree``),
so a checkpoint ``repro`` wrote restores here, and one written here restores
in ``repro``.  A save goes to ``step_<N>.tmp`` and is renamed only after the
manifest is synced: a write cut at any moment leaves the newest complete
checkpoint loadable.

numpy has no bfloat16: a bf16 leaf is stored as its 16 bits (int16) with
``"bfloat16"`` as its manifest dtype, and restored bit for bit.

On a mesh (one process a rank, ``launch.mesh``) the format is the same
full logical arrays, so a checkpoint restores on any mesh shape, on one
card, and in ``repro``.  ``save`` with ``mesh`` and ``specs`` (one per leaf,
``sharding.tree_specs``) gathers each leaf from the ranks' blocks, one leaf
at a time; the rank at coordinates 0 on every axis writes, and every rank
waits at a barrier until the rename has landed.  ``restore`` with them
reads the full arrays and keeps this rank's blocks.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree
from repro_torch.distributed import sharding as SH

BF16 = "bfloat16"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def is_writer(mesh) -> bool:
    """Whether this rank writes a meshed checkpoint (coordinates all 0)."""
    return mesh is None or not any(mesh.coords.values())


def _specs(state, mesh, specs) -> list:
    n = len(tree.leaves(state))
    if mesh is None:
        return [None] * n
    if specs is None or len(specs) != n:
        raise ValueError(f"a meshed checkpoint needs one spec per leaf ({n} leaves)")
    return list(specs)


def save(directory: str, step: int, state, *, extra: dict | None = None, mesh=None,
         specs=None) -> str:
    """Atomically persist the tree ``state`` (+ json-serialisable ``extra``).
    With ``mesh``, ``state`` is this rank's blocks under ``specs``: every
    rank must call it; the full leaves are written once."""
    import torch.distributed as dist

    writer = is_writer(mesh)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, ((path, leaf), spec) in enumerate(zip(tree.leaves_with_paths(state),
                                                 _specs(state, mesh, specs))):
        if spec is not None:
            leaf = SH.gather(leaf, spec, mesh)
        if not writer:
            continue
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if mesh is not None:
        dist.barrier()
    return final


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, like, *, mesh=None, specs=None):
    """Load a checkpoint into the structure of ``like``: each leaf keeps the
    dtype it was saved with and goes to the device of ``like``'s leaf.  The
    leaves' paths and shapes must match.  With ``mesh``, ``like`` holds this
    rank's blocks under ``specs`` and each full leaf gives its block.
    Returns (tree, extra)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = list(tree.leaves_with_paths(like))
    if len(manifest["leaves"]) != len(want):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(want)}")
    out = []
    for rec, (leaf_path, like_leaf), spec in zip(manifest["leaves"], want,
                                                 _specs(like, mesh, specs)):
        if rec["path"] != leaf_path:
            raise ValueError(f"checkpoint leaf {rec['path']!r} where {leaf_path!r} is expected")
        arr = np.load(os.path.join(path, rec["file"]))
        shape = tuple(like_leaf.shape) if spec is None else SH.full_shape(like_leaf, spec, mesh)
        if tuple(arr.shape) != shape:
            raise ValueError(f"leaf {rec['path']}: shape {arr.shape} != {shape}")
        t = torch.from_numpy(arr)
        if rec["dtype"] == BF16:
            t = t.view(torch.bfloat16)
        if spec is not None:
            t = SH.local_shard(t, mesh, spec)
        out.append(t.to(like_leaf.device))
    return tree.unflatten(like, out), manifest.get("extra", {})


def prune(directory: str, keep: int = 3) -> None:
    """Keep only the newest ``keep`` checkpoints (bounded disk)."""
    for s in _steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
