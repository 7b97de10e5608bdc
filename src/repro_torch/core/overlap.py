"""Compute/communication overlap helpers (port of ``repro.core.overlap``).

The PIM design hides GnR latency behind the dense compute stream.  In
``repro`` the two branches are independent subgraphs that XLA's scheduler
may overlap, and a chunked psum lets ICI transfers interleave with compute.
"""

from __future__ import annotations

from typing import Callable, TypeVar

import torch

from repro_torch.distributed import collectives

T = TypeVar("T")
U = TypeVar("U")


def parallel_branches(f: Callable[..., T], g: Callable[..., U], fa, ga) -> tuple[T, U]:
    """Evaluate two independent branches, ``f(*fa)`` then ``g(*ga)``.

    PyTorch runs eagerly and enqueues each branch's kernels on the card in
    call order; nothing here ties one branch to the other's results, which
    is all ``repro``'s version promises (its overlap is XLA's to find).
    Plain sequential calls are therefore the whole port: running the
    branches on two CUDA streams is a scheduling choice ``repro`` does not
    make either."""
    return f(*fa), g(*ga)


def chunked_psum(x: torch.Tensor, mesh, axis: str, *, chunks: int = 1) -> torch.Tensor:
    """psum over ``axis`` split into ``chunks`` along the last dim; chunks=1
    is a plain psum."""
    if chunks <= 1:
        return collectives.psum(x, mesh, axis)
    parts = torch.chunk(x, chunks, dim=-1)
    if len(parts) != chunks or any(p.shape != parts[0].shape for p in parts):
        raise ValueError(f"last dim {x.shape[-1]} does not split into {chunks} equal chunks")
    return torch.cat([collectives.psum(p, mesh, axis) for p in parts], dim=-1)
