"""Quotient-remainder index math (port of ``repro.core.hashing``, QR part).

``qr_decompose`` takes a numpy array (the host-side planners) or a torch
tensor (the packed streams) and returns the same kind, int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QRSpec:
    """Static shape spec of a quotient-remainder factorization."""

    vocab: int          # logical rows
    collision: int      # hash collision value "c" (R-table rows)
    dim: int            # embedding dim of the reconstructed vector

    @property
    def q_rows(self) -> int:
        return -(-self.vocab // self.collision)  # ceil div

    @property
    def r_rows(self) -> int:
        return self.collision

    @property
    def compression(self) -> float:
        """Capacity reduction factor vs. the dense table."""
        dense = self.vocab * self.dim
        shared = (self.q_rows + self.r_rows) * self.dim
        return dense / shared

    def lut_bytes(self, bytes_per_elem: int = 4) -> int:
        """Size of the shared (R) table."""
        return self.r_rows * self.dim * bytes_per_elem


def qr_decompose(idx, collision: int):
    """Map logical indices to (quotient, remainder) physical indices, int32.

    Complementary partitions: (q, r) is unique per logical idx.
    """
    if isinstance(idx, torch.Tensor):
        idx = idx.to(torch.int32)
    else:
        idx = np.asarray(idx).astype(np.int32)
    return idx // collision, idx % collision
