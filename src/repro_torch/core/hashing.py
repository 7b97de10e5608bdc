"""Weight-sharing index math (port of ``repro.core.hashing``: the
quotient-remainder split, the hashing trick's universal hash, and the
row-shard owners of the two-level sharded GnR).

``qr_decompose``, ``universal_hash`` and ``k_ary_hash`` take a numpy array
(the host-side planners) or a torch tensor (the lookups) and return the
same kind, int32.  ``repro`` hashes in uint32 with wrap-around; the port
computes in int64 and masks to the low 32 bits after every add and
multiply, which gives the same bits (a product of two 32-bit values may
wrap int64, but its low 32 bits stay right).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# repro's multiply-shift constants (hashing.py:27-30), as int64
_MULTIPLIERS = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F, 0x165667B1, 0x9E3779B9)
_SEED_STEP = 0x517CC1B7
_MIX = 0x2C1B3C6D
_MASK = 0xFFFFFFFF


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


def universal_hash(idx, buckets: int, seed: int = 0):
    """Multiply-shift universal hash of int indices into ``[0, buckets)``,
    bit for bit ``repro``'s uint32 arithmetic; int32 out."""
    if isinstance(idx, torch.Tensor):
        h = idx.to(torch.int64)
    else:
        h = np.asarray(idx).astype(np.int64)
    mult = _MULTIPLIERS[seed % len(_MULTIPLIERS)]
    h = ((h & _MASK) + ((seed * _SEED_STEP) & _MASK)) & _MASK
    h = (h * mult) & _MASK
    h = h ^ (h >> 15)
    h = (h * _MIX) & _MASK
    h = h ^ (h >> 12)
    h = h % buckets
    return h.to(torch.int32) if isinstance(h, torch.Tensor) else h.astype(np.int32)


def k_ary_hash(idx, buckets: int, k: int):
    """k independent hashes per index; shape ``idx.shape + (k,)``."""
    hs = [universal_hash(idx, buckets, seed=s) for s in range(k)]
    return torch.stack(hs, dim=-1) if isinstance(hs[0], torch.Tensor) else np.stack(hs, axis=-1)


def _int32(x):
    return x.to(torch.int32) if isinstance(x, torch.Tensor) else np.asarray(x).astype(np.int32)


def qr_shard_owner(idx, collision: int, q_rows: int, num_shards: int):
    """Which row-shard ("bank group") owns the Q row of each logical index."""
    q, _ = qr_decompose(idx, collision)
    return row_owner(q, q_rows, num_shards)


def row_owner(row_idx, table_rows: int, num_shards: int):
    """Owner shard under contiguous ("blocked") row sharding."""
    rows_per_shard = -(-table_rows // num_shards)
    return _int32(row_idx // rows_per_shard)


def local_row(row_idx, table_rows: int, num_shards: int):
    """Row offset within the owner shard under contiguous sharding."""
    rows_per_shard = -(-table_rows // num_shards)
    return _int32(row_idx % rows_per_shard)


def padded_rows(table_rows: int, num_shards: int) -> int:
    """Total rows after padding so every shard holds the same count."""
    rows_per_shard = -(-table_rows // num_shards)
    return rows_per_shard * num_shards
