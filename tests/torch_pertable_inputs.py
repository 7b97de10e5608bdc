"""Seeded numpy inputs of the per-table kernels (K4a ``cached_bag``, K4b
``cached_qr_bag``, K6 ``gnr_bag``, K7 ``gnr_bag_dense``, K8 ``qr_gather``),
shared by the CPU parity tests and the card's tests (numpy only: no jax, no
torch).  Values are unit normals; bf16 cases convert these fp32 values,
which rounds them the same way in both frameworks."""

import numpy as np

DTYPES = ["float32", "bfloat16"]


def pertable_inputs(*, lead=(6,), k=8, dim=32, rows=96, r_rows=8, slots=16,
                    hit_p=0.5, seed=0):
    """One table, its R LUT and a cache block of staged rows, with index
    streams of shape ``lead + (k,)``: ``idx`` (table / Q rows), ``r_idx``
    (R rows) and ``slot`` (a cache slot with probability ``hit_p``, else
    -1)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    shape = tuple(lead) + (k,)
    hit = rng.random(shape) < hit_p
    return {
        "table": f32(rows, dim), "cache": f32(slots, dim), "r_lut": f32(r_rows, dim),
        "idx": rng.integers(0, rows, shape).astype(np.int32),
        "r_idx": rng.integers(0, r_rows, shape).astype(np.int32),
        "slot": np.where(hit, rng.integers(0, slots, shape), -1).astype(np.int32),
    }


def cached_qr_args(a, to, tt=None):
    """(q_table, cache, r_lut, q_idx, slot, r_idx); ``tt`` converts the
    float buffers (a dtype cast), ``to`` makes every array a tensor."""
    tt = tt or (lambda x: x)
    return [tt(to(a["table"])), tt(to(a["cache"])), tt(to(a["r_lut"])),
            to(a["idx"]), to(a["slot"]), to(a["r_idx"])]


def cached_args(a, to, tt=None):
    tt = tt or (lambda x: x)
    return [tt(to(a["table"])), tt(to(a["cache"])), to(a["idx"]), to(a["slot"])]


def qr_args(a, to, tt=None):
    """(q_table, r_lut, q_idx, r_idx)."""
    tt = tt or (lambda x: x)
    return [tt(to(a["table"])), tt(to(a["r_lut"])), to(a["idx"]), to(a["r_idx"])]


def dense_args(a, to, tt=None):
    tt = tt or (lambda x: x)
    return [tt(to(a["table"])), to(a["idx"])]
