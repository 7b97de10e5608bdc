"""Seeded numpy inputs of the TT-bag kernels (K2 ``packed_tt_bag``, K5
``tt_bag``), shared by the CPU parity tests and the card's tests (numpy
only: no jax, no torch).

Cores are drawn at the init scale ``(dim * rank**2) ** (-1/6)``, so a
rebuilt row has ``dim**-0.5``-scale entries, as in serving."""

import numpy as np

SMOKE_DIMS = (4, 4, 2, 4)          # dlrm-tt-smoke: dim 32, rank 4
DLRM_DIMS = (4, 8, 4, 16)          # dlrm-tt: dim 128, rank 16
CASES = ["mixed", "all_miss", "all_hit", "ragged"]


def init_scale(dims):
    d1, d2, d3, rank = dims
    return (d1 * d2 * d3 * rank ** 2) ** (-1.0 / 6.0)


def packed_tt_inputs(case, *, dims=SMOKE_DIMS, tables=3, v1=5, v2=40, v3=5,
                     slots=16, g=12, k=8, seed=0):
    """Packed-layout K2 inputs: ``tables`` tables' outer cores packed at
    ``t*v1`` / ``t*v3``, their middle cores packed with a trailing zero row,
    a cache block of staged G2 rows, and (G, K) streams whose bag g belongs
    to table ``g % tables`` (sample-major, as ``pack_indices`` makes them).
    ``ragged`` routes a random tail of each bag to the zero row, as
    ``pack_indices(lengths=...)`` does."""
    rng = np.random.default_rng(seed)
    d1, d2, d3, rank = dims
    scale = init_scale(dims)
    f32 = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    g2 = f32(tables * v2 + 1, rank * d2 * rank)
    g2[-1] = 0.0
    table = (np.arange(g) % tables)[:, None]
    i1 = rng.integers(0, v1, (g, k)) + table * v1
    i2 = rng.integers(0, v2, (g, k)) + table * v2
    i3 = rng.integers(0, v3, (g, k)) + table * v3
    slot = rng.integers(-slots, slots, (g, k))
    slot = {"mixed": slot, "ragged": slot, "all_miss": np.full((g, k), -1),
            "all_hit": np.abs(slot) % slots}[case]
    if case == "ragged":
        tail = np.arange(k)[None, :] >= rng.integers(0, k + 1, (g, 1))
        i2 = np.where(tail, tables * v2, i2)
        slot = np.where(tail, -1, slot)
    return {
        "g1": f32(tables * v1, d1 * rank), "g2": g2, "g3": f32(tables * v3, rank * d3),
        "cache": g2[rng.integers(0, tables * v2, slots)],
        "i1": i1.astype(np.int32), "i2": i2.astype(np.int32),
        "i3": i3.astype(np.int32), "slot": slot.astype(np.int32),
    }


def tt_inputs(*, dims=SMOKE_DIMS, v1=6, v2=50, v3=6, b=10, k=8, seed=0):
    """One table's K5 inputs: its cores and (B, K) local streams."""
    rng = np.random.default_rng(seed)
    d1, d2, d3, rank = dims
    scale = init_scale(dims)
    f32 = lambda *s: (rng.standard_normal(s) * scale).astype(np.float32)
    return {
        "g1": f32(v1, d1 * rank), "g2": f32(v2, rank * d2 * rank),
        "g3": f32(v3, rank * d3),
        "i1": rng.integers(0, v1, (b, k)).astype(np.int32),
        "i2": rng.integers(0, v2, (b, k)).astype(np.int32),
        "i3": rng.integers(0, v3, (b, k)).astype(np.int32),
    }


def packed_tt_args(a, to):
    return [to(a[n]) for n in ("g1", "g2", "g3", "cache", "i1", "i2", "i3", "slot")]


def tt_args(a, to):
    return [to(a[n]) for n in ("g1", "g2", "g3", "i1", "i2", "i3")]
