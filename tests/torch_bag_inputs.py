"""Seeded numpy inputs of the packed-bag kernels, shared by the CPU parity
tests and the card's tests (numpy only: no jax, no torch)."""

import numpy as np

CASES = ["mixed", "all_miss", "all_hit"]


def bag_inputs(case, *, rows=300, r_rows=17, slots=40, g=12, k=8, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    slot = rng.integers(-slots, slots, (g, k))
    slot = {"mixed": slot, "all_miss": np.full((g, k), -1),
            "all_hit": np.abs(slot) % slots}[case].astype(np.int32)
    return {
        "table": f32(rows, dim), "cache": f32(slots, dim), "r_lut": f32(r_rows, dim),
        "idx": rng.integers(0, rows, (g, k)).astype(np.int32),
        "slot": slot,
        "r_idx": rng.integers(0, r_rows, (g, k)).astype(np.int32),
    }


def qr_args(a, to):
    return [to(a[k]) for k in ("table", "cache", "r_lut", "idx", "slot", "r_idx")]


def dense_args(a, to):
    return [to(a[k]) for k in ("table", "cache", "idx", "slot")]
