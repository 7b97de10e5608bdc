"""Host-side launch math of the bag body (K1 / K3 / K4 / K6 / K7) and the TT
kernels (K2 / K5), on the CPU: the (table, run of bags) grid, the R rows a
QR block stages, how the table count reaches the grid, and the TT kernels'
choice of staging width.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``)."""

import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import packed_gather as pg  # noqa: E402
from repro_torch.kernels import tt_gather as tg  # noqa: E402
from torch_bag_inputs import bag_inputs, qr_args  # noqa: E402


def _blocks_cover(g: int, tables: int, nb: int, blocks: int) -> list[int]:
    """The kernel's block -> bags map (``csrc/packed_gather.cu``): block x
    takes table x // runs and bags b0 = (x % runs) * nb .. of it, bag b of
    table t being g = b * tables + t.  Returns every bag the grid visits."""
    per_table = g // tables
    runs = -(-per_table // nb)
    seen = []
    for x in range(blocks):
        t, b0 = x // runs, (x % runs) * nb
        seen += [b * tables + t for b in range(b0, min(b0 + nb, per_table))]
    return seen


@pytest.mark.parametrize("g,tables,dim,dtype,expect", [
    # dlrm-qr / dlrm-dense serving, 2,048 x 26 bags, fp32 dim 128: float4
    # loads, a warp a bag
    (53_248, 26, 128, torch.float32, (4, 13_312, 4)),
    # train_8k in bf16: 8,192 x 26 bags, 16-byte loads, two bags a warp
    (212_992, 26, 128, torch.bfloat16, (8, 26_624, 8)),
    (2_048, 1, 128, torch.float32, (4, 512, 4)),      # one table's (2,048, 32): K4, K6, K7
    (2_048, 1, 128, torch.bfloat16, (4, 512, 4)),     # ... in bf16: a warp a bag
    (13_312, 26, 64, torch.bfloat16, (16, 832, 8)),   # the train-DLRM example (512 x 26)
    (37, 1, 10, torch.float32, (8, 5, 1)),            # one value a lane, 16 lanes a bag
    (0, 26, 128, torch.float32, (4, 0, 4)),
])
def test_bag_grid_tiles_table_runs_and_visits_every_bag_once(g, tables, dim, dtype, expect):
    nb, blocks, vec = pg.bag_grid(g, tables, dim, dtype, sms=132)
    assert (nb, blocks, vec) == expect
    assert nb == pg.WARPS * 32 // pg.bag_lanes(dim, vec)
    assert sorted(_blocks_cover(g, tables, nb, blocks)) == list(range(g))


def test_bag_grid_refuses_bags_that_are_not_whole_tables():
    with pytest.raises(ValueError, match="whole number"):
        pg.bag_grid(53_249, 26, 128, torch.float32)
    with pytest.raises(ValueError, match="whole number"):
        pg.bag_grid(16, 0, 128, torch.float32)


@pytest.mark.parametrize("g,dim,dtype,vec", [
    (4_224, 128, torch.bfloat16, 8),     # 32 warps an SM at a warp a bag: wide loads
    (4_223, 128, torch.bfloat16, 4),
    (10**6, 132, torch.bfloat16, 4),     # not a multiple of 8
    (10**6, 128, torch.float32, 4),      # fp32 rows: a float4 is 16 bytes already
    (10**6, 10, torch.bfloat16, 1),
])
def test_bag_vec_widens_bf16_loads_only_for_large_grids(g, dim, dtype, vec):
    assert pg.bag_vec(g, dim, dtype, sms=132) == vec


@pytest.mark.parametrize("dim,vec,lanes", [
    (128, 4, 32),     # 32 float4 chunks: a warp a bag
    (128, 8, 16),     # 16 chunks of 8 bf16: two bags a warp
    (64, 8, 8),       # the train-DLRM example: four bags a warp
    (64, 4, 16),
    (12, 4, 4),       # 3 chunks, rounded up to 4 lanes
    (10, 1, 16),      # one value a lane: 10 -> 16
    (160, 4, 32),     # 40 chunks: a warp loops over chunks of 32
    (160, 8, 32),     # 20 chunks -> 32
])
def test_bag_lanes_round_chunks_up_to_a_power_of_two(dim, vec, lanes):
    assert pg.bag_lanes(dim, vec) == lanes


def test_packed_multi_pooled_passes_the_table_count_to_the_grid(monkeypatch):
    """(B, T, K) streams reach the K1 / K3 wrappers with tables = T; (G, K)
    streams with tables = 1.  On the CPU the wrappers take the plain
    versions, so the outputs are the same either way."""
    seen = []
    for name in ("packed_qr_bag", "packed_bag"):
        real = getattr(pg, name)

        def spy(*a, tables=1, _real=real):
            seen.append(tables)
            return _real(*a, tables=tables)
        monkeypatch.setattr(pg, name, spy)
    a = bag_inputs("mixed", g=12, k=8)
    q, cache, r, idx, slot, r_idx = qr_args(a, torch.from_numpy)
    by = lambda s: s.reshape(4, 3, 8)
    out3 = ops.packed_multi_pooled({"q": q, "cache": cache, "r": r},
                                   {"q_idx": by(idx), "slot": by(slot), "r_idx": by(r_idx)},
                                   kind="qr")
    out2 = ops.packed_multi_pooled({"q": q, "cache": cache, "r": r},
                                   {"q_idx": idx, "slot": slot, "r_idx": r_idx}, kind="qr")
    ops.packed_multi_pooled({"table": q, "cache": cache}, {"idx": by(idx), "slot": by(slot)},
                            kind="dense")
    assert seen == [3, 1, 3]
    assert torch.equal(out3.reshape(12, -1), out2)
    assert torch.equal(out2, ref.packed_qr_bag_ref(q, cache, r, idx, slot, r_idx))


@pytest.mark.parametrize("d2,fit_up_to,expect", [
    (8, 8, 8),        # the whole middle row fits: the one-stage layout (dlrm-tt, rank 16)
    (8, 3, 2),        # rank 64 at dim 128: the largest divisor of d2 that fits
    (8, 1, 1),
    (4, 3, 2),
    (6, 5, 3),
    (8, 0, None),     # not even one column group: the wrapper raises
])
def test_tt_stage_width_is_the_widest_divisor_that_fits(d2, fit_up_to, expect):
    tried = []

    def fits(w):
        tried.append(w)
        return w <= fit_up_to
    assert tg.stage_width(d2, fits) == expect
    assert all(d2 % w == 0 for w in tried)
    assert tried == sorted(tried, reverse=True)


@pytest.mark.parametrize("dims,slices", [
    ((12, 16, 8, 16), [(0, 6), (6, 12)]),     # qwen2-1.5b's TT vocabulary: 1,536 wide
    ((32, 8, 8, 16), [(0, 16), (16, 32)]),
    ((3, 1000, 1, 2), [(0, 1), (1, 2), (2, 3)]),
    ((4, 8, 4, 16), [(0, 4)]),                 # fits one launch
])
def test_tt_bag_takes_a_wide_row_in_d1_slices(dims, slices, monkeypatch):
    """K5's wrapper launches once per ``d1_slices`` range, on that range's G1
    columns, and lays the outputs side by side: with the launch replaced by
    the plain version, the row equals the plain version's whole row."""
    assert tg.d1_slices(dims) == slices
    d1, d2, d3, r = dims
    calls = []
    monkeypatch.setattr(tg.device_mod, "of", lambda *t: torch.device("cuda", 0))
    monkeypatch.setattr(tg, "check_cuda", lambda cores, streams, dims: (
        streams["i1"].shape[0], streams["i1"].shape[1], cores["g1"].dtype, dims[1]))

    def launch(name, counts, cores, cache, streams, slot, dims, *rest):
        calls.append(dims)
        assert cores[0].is_contiguous() and cores[0].shape[1] == dims[0] * dims[3]
        return ref.tt_bag_ref(*cores, *streams, dims=dims)

    monkeypatch.setattr(tg, "run", launch)
    g = torch.Generator().manual_seed(0)
    cores = [torch.randn(n, w, generator=g) for n, w in ((5, d1 * r), (7, r * d2 * r), (6, r * d3))]
    idx = [torch.randint(0, n, (9, 3), generator=g, dtype=torch.int32) for n in (5, 7, 6)]
    got = tg.tt_bag(*cores, *idx, dims=dims)
    assert calls == [(hi - lo, d2, d3, r) for lo, hi in slices]
    torch.testing.assert_close(got, ref.tt_bag_ref(*cores, *idx, dims=dims), rtol=1e-6,
                               atol=1e-6)
