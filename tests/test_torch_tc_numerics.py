"""The numerics of the tensor-core designs of K9 (bf16 attention) and K2/K5
(TT bags), emulated in plain PyTorch on the CPU.

Each emulation does in fp32 what the card's bf16 body does, tile by tile:

* K9 (``csrc/flash_attention.cu``, ``flash_tc_kernel``): S = q·kᵀ from
  bf16 values with fp32 accumulation (products of two bf16 values are exact
  in fp32), the d^-½ scale on the fp32 scores, the online softmax over kv
  tiles of 64 keys, and O += P_hi·V + P_lo·V with P_hi = bf16(p), P_lo =
  bf16(p - P_hi); out = acc / max(l, 1e-30) rounded once to bf16.  With
  ``tc=True`` each k16 step of P·V adds as the tensor cores do, modelled
  (``tc_mma``: the addends aligned to the largest and cut toward zero
  ``TC_BITS`` bits below it), and ``promote`` gives the body's promotion:
  each kv tile's products accumulate from zero, then join the output
  accumulator by an fp32 add.
* K2/K5 (``csrc/tt_bag.cu``): the elements ordered by middle-core source
  (``tt_gather.element_order``), walked in windows and runs of equal source
  as pass 1 does; t = A·M from bf16 values with fp32 accumulation (the
  tensor-core design), then t·G3 in fp32, each row to its scratch slot;
  pass 2 sums the K rows in k order and rounds once.  The card's body
  computes t with fp32 FMAs in depth order instead, bitwise the plain
  version's (the tensor-core design holds the rule below but rounds a few
  outputs one step away from the plain version, which the training path's
  step-1 gradient check does not tolerate); this emulation records that the
  schedule and the tensor-core numerics hold the contract.

Each is held against the plain version computed in fp32 on the same
(bf16-exact) inputs by the one-rounding rule ``chip_smoke.py`` holds the
card to: |out - plain| <= 2^-8 |plain| + 1e-5 max|plain|, worst ratio <= 1.
The negative cases record why the splits exist: rounding P (K9) or t (K2)
to bf16 before the second product reads above 1.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_one_thread import one_thread  # noqa: E402,F401

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import tt_gather as tg  # noqa: E402
from torch_tt_inputs import (  # noqa: E402
    DLRM_DIMS, SMOKE_DIMS, packed_tt_args, packed_tt_inputs, tt_args, tt_inputs,
)

BF16_ULP = 2.0 ** -8
ROUND_ATOL = 1e-5


def rounding_ratio(out: torch.Tensor, plain32: torch.Tensor) -> float:
    """Worst |out - plain32| over one bf16 rounding of plain32 (chip_smoke's
    ``one_rounding``)."""
    p = plain32.float()
    d = (out.float() - p).abs()
    atol = max(ROUND_ATOL * float(p.abs().max()), 1e-30)
    return float((d / (p.abs() * BF16_ULP + atol)).max())


def bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

KV_TILE = 64
# bits a tensor-core accumulate keeps below its largest addend, a model:
# with 25, the unpromoted body's error on the two worst rows of
# whisper-large-v3's decoder self-attention (32,768 keys; NVIDIA H100 80GB
# HBM3) reads 114% and 133% of the card's, with the card's sign
TC_BITS = 25


def tc_mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One k16 step c + a·b on the tensor cores, modelled: c (..., M, N)
    fp32, a (..., M, 16), b (..., 16, N); the 17 addends of an output (c and
    the 16 exact products) aligned to the largest and cut toward zero
    ``TC_BITS`` bits below it, summed exactly, the sum cut toward zero to
    fp32."""
    prods = a.double().unsqueeze(-1) * b.double().unsqueeze(-3)
    add = torch.cat([c.double().unsqueeze(-2), prods], dim=-2)
    _, e = torch.frexp(add.abs().amax(dim=-2, keepdim=True))
    ulp = torch.ldexp(torch.ones_like(add[..., :1, :]), e - TC_BITS)
    total = (torch.trunc(add / ulp) * ulp).sum(dim=-2)
    _, e = torch.frexp(total)
    ulp = torch.ldexp(torch.ones_like(total), e - 24)
    return (torch.trunc(total / ulp) * ulp).float()


def flash_tc_emulated(q, k, v, *, causal: bool, split: bool = True, tc: bool = False,
                      promote: bool = True) -> torch.Tensor:
    """K9's bf16 tensor-core body on the CPU (see the module docstring);
    ``split=False`` rounds p to bf16 once instead of splitting it; ``tc``
    adds P·V as the tensor cores do (``tc_mma``), into a tile promoted to
    the output accumulator (``promote``) or straight into it."""
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    grp = h // kh
    qf = q.float()
    kf = k.float().repeat_interleave(grp, dim=1)
    vf = v.float().repeat_interleave(grp, dim=1)
    m = torch.full((b, h, sq, 1), ref.NEG_INF)
    l = torch.zeros((b, h, sq, 1))
    acc = torch.zeros((b, h, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, skv, KV_TILE):
        keys = torch.arange(k0, k0 + KV_TILE)[None, :]
        kt = torch.zeros((b, h, KV_TILE, d))
        vt = torch.zeros((b, h, KV_TILE, d))
        n = min(KV_TILE, skv - k0)
        kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * d ** -0.5
        if causal:
            s = s.masked_fill(keys > qpos, ref.NEG_INF)
        s = s.masked_fill(keys >= skv, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr
        if tc:
            hi = bf16(p)
            tile = torch.zeros_like(acc) if promote else acc
            for kk in range(0, KV_TILE, 16):
                for part in (hi, bf16(p - hi)):
                    tile = tc_mma(tile, part[..., kk:kk + 16], vt[..., kk:kk + 16, :])
            acc = acc + tile if promote else tile
        elif split:
            hi = bf16(p)
            acc = acc + torch.matmul(hi, vt) + torch.matmul(bf16(p - hi), vt)
        else:
            acc = acc + torch.matmul(bf16(p), vt)
        m = m_new
    return (acc / l.clamp(min=1e-30)).to(torch.bfloat16)


def _qkv(b, h, kh, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16)
    return mk(b, h, sq, d), mk(b, kh, skv, d), mk(b, kh, skv, d)


# (batch, query heads, kv heads, Sq, Skv, D): G 1 and 6, Sq == Skv, Sq < Skv
# with a ragged last kv tile, Sq > Skv, an odd D
FLASH_SHAPES = [(1, 2, 2, 192, 192, 64), (1, 6, 1, 100, 300, 32), (2, 6, 1, 130, 70, 16),
                (1, 1, 1, 64, 256, 13)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_split_p_holds_one_rounding(seed, causal, shape):
    q, k, v = _qkv(*shape, seed=seed)
    got = flash_tc_emulated(q, k, v, causal=causal)
    plain = ref.flash_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert rounding_ratio(got, plain) <= 1.0


@pytest.mark.parametrize("causal", [True, False])
def test_flash_unsplit_p_breaks_one_rounding(causal):
    """P rounded to bf16 before P·V: the error of the weights reaches the
    outputs, far above one rounding."""
    q, k, v = _qkv(1, 4, 1, 512, 512, 64, seed=3)
    plain = ref.flash_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    assert rounding_ratio(flash_tc_emulated(q, k, v, causal=causal), plain) <= 1.0
    assert rounding_ratio(flash_tc_emulated(q, k, v, causal=causal, split=False), plain) > 1.0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_promoted_tensor_core_accumulate_holds_one_rounding(causal, shape):
    q, k, v = _qkv(*shape, seed=5)
    got = flash_tc_emulated(q, k, v, causal=causal, tc=True)
    plain = ref.flash_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
    assert rounding_ratio(got, plain) <= 1.0


@pytest.mark.parametrize("keys", [4096, 8192])
def test_flash_unpromoted_accumulate_breaks_one_rounding_on_long_rows(keys):
    """Why the body promotes: rows of thousands of keys whose outputs are a
    small remainder of the sum of |p v| (here values that climb for half
    the keys and fall for the other half), as whisper's decoder gives at
    32,768 keys.  Accumulated straight into one register tile, the
    tensor cores' cut-toward-zero bias adds up over every k16 step, far
    past one rounding; promoted per kv tile it stays at the plain
    version's own rounding."""
    g = torch.Generator().manual_seed(0)
    sign = torch.ones(keys)
    sign[keys // 2:] = -1
    v = (sign[:, None] * (1 + 0.05 * torch.randn(keys, 16, generator=g)))[None, None]
    q = 0.3 * torch.randn((1, 1, 4, 16), generator=g)
    k = torch.randn((1, 1, keys, 16), generator=g)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    plain = ref.flash_fwd_ref(q.float(), k.float(), v.float(), causal=False)
    assert rounding_ratio(flash_tc_emulated(q, k, v, causal=False, tc=True), plain) <= 1.0
    assert rounding_ratio(flash_tc_emulated(q, k, v, causal=False, tc=True, promote=False),
                          plain) > 4.0


def test_flash_emulation_is_the_plain_version_in_fp32():
    """The tiling, masking and online softmax alone (no bf16 rounding of p:
    fp32 throughout) reproduce the plain version to fp32 accuracy."""
    q, k, v = _qkv(1, 6, 2, 70, 150, 32, seed=4)
    for causal in (True, False):
        plain = ref.flash_fwd_ref(q.float(), k.float(), v.float(), causal=causal)
        got = flash_tc_emulated(q.float(), k.float(), v.float(), causal=causal).float()
        torch.testing.assert_close(got, plain.to(torch.bfloat16).float(), rtol=2**-7, atol=1e-3)


# ---------------------------------------------------------------------------
# K2 / K5
# ---------------------------------------------------------------------------

WINDOW = 64


def tt_tc_emulated(g1, g2, g3, cache, i1, i2, i3, slot, *, dims, round_t: bool = False):
    """K2's tensor-core design on the CPU (K5 with ``cache``/``slot``
    None): order, windows and runs as pass 1, scratch rows, then the K sum
    of pass 2."""
    d1, d2, d3, rank = dims
    g, kk = i1.shape
    cache_rows = 0 if cache is None else cache.shape[0]
    order = tg.element_order(i2, slot, cache_rows, g2.shape[0])
    flat = [x.reshape(-1).long() for x in (i1, i2, i3)]
    sl = None if slot is None else slot.reshape(-1).long()
    src = flat[1] + cache_rows if sl is None else torch.where(sl >= 0, sl, flat[1] + cache_rows)
    scratch = torch.full((g * kk, d1 * d2 * d3), float("nan"))
    staged = 0
    for w0 in range(0, g * kk, WINDOW):
        win = order[w0:w0 + WINDOW]
        s = 0
        while s < len(win):
            e = s
            while e < len(win) and src[win[e]] == src[win[s]]:
                e += 1
            key = int(src[win[s]])
            m = (cache[key] if key < cache_rows else g2[key - cache_rows]).float()
            staged += 1
            pos = win[s:e]
            a = g1[flat[0][pos]].float().reshape(-1, d1, rank)
            t = torch.matmul(a, m.reshape(rank, d2 * rank))      # exact products, fp32 sums
            if round_t:
                t = bf16(t)
            c = g3[flat[2][pos]].float().reshape(-1, rank, d3)
            rows = torch.matmul(t.reshape(-1, d1 * d2, rank), c).reshape(len(pos), -1)
            scratch[pos] = rows
            s = e
    out = torch.zeros((g, d1 * d2 * d3))
    rows = scratch.reshape(g, kk, -1)
    for k in range(kk):
        out = out + rows[:, k]
    return out.to(g2.dtype), staged


def _cores(a, to_bf16=True):
    cast = (lambda t: t.to(torch.bfloat16)) if to_bf16 else (lambda t: t)
    return [cast(t) if t.is_floating_point() else t for t in a]


TT_SHAPES = [
    dict(dims=DLRM_DIMS, tables=3, v1=6, v2=30, v3=6, slots=16, g=24, k=8),
    dict(dims=SMOKE_DIMS, tables=4, v1=8, v2=64, v3=8, slots=64, g=33, k=8),
    dict(dims=DLRM_DIMS, tables=2, v1=5, v2=20, v3=5, slots=8, g=1, k=40),    # G = 1
    dict(dims=SMOKE_DIMS, tables=2, v1=5, v2=20, v3=5, slots=8, g=50, k=1),   # K = 1
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["mixed", "all_miss", "all_hit", "ragged"])
@pytest.mark.parametrize("shape", range(len(TT_SHAPES)))
def test_tt_bf16_contraction_holds_one_rounding(seed, case, shape):
    kw = dict(TT_SHAPES[shape])
    dims = kw["dims"]
    args = _cores(packed_tt_args(packed_tt_inputs(case, seed=seed, **kw), torch.from_numpy))
    got, staged = tt_tc_emulated(*args, dims=dims)
    plain = ref.packed_tt_bag_ref(*[a.float() if a.is_floating_point() else a for a in args],
                                  dims=dims)
    assert got.dtype == torch.bfloat16 and got.shape == plain.shape
    assert rounding_ratio(got, plain) <= 1.0
    # each run of a window stages its middle row once
    n = kw["g"] * kw["k"]
    assert staged <= n


@pytest.mark.parametrize("dims", [DLRM_DIMS, SMOKE_DIMS])
def test_tt_k5_contraction_holds_one_rounding(dims):
    one = _cores(tt_args(tt_inputs(dims=dims, b=40, k=8, seed=5), torch.from_numpy))
    got, _ = tt_tc_emulated(one[0], one[1], one[2], None, *one[3:], None, dims=dims)
    plain = ref.tt_bag_ref(*[a.float() if a.is_floating_point() else a for a in one], dims=dims)
    assert rounding_ratio(got, plain) <= 1.0


def test_tt_rounded_t_breaks_one_rounding():
    """t rounded to bf16 before t·G3: far above one rounding."""
    kw = dict(dims=DLRM_DIMS, tables=3, v1=6, v2=30, v3=6, slots=16, g=64, k=32)
    args = _cores(packed_tt_args(packed_tt_inputs("mixed", seed=6, **kw), torch.from_numpy))
    plain = ref.packed_tt_bag_ref(*[a.float() if a.is_floating_point() else a for a in args],
                                  dims=kw["dims"])
    good, _ = tt_tc_emulated(*args, dims=kw["dims"])
    bad, _ = tt_tc_emulated(*args, dims=kw["dims"], round_t=True)
    assert rounding_ratio(good, plain) <= 1.0
    assert rounding_ratio(bad, plain) > 1.0


def test_tt_fp32_schedule_is_the_plain_version():
    """In fp32 the sorted, windowed schedule gives the plain version's
    output up to summation order."""
    kw = dict(dims=DLRM_DIMS, tables=3, v1=6, v2=30, v3=6, slots=16, g=24, k=8)
    args = packed_tt_args(packed_tt_inputs("mixed", seed=7, **kw), torch.from_numpy)
    got, _ = tt_tc_emulated(*args, dims=kw["dims"])
    torch.testing.assert_close(got, ref.packed_tt_bag_ref(*args, dims=kw["dims"]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["mixed", "all_miss", "all_hit", "ragged"])
def test_element_order_groups_sources_stably(case):
    a = packed_tt_inputs(case, seed=8, tables=3, v2=10, slots=6, g=20, k=6)
    i2, slot = torch.from_numpy(a["i2"]), torch.from_numpy(a["slot"])
    rows = a["cache"].shape[0]
    order = tg.element_order(i2, slot, rows, a["g2"].shape[0])
    src = torch.where(slot.reshape(-1) >= 0, slot.reshape(-1), i2.reshape(-1) + rows)
    assert order.dtype == torch.int64
    assert sorted(order.tolist()) == list(range(i2.numel()))
    s = src[order]
    assert bool((s[1:] >= s[:-1]).all())
    same = s[1:] == s[:-1]
    assert bool((order[1:][same] > order[:-1][same]).all())     # stable
    # K5: no slots, the G2 row alone
    o5 = tg.element_order(i2)
    assert bool((i2.reshape(-1)[o5][1:] >= i2.reshape(-1)[o5][:-1]).all())
