"""Online-softmax GQA attention: the wrapper of the hand-written CUDA kernel
K9 in ``csrc/flash_attention.cu`` (port of ``repro.kernels.flash_attention``).

* ``flash_fwd`` (K9) replaces ``repro/kernels/flash_attention.py:88
  flash_fwd`` (body ``_kernel``): ``softmax(q·kᵀ·D^-½ [+ causal mask])·v``
  per (batch, query head), kv head ``h // (H/KH)``, in fp32, written in q's
  dtype.  float32 runs on the CUDA cores, bfloat16 on the tensor cores
  (``BODY``: wgmma, K and V tiles read in place by TMA; each kv tile's
  P·V summed in the tensor cores from zero, then added to the output
  accumulator in fp32: their accumulate truncates, and over a long row
  that bias would pass one rounding).
* ``p_bf16`` is ``repro``'s bf16 probability tile (``flash_block_dtype=
  "bf16"``, ``_attn_block``'s ``p_dtype``): each probability is rounded to
  bf16 (nearest even) after its exp, and that value goes into both the row
  sum and the P·V product (the bf16 body then issues only the P_hi
  product).  Its plain version is ``models.layers.flash_attention(p_dtype=
  torch.bfloat16)``.
* ``flash_mha`` is its differentiable form, as ``repro``'s ``custom_vjp``:
  the forward is K9, the backward recomputes through the blockwise
  ``models.layers.flash_attention`` and differentiates that (no backward
  kernel: the TPU package has none either).

The causal mask is top-left aligned (query i sees key j iff i >= j), the
kernel's own convention; ``ref.flash_attention_ref``, ``repro``'s oracle,
aligns it bottom-right, and the two agree only when Sq == Skv.  The kernel
is bound by operations (4·D flops per visible (query, key) pair).

Dispatch is by the tensors' device alone: CUDA tensors launch the kernel, or
raise if the kernel does not take them; CPU tensors take the plain version
``ref.flash_fwd_ref`` (with ``p_bf16``, the blockwise
``layers.flash_attention(p_dtype=torch.bfloat16)``); meta tensors (the
dry run) pass the kernel's checks and get its output as an empty meta
tensor, the call and its flops and
bytes counted in ``bounds.META`` (never the plain version, whose (B, H, Sq,
Skv) scores would overstate a 32k prefill's bytes many times over).  There
is no fallback from the card to the plain version.  The kernel takes
float32 or bfloat16 (one type for q, k, v), contiguous (B, H, Sq, D) /
(B, KH, Skv, D) tensors with H % KH == 0, any Sq and Skv, D <= 256,
B·KH <= 65,535, and buffers that start on 16 bytes; ``repro``'s
``_fit_block`` divisibility is a TPU tiling rule and does not apply.
``LAUNCHES`` counts kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import device as device_mod
from repro_torch.kernels import bounds, build
from repro_torch.kernels.ref import flash_fwd_ref
from repro_torch.models import layers

SOURCE = "flash_attention"
LAUNCHES = {"flash_fwd": 0}
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the body each type runs: its kernel function in csrc/flash_attention.cu
BODY = {torch.float32: ("flash_kernel", "fp32 CUDA cores"),
        torch.bfloat16: ("flash_tc_kernel",
                         "tensor cores wgmma m64nNk16 bf16, P split hi + lo, P.V promoted "
                         "per kv tile")}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_INT = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    for sfx in SUFFIX.values():
        fn = getattr(lib, f"flash_fwd_{sfx}")
        fn.argtypes = [_P] * 4 + [_INT] * 6 + [ctypes.c_float, _INT, _INT, _P]
        fn.restype = ctypes.c_int
    return lib


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q (B, H, Sq, D), k and v (B, KH, Skv, D) with KH | H."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d (B, heads, seq, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in batch or D")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[1]} kv heads")


def check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Validate what the kernel takes beyond the shapes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in SUFFIX or not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous float32 or bfloat16 "
                             f"tensors, got {t.dtype} {tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise ValueError(f"dtypes differ: {name} is {t.dtype}, q is {q.dtype}")
        if t.device.type != "meta" and t.data_ptr() % 16:      # meta has no buffer
            raise ValueError(f"{name}: buffer is not 16-byte aligned")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} exceeds the kernel's {MAX_HEAD_DIM}")
    if k.shape[0] * k.shape[1] > 65535:
        raise ValueError(f"B*KH = {k.shape[0] * k.shape[1]} exceeds one launch's grid")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, p_bf16: bool = False) -> torch.Tensor:
    """K9: attention of q (B, H, Sq, D) over k, v (B, KH, Skv, D), GQA with
    kv head h // (H/KH); ``p_bf16``: the probabilities rounded to bf16.
    Returns (B, H, Sq, D) in q's dtype."""
    check_shapes(q, k, v)
    dev = device_mod.of(q, k, v)
    if dev.type == "cpu":
        if p_bf16:
            return layers.flash_attention(q, k, v, causal=causal,
                                          p_dtype=torch.bfloat16).to(q.dtype)
        return flash_fwd_ref(q, k, v, causal=causal)
    check_cuda(q, k, v)
    b, h, sq, d = q.shape
    kh, skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if dev.type == "meta":
        bounds.meta_call("flash_fwd", bounds.flash_flops(b, h, sq, skv, d, causal),
                         bounds.nbytes(q, k, v, out))
        return out
    with torch.cuda.device(dev):
        err = getattr(_lib(), f"flash_fwd_{SUFFIX[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, kh, sq, skv, d, d ** -0.5, int(causal), int(p_bf16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.launched(LAUNCHES, "flash_fwd", err)
    return out


class _FlashMHA(torch.autograd.Function):
    """K9 forward; the backward recomputes through the blockwise plain
    attention (with ``p_bf16``, its bf16 probability tile) and
    differentiates it (``repro``'s ``flash_mha`` vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, p_bf16):
        ctx.causal, ctx.p_bf16 = causal, p_bf16
        ctx.save_for_backward(q, k, v)
        return flash_fwd(q, k, v, causal=causal, p_bf16=p_bf16)

    @staticmethod
    def backward(ctx, do):
        q, k, v = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = layers.flash_attention(q, k, v, causal=ctx.causal,
                                         p_dtype=torch.bfloat16 if ctx.p_bf16 else None)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        return dq, dk, dv, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, p_bf16: bool = False) -> torch.Tensor:
    """Differentiable attention: K9 forward, blockwise-recompute backward."""
    return _FlashMHA.apply(q, k, v, causal, p_bf16)
