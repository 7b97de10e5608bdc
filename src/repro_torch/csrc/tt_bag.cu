// Pooled TT-Rec bags for Hopper (sm_90a): K2 packed_tt_bag and K5 tt_bag,
// one source with a compile-time switch.
//
// Replaces the TPU kernels
//   K2: repro/kernels/packed_gather.py:158 packed_tt_bag (pallas_call :190),
//       body _packed_tt_kernel (:69);
//   K5: repro/kernels/tt_gather.py:64 tt_bag (pallas_call :89), body
//       _kernel (:37).
// K5 is K2 without the slot stream (every access reads G2), on one table's
// cores, so kCached selects the variant.
//
// What it computes, over G bags of K int32 core-row indices:
//   out[g] = sum_k G1[i1] . (slot >= 0 ? C[slot] : G2[i2]) . G3[i3]
// per element, in the Pallas body's order and all in fp32:
//   t   = A (d1 x r) @ M (r x d2*r), viewed as (d1*d2) x r;
//   row = t @ Cm (r x d3), flattened to dim = d1*d2*d3;
//   out[g] += row, k = 0..K-1 in order.
// No TF32 and no tensor cores.  Products are fmaf (the compiler would
// contract them anyway); the plain version's matmuls round in another order,
// hence the 1e-4 tolerance on the card.  dims (d1, d2, d3, rank) are runtime
// arguments, so the smoke cores (4, 4, 2, 4) and dlrm-tt's (4, 8, 4, 16)
// run the same code.
//
// Bound: operations.  A dlrm-tt element is (4,16)@(16,128) then (32,16)@(16,4):
// 10,240 FMAs = 20,480 flops for one 8 KiB G2 row, 2.5 flop per byte, so a
// batch of 53,248 bags x 32 is 3.49e10 flops = 0.52 ms at 67 TFLOP/s fp32,
// against at most ~363 MB of unique bytes (0.11 ms at 3.35 TB/s).  What a
// simple kernel risks instead: each element stages its whole G2 row, ~14 GB
// per batch served from L2 and HBM, and every product reads its operands
// from shared memory.
//
// Design (first version: simple and right; speed is later work):
// * One block of 128 threads per bag; K walked in order inside the block,
//   no atomics, so the summation order is fixed, as the TPU got it from its
//   sequential K grid revisiting the output block.
// * Per element the block stages the G2 (or cache) row into shared memory
//   with float4 loads (2,048 floats: 4 loads a thread at dlrm width) and the
//   G1 and G3 rows with scalar loads, then forms t in shared memory (rows
//   padded to r+1 floats against bank conflicts) and the output row.
// * Each thread owns output elements tid, tid+128, ... and accumulates them
//   in registers: dim <= 1024 (8 per thread).
// * Shared memory per block: G2 row + G1 row + G3 row + t = 10,880 B at dlrm
//   width; more than 48 KB is requested with cudaFuncSetAttribute.
// * A hit or a miss is a plain branch on the slot; it replaces the TPU's
//   "pin hits to block 0 so the DMA is elided" index map.
//
// Residency does not carry over.  The TPU kept G1, G3 and the cache block in
// VMEM (VMEM_RESIDENT_BUDGET 12 MiB, packed_gather.py:52).  Here they are
// read from global memory and left to L2: the packed G1 and G3 of 26 tables
// are 0.5 MB, the cache block 1,024 slots x 8 KiB = 8 MiB, all of it well
// inside the 50 MB L2.  Double buffering across k (cp.async) is later work.
//
// Offsets are 64-bit (size_t).  An index outside its buffer traps (a launch
// fault at the next sync) instead of reading another table's memory.
//
// Element types: float32 or bfloat16 cores (one type per call; the training
// lookup packs in the compute dtype, bf16).  bf16 rows load 4 values in 8
// bytes and widen exactly to fp32 (the 16 bits become a float's high half);
// the contraction and the K sum stay fp32, and the output is rounded once to
// bf16 (round to nearest even), as the Pallas bodies cast their fp32 result
// to the core dtype.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for dims it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kOutPerThread = 8;                  // dim <= 1024
constexpr size_t kMaxSmem = 232448;               // 227 KB a block

using bf16 = __nv_bfloat16;

// -- core values widened to fp32, outputs rounded once ----------------------

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const bf16* p) {
  const unsigned short s = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(s) << 16);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of one block: M (rounded to float4), A, Cm, t.
inline size_t smem_bytes(int d1, int d2, int d3, int rank) {
  const size_t floats = round4(rank * d2 * rank) + d1 * rank + rank * d3 +
                        static_cast<size_t>(d1) * d2 * (rank + 1);
  return floats * sizeof(float);
}

template <typename T, bool kCached>
__global__ void __launch_bounds__(kThreads)
tt_bag_kernel(const T* __restrict__ g1, const T* __restrict__ g2,
              const T* __restrict__ g3, const T* __restrict__ cache,
              const int* __restrict__ i1, const int* __restrict__ i2,
              const int* __restrict__ i3, const int* __restrict__ slot,
              T* __restrict__ out, int K, int d1, int d2, int d3, int rank,
              long long g1_rows, long long g2_rows, long long g3_rows,
              long long cache_rows) {
  extern __shared__ float4 smem4[];
  const int w1 = d1 * rank, w2 = rank * d2 * rank, w3 = rank * d3;
  const int cols = d2 * rank;       // columns of M, and of t before reshape
  const int tstride = rank + 1;     // padded t row
  const int tn = d1 * cols;         // elements of t
  const int dim = d1 * d2 * d3;
  float* m = reinterpret_cast<float*>(smem4);
  float* a = m + round4(w2);
  float* c = a + w1;
  float* t = c + w3;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * K;
  const bool vec = (w2 & 3) == 0;   // rows start 16 (fp32) or 8 (bf16) bytes aligned

  float acc[kOutPerThread];
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    const int r1 = __ldg(i1 + base + k);
    const int r2 = __ldg(i2 + base + k);
    const int r3 = __ldg(i3 + base + k);
    const int s = kCached ? __ldg(slot + base + k) : -1;
    if (r1 < 0 || r1 >= g1_rows || r3 < 0 || r3 >= g3_rows) __trap();
    if (kCached && s >= cache_rows) __trap();
    if (s < 0 && (r2 < 0 || r2 >= g2_rows)) __trap();

    const T* mrow = s >= 0 ? cache + static_cast<size_t>(s) * w2
                           : g2 + static_cast<size_t>(r2) * w2;
    if (vec) {
      for (int i = tid; i < w2 / 4; i += kThreads) smem4[i] = load4(mrow + 4 * i);
    } else {
      for (int i = tid; i < w2; i += kThreads) m[i] = load1(mrow + i);
    }
    const T* arow = g1 + static_cast<size_t>(r1) * w1;
    const T* crow = g3 + static_cast<size_t>(r3) * w3;
    for (int i = tid; i < w1; i += kThreads) a[i] = load1(arow + i);
    for (int i = tid; i < w3; i += kThreads) c[i] = load1(crow + i);
    __syncthreads();

    // t = A (d1 x r) @ M (r x d2*r); element (row, col) lands at row
    // row*d2 + col/r, column col%r of the (d1*d2) x r view
    for (int e = tid; e < tn; e += kThreads) {
      const int row = e / cols, col = e - row * cols;
      float v = 0.f;
      for (int p = 0; p < rank; ++p) v = fmaf(a[row * rank + p], m[p * cols + col], v);
      t[(row * d2 + col / rank) * tstride + col % rank] = v;
    }
    __syncthreads();

    // row = t (d1*d2 x r) @ Cm (r x d3); out += row
#pragma unroll
    for (int i = 0; i < kOutPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < dim) {
        const int rr = e / d3, cc = e - rr * d3;
        float v = 0.f;
        for (int q = 0; q < rank; ++q) v = fmaf(t[rr * tstride + q], c[q * d3 + cc], v);
        acc[i] += v;
      }
    }
    __syncthreads();  // the next element overwrites M, A, Cm and t
  }

  T* o = out + static_cast<size_t>(blockIdx.x) * dim;
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < dim) store1(o + e, acc[i]);
  }
}

template <typename T, bool kCached>
int launch(const void* g1, const void* g2, const void* g3, const void* cache,
           const int* i1, const int* i2, const int* i3, const int* slot,
           void* out, long long num_bags, int K, int d1, int d2, int d3,
           int rank, long long g1_rows, long long g2_rows, long long g3_rows,
           long long cache_rows, void* stream) {
  if (d1 <= 0 || d2 <= 0 || d3 <= 0 || rank <= 0 || K < 0 ||
      d1 * d2 * d3 > kThreads * kOutPerThread || num_bags > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(d1, d2, d3, rank);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (num_bags <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tt_bag_kernel<T, kCached>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tt_bag_kernel<T, kCached><<<static_cast<unsigned>(num_bags), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g1), static_cast<const T*>(g2), static_cast<const T*>(g3),
      static_cast<const T*>(cache), i1, i2, i3, slot, static_cast<T*>(out), K, d1, d2,
      d3, rank, g1_rows, g2_rows, g3_rows, cache_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: packed TT bag, the middle core routed by slot.
#define PACKED_TT_BAG(SUFFIX, T)                                                       \
  extern "C" int packed_tt_bag_##SUFFIX(                                               \
      const void* g1, const void* g2, const void* g3, const void* cache,               \
      const int* i1, const int* i2, const int* i3, const int* slot, void* out,         \
      long long num_bags, int K, int d1, int d2, int d3, int rank, long long g1_rows,  \
      long long g2_rows, long long g3_rows, long long cache_rows, void* stream) {      \
    return launch<T, true>(g1, g2, g3, cache, i1, i2, i3, slot, out, num_bags, K, d1,  \
                           d2, d3, rank, g1_rows, g2_rows, g3_rows, cache_rows,        \
                           stream);                                                    \
  }

// K5: one table's TT bag, every access reads G2.
#define TT_BAG(SUFFIX, T)                                                              \
  extern "C" int tt_bag_##SUFFIX(                                                      \
      const void* g1, const void* g2, const void* g3, const int* i1, const int* i2,    \
      const int* i3, void* out, long long num_bags, int K, int d1, int d2, int d3,     \
      int rank, long long g1_rows, long long g2_rows, long long g3_rows,               \
      void* stream) {                                                                  \
    return launch<T, false>(g1, g2, g3, nullptr, i1, i2, i3, nullptr, out, num_bags,   \
                            K, d1, d2, d3, rank, g1_rows, g2_rows, g3_rows, 0, stream); \
  }

PACKED_TT_BAG(f32, float)
PACKED_TT_BAG(bf16, bf16)
TT_BAG(f32, float)
TT_BAG(bf16, bf16)
