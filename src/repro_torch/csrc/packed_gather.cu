// Pooled bags for Hopper (sm_90a), one kernel body for the whole family:
// K1 packed_qr_bag, K3 packed_bag, K4 cached_qr_bag / cached_bag, K6 gnr_bag
// and K7 gnr_bag_dense.
//
// Replaces the TPU kernels
//   K1: repro/kernels/packed_gather.py:130 packed_qr_bag
//       -> repro/kernels/cached_gather.py:123 cached_qr_bag (pallas_call :147),
//       body _cached_qr_kernel (:54);
//   K3: repro/kernels/packed_gather.py:103 packed_bag
//       -> repro/kernels/cached_gather.py:82 cached_bag (pallas_call :104),
//       body _cached_kernel (:37);
//   K4: repro/kernels/cached_gather.py:123 cached_qr_bag and :82 cached_bag
//       on one table's buffers: the same entry points as K1 and K3, as repro's
//       packed kernels call cached_qr_bag / cached_bag directly;
//   K6: repro/kernels/gnr_bag.py:63 gnr_bag (pallas_call :79), body
//       _qr_kernel (:32);
//   K7: repro/kernels/gnr_bag.py:100 gnr_bag_dense (pallas_call :114), body
//       _dense_kernel (:49).
// kQR adds the R row; kCached routes each access by a slot stream (K6 and K7
// have none: no slot pointer, no cache pointer).
//
// What it computes, over G bags of K int32 indices:
//   out[g] = sum_k ( (slot[g,k] >= 0 ? C[slot[g,k]] : T[idx[g,k]]) (+ R[r_idx[g,k]]) )
// Tables in float32 or bfloat16 (one type per call), every row converted to
// fp32, the sum in fp32, the output written in the table type (round to
// nearest even for bf16), as cached_gather.py:119,170 and gnr_bag.py:96,125.
//
// Bound: bytes.  Each element of a bag costs one row read (512 B fp32, 256 B
// bf16 at dlrm dim 128) and one or two adds per value: about 0.25 flop per
// byte in fp32, far below the card's ~20 flop/B fp32 balance point.  The
// least time is the bytes a batch must move (index streams, the unique rows
// touched, the output) over the memory rate; the design keeps every row read
// in one coalesced warp load and reads nothing twice from device memory that
// L2 does not serve.
//
// Design (first version: simple and right; speed is later work):
// * One warp per bag.  Lanes span dim in 4-value chunks: a 16-byte float4
//   load in fp32, an 8-byte load of 4 bf16 values (converted by shifting the
//   bits into a float: exact) in bf16.  dim 128 is 32 lanes x 4 values, one
//   row is one 512 B (fp32) or 256 B (bf16) warp load; wider rows loop over
//   128-value column chunks.  A dim that is not a multiple of 4 takes the
//   same body with one value a lane (scalar loads).
// * The bag's K indices, slots and R indices are loaded once per warp (one
//   per lane) and broadcast with __shfl_sync.
// * K is walked in order 0..K-1 inside the warp, with no atomics, so the
//   summation order is fixed; the TPU kernel got the same order from its
//   sequential grid revisiting the output block.  Adds are plain fp32 adds
//   (no multiply, so no FMA contraction changes the rounding), the R row
//   added to the table row first, as the Pallas body does.
// * A hit or a miss is a plain branch on the slot.  It replaces the TPU's
//   "pin hits to block 0 so the DMA is elided" index map
//   (cached_gather.py:73-78).
//
// Residency does not carry over.  The TPU kept the cache block and the R LUT
// in VMEM (VMEM_RESIDENT_BUDGET 12 MiB, packed_gather.py:52).  At dlrm-qr
// full width the packed cache block is 16,384 slots x 512 B = 8 MiB
// (tune/knobs.py:156-157) and the packed R is 26*64+1 = 1,665 rows = 852 KB;
// a block has 227 KB of shared memory.  Both are read from global memory
// here; together they fit the 50 MB L2, which serves their reuse.
//
// Offsets are 64-bit: packed dlrm-dense is 52,000,001 rows x 128 floats =
// 6.66e9 elements, more than 2^31, so every row offset is a size_t.
//
// An index outside its buffer traps (a launch fault at the next sync)
// instead of reading another table's memory.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  Buffers start on 16 bytes (the
// wrappers check it), so a row of a dim that is a multiple of 4 starts on
// 16 bytes (fp32) or 8 bytes (bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// -- V values of a row at p, converted to fp32 --------------------------------

__device__ __forceinline__ void load(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }

// bf16 -> fp32 is exact: the 16 bits become the high half of the float.
__device__ __forceinline__ void load(const bf16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ void load(const bf16* p, float (&v)[1]) {
  const unsigned short s = __ldg(reinterpret_cast<const unsigned short*>(p));
  v[0] = __uint_as_float(static_cast<unsigned>(s) << 16);
}

// -- fp32 sums written in the table type ------------------------------------

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }

__device__ __forceinline__ unsigned bf16_bits(float x) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(x)));  // RNE
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[4]) {
  uint2 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[1]) {
  *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(bf16_bits(v[0]));
}

template <typename T, int V, bool kQR, bool kCached>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
bag_kernel(const T* __restrict__ table,
           const T* __restrict__ cache,
           const T* __restrict__ r_lut,
           const int* __restrict__ idx,
           const int* __restrict__ slot,
           const int* __restrict__ r_idx,
           T* __restrict__ out,
           long long num_bags, int K, int dim,
           long long table_rows, long long cache_rows, long long r_rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (g >= num_bags) return;  // g is uniform across the warp
  const size_t base = static_cast<size_t>(g) * K;
  const int chunks = dim / V;

  for (int c0 = 0; c0 < chunks; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < chunks;
    const size_t col = static_cast<size_t>(c) * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kWarp) {
      const int kk = k0 + lane;
      int my_idx = 0, my_slot = -1, my_r = 0;
      if (kk < K) {
        my_idx = __ldg(idx + base + kk);
        if constexpr (kCached) {
          my_slot = __ldg(slot + base + kk);
          if (my_slot >= cache_rows) __trap();
        }
        if (my_slot < 0 && (my_idx < 0 || my_idx >= table_rows)) __trap();
        if constexpr (kQR) {
          my_r = __ldg(r_idx + base + kk);
          if (my_r < 0 || my_r >= r_rows) __trap();
        }
      }
      const int n = min(kWarp, K - k0);
      for (int j = 0; j < n; ++j) {
        const int s = kCached ? __shfl_sync(kFull, my_slot, j) : -1;
        const int i = __shfl_sync(kFull, my_idx, j);
        const int r = kQR ? __shfl_sync(kFull, my_r, j) : 0;
        if (active) {
          const T* row = s >= 0 ? cache + static_cast<size_t>(s) * dim
                                : table + static_cast<size_t>(i) * dim;
          float v[V];
          load(row + col, v);
          if constexpr (kQR) {
            float w[V];
            load(r_lut + static_cast<size_t>(r) * dim + col, w);
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] += w[e];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += v[e];
        }
      }
    }
    if (active) store(out + static_cast<size_t>(g) * dim + col, acc);
  }
}

template <typename T, bool kQR, bool kCached>
int launch(const void* table, const void* cache, const void* r_lut,
           const int* idx, const int* slot, const int* r_idx, void* out,
           long long num_bags, int K, int dim, long long table_rows,
           long long cache_rows, long long r_rows, void* stream) {
  if (num_bags <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kWarp * kWarpsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const T* c = static_cast<const T*>(cache);
  const T* r = static_cast<const T*>(r_lut);
  T* o = static_cast<T*>(out);
  if (dim % 4 == 0) {
    bag_kernel<T, 4, kQR, kCached><<<grid, block, 0, st>>>(
        t, c, r, idx, slot, r_idx, o, num_bags, K, dim, table_rows, cache_rows, r_rows);
  } else {
    bag_kernel<T, 1, kQR, kCached><<<grid, block, 0, st>>>(
        t, c, r, idx, slot, r_idx, o, num_bags, K, dim, table_rows, cache_rows, r_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 / K4b: cached QR bag.
#define QR_BAG(SUFFIX, T)                                                           \
  extern "C" int packed_qr_bag_##SUFFIX(                                            \
      const void* q_table, const void* cache, const void* r_lut, const int* q_idx,  \
      const int* slot, const int* r_idx, void* out, long long num_bags, int K,      \
      int dim, long long q_rows, long long cache_rows, long long r_rows,            \
      void* stream) {                                                               \
    return launch<T, true, true>(q_table, cache, r_lut, q_idx, slot, r_idx, out,    \
                                 num_bags, K, dim, q_rows, cache_rows, r_rows,      \
                                 stream);                                           \
  }

// K3 / K4a: cached dense bag.
#define BAG(SUFFIX, T)                                                              \
  extern "C" int packed_bag_##SUFFIX(                                               \
      const void* table, const void* cache, const int* idx, const int* slot,        \
      void* out, long long num_bags, int K, int dim, long long table_rows,          \
      long long cache_rows, void* stream) {                                         \
    return launch<T, false, true>(table, cache, nullptr, idx, slot, nullptr, out,   \
                                  num_bags, K, dim, table_rows, cache_rows, 0,      \
                                  stream);                                          \
  }

// K6: QR bag, no cache.
#define GNR_BAG(SUFFIX, T)                                                          \
  extern "C" int gnr_bag_##SUFFIX(                                                  \
      const void* q_table, const void* r_lut, const int* q_idx, const int* r_idx,   \
      void* out, long long num_bags, int K, int dim, long long q_rows,              \
      long long r_rows, void* stream) {                                             \
    return launch<T, true, false>(q_table, nullptr, r_lut, q_idx, nullptr, r_idx,   \
                                  out, num_bags, K, dim, q_rows, 0, r_rows, stream); \
  }

// K7: dense bag, no cache.
#define GNR_BAG_DENSE(SUFFIX, T)                                                    \
  extern "C" int gnr_bag_dense_##SUFFIX(                                            \
      const void* table, const int* idx, void* out, long long num_bags, int K,      \
      int dim, long long table_rows, void* stream) {                                \
    return launch<T, false, false>(table, nullptr, nullptr, idx, nullptr, nullptr,  \
                                   out, num_bags, K, dim, table_rows, 0, 0, stream); \
  }

QR_BAG(f32, float)
QR_BAG(bf16, bf16)
BAG(f32, float)
BAG(bf16, bf16)
GNR_BAG(f32, float)
GNR_BAG(bf16, bf16)
GNR_BAG_DENSE(f32, float)
GNR_BAG_DENSE(bf16, bf16)
