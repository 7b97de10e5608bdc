// Packed multi-table pooled bags for Hopper (sm_90a): K1 packed_qr_bag and
// K3 packed_bag, one source with a compile-time switch.
//
// Replaces the TPU kernels
//   K1: repro/kernels/packed_gather.py:130 packed_qr_bag
//       -> repro/kernels/cached_gather.py:123 cached_qr_bag (pallas_call :147),
//       body _cached_qr_kernel (:54);
//   K3: repro/kernels/packed_gather.py:103 packed_bag
//       -> repro/kernels/cached_gather.py:82 cached_bag (pallas_call :104),
//       body _cached_kernel (:37).
// K3 is K1 without the R add, so kQR selects the variant.
//
// What it computes, over G = B*T bags of K globally offset int32 indices:
//   out[g] = sum_k ( (slot[g,k] >= 0 ? C[slot[g,k]] : T[idx[g,k]]) (+ R[r_idx[g,k]]) )
// fp32 tables in, fp32 sums, fp32 out (the table dtype).
//
// Bound: bytes.  Each element of a bag costs one 512 B row read (dlrm dim 128)
// and one add per float: about 0.25 flop per byte, far below the card's
// ~20 flop/B fp32 balance point.  The least time is the bytes this batch
// must move (index streams, the unique rows touched, the output) over the
// memory rate; the design keeps every byte read in 16 B vector loads and
// reads nothing twice from device memory that L2 does not serve.
//
// Design (first version: simple and right; speed is later work):
// * One warp per bag.  Lanes span dim in 16-byte float4 loads: dim 128 is
//   32 lanes x 4 floats, one row is one coalesced 512 B warp load.  Wider
//   rows loop over 128-float column chunks.
// * The bag's K indices, slots and R indices are loaded once per warp (one
//   per lane) and broadcast with __shfl_sync.
// * K is walked in order 0..K-1 inside the warp, with no atomics, so the
//   summation order is fixed; the TPU kernel got the same order from its
//   sequential grid revisiting the output block.  Adds are plain fp32 adds
//   (no multiply, so no FMA contraction changes the rounding).
// * A hit or a miss is a plain branch on the slot.  It replaces the TPU's
//   "pin hits to block 0 so the DMA is elided" index map
//   (cached_gather.py:73-78).
//
// Residency does not carry over.  The TPU kept the cache block and the R LUT
// in VMEM (VMEM_RESIDENT_BUDGET 12 MiB, packed_gather.py:52).  At dlrm-qr
// full width the cache block is 16,384 slots x 512 B = 8 MiB
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
// cudaGetLastError() (0 = launched).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <bool kQR>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
packed_bag_kernel(const float4* __restrict__ table,
                  const float4* __restrict__ cache,
                  const float4* __restrict__ r_lut,
                  const int* __restrict__ idx,
                  const int* __restrict__ slot,
                  const int* __restrict__ r_idx,
                  float4* __restrict__ out,
                  long long num_bags, int K, int dim4,
                  long long table_rows, long long cache_rows, long long r_rows) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long g =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (g >= num_bags) return;  // g is uniform across the warp
  const size_t base = static_cast<size_t>(g) * K;

  for (int c0 = 0; c0 < dim4; c0 += kWarp) {
    const int c = c0 + lane;
    const bool active = c < dim4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < K; k0 += kWarp) {
      const int kk = k0 + lane;
      int my_idx = 0, my_slot = -1, my_r = 0;
      if (kk < K) {
        my_idx = __ldg(idx + base + kk);
        my_slot = __ldg(slot + base + kk);
        if (my_slot >= cache_rows) __trap();
        if (my_slot < 0 && (my_idx < 0 || my_idx >= table_rows)) __trap();
        if constexpr (kQR) {
          my_r = __ldg(r_idx + base + kk);
          if (my_r < 0 || my_r >= r_rows) __trap();
        }
      }
      const int n = min(kWarp, K - k0);
      for (int j = 0; j < n; ++j) {
        const int s = __shfl_sync(kFull, my_slot, j);
        const int i = __shfl_sync(kFull, my_idx, j);
        const int r = kQR ? __shfl_sync(kFull, my_r, j) : 0;
        if (active) {
          const float4* row = s >= 0 ? cache + static_cast<size_t>(s) * dim4
                                     : table + static_cast<size_t>(i) * dim4;
          float4 v = __ldg(row + c);
          if constexpr (kQR) add4(v, __ldg(r_lut + static_cast<size_t>(r) * dim4 + c));
          add4(acc, v);
        }
      }
    }
    if (active) out[static_cast<size_t>(g) * dim4 + c] = acc;
  }
}

template <bool kQR>
int launch(const float* table, const float* cache, const float* r_lut,
           const int* idx, const int* slot, const int* r_idx, float* out,
           long long num_bags, int K, int dim, long long table_rows,
           long long cache_rows, long long r_rows, void* stream) {
  if (num_bags <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (num_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  packed_bag_kernel<kQR><<<static_cast<unsigned>(blocks), kWarp * kWarpsPerBlock,
                           0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), reinterpret_cast<const float4*>(cache),
      reinterpret_cast<const float4*>(r_lut), idx, slot, r_idx,
      reinterpret_cast<float4*>(out), num_bags, K, dim / 4, table_rows,
      cache_rows, r_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int packed_qr_bag_f32(const float* q_table, const float* cache,
                                 const float* r_lut, const int* q_idx,
                                 const int* slot, const int* r_idx, float* out,
                                 long long num_bags, int K, int dim,
                                 long long q_rows, long long cache_rows,
                                 long long r_rows, void* stream) {
  return launch<true>(q_table, cache, r_lut, q_idx, slot, r_idx, out, num_bags,
                      K, dim, q_rows, cache_rows, r_rows, stream);
}

extern "C" int packed_bag_f32(const float* table, const float* cache,
                              const int* idx, const int* slot, float* out,
                              long long num_bags, int K, int dim,
                              long long table_rows, long long cache_rows,
                              void* stream) {
  return launch<false>(table, cache, nullptr, idx, slot, nullptr, out, num_bags,
                       K, dim, table_rows, cache_rows, 0, stream);
}
