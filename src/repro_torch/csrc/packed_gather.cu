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
// touched, the output) over the memory rate.
//
// What the first body (one warp a bag, eight consecutive bags of
// eight different tables a block, 8-byte loads in bf16) lost its time to, by
// the readings of scripts/torch_bag_profile.py on the card (PERF.md): not
// device memory (with every request served from cache K1 kept 84-94% of its
// time) but the rate at which rows came in through the cache hierarchy, one
// row load in flight per warp and several instructions per element.
//
// Design, each choice measured against the alternatives on the card
// (PERF.md):
// * The grid is (table, run of bags), table-major: the packed streams put
//   bag b of table t at g = b*T + t, and a block takes one pass of its warps
//   over nb consecutive bags of one table, so the blocks resident at a time
//   read few tables' rows.  T = 1 is the per-table kernels' case (K4, K6,
//   K7) and that of any caller that does not pass T.  Short one-pass blocks
//   keep the grid fine-grained; longer runs lost 30-50% to the tail.
// * Loads are 16 bytes a lane: a float4 in fp32, 8 bf16 values (widened
//   exactly by shifting the bits) in bf16.  A bag takes `lanes` lanes, its
//   dim in such chunks rounded up to a power of two (dim 128: 32 lanes in
//   fp32, 16 in bf16), so a warp sums 32 / lanes bags side by side and every
//   warp instruction moves a whole 512-byte row or two 256-byte rows.  The
//   wrapper gives bf16 grids too small to fill the card (one table's bags)
//   8-byte loads of 4 values and a warp a bag instead: there the latency of
//   each warp's chain of elements binds, and twice the warps hide more of
//   it.  A dim that is not a multiple of 4 takes one value a lane.
// * Each lane computes one element's row pointer (the cache row of a hit, the
//   table row of a miss: a plain branch) and R row pointer; the group takes
//   them by shuffle, element by element.
// * Tried and dropped: eight or four rows in flight a lane (more registers,
//   fewer resident warps: slower at every shape), and the table's R rows
//   staged once a block in shared memory (its prologue cost more than the R
//   reads, which the SM's L1 already serves: a table's R is 16-32 KB).
// Each bag's sum runs over k = 0..K-1 in order, in fp32, with no atomics:
// v = row (+ R row), acc += v, the R row added to the table row first, the
// sum rounded once to the table type.  So the outputs are bitwise those of
// the first body and of an fp32 in-order loop over k.
//
// Residency does not carry over.  The TPU kept the cache block and the R LUT
// in VMEM (VMEM_RESIDENT_BUDGET 12 MiB, packed_gather.py:52).  At dlrm-qr
// full width the packed cache block is 16,384 slots x 512 B = 8 MiB
// (tune/knobs.py:156-157) and the packed R is 26*64+1 = 1,665 rows = 852 KB;
// a block has 227 KB of shared memory.  The cache block stays in global
// memory and L2, R's hot rows in each SM's L1.
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
// wrappers check it), so a row starts on 16 bytes in fp32 when dim is a
// multiple of 4 and in bf16 when it is a multiple of 8 (a bf16 dim that is a
// multiple of 4 only takes 8-byte loads of 4 values).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
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

// 8 bf16 values (16 bytes), widened exactly
__device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  u.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  u.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  u.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ const void* shfl_ptr(const void* p, int src, int width) {
  const unsigned long long u = reinterpret_cast<unsigned long long>(p);
  const unsigned lo = __shfl_sync(kFull, static_cast<unsigned>(u), src, width);
  const unsigned hi = __shfl_sync(kFull, static_cast<unsigned>(u >> 32), src, width);
  return reinterpret_cast<const void*>((static_cast<unsigned long long>(hi) << 32) | lo);
}

// The grid: `tables` x ceil(per_table / nb) blocks, table-major.  Block x
// takes table x / runs and bags b0 = (x % runs) * nb .. of it, one pass of
// its warps (nb = warps x bags a warp).  A bag takes `lanes` lanes (a power
// of two: its dim / V value chunks rounded up, at most 32; a wider dim loops
// over chunks of 32 lanes), so a warp sums 32 / lanes bags side by side.
// 16-byte bf16 rows: at most 32 registers, so 16 blocks (the SM's 64 warps)
// are resident; the fp32 bodies keep the compiler's choice (capping the QR
// one at 32 registers made it slower)
template <typename T, int V, bool kQR, bool kCached>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, V == 8 ? 16 : 1)
bag_kernel(const T* __restrict__ table,
           const T* __restrict__ cache,
           const T* __restrict__ r_lut,
           const int* __restrict__ idx,
           const int* __restrict__ slot,
           const int* __restrict__ r_idx,
           T* __restrict__ out,
           long long num_bags, int K, int dim,
           long long table_rows, long long cache_rows, long long r_rows,
           int tables, int nb, int lanes) {
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x / kWarp;
  const long long per_table = num_bags / tables;
  const long long runs = (per_table + nb - 1) / nb;
  const int t = static_cast<int>(blockIdx.x / runs);
  const long long b0 = (blockIdx.x - static_cast<long long>(t) * runs) * nb;
  const int nbags = static_cast<int>(min(static_cast<long long>(nb), per_table - b0));
  const int chunks = dim / V;
  const int per_warp = kWarp / lanes;            // bags a warp sums side by side
  const int li = lane & (lanes - 1);

  for (int bb0 = warp * per_warp; bb0 < nbags; bb0 += kWarpsPerBlock * per_warp) {
    const int bb = bb0 + lane / lanes;
    const bool bag_ok = bb < nbags;
    const long long g = bag_ok ? (b0 + bb) * tables + t : 0;
    const size_t base = static_cast<size_t>(g) * K;
    for (int c0 = 0; c0 < chunks; c0 += lanes) {
      const int c = c0 + li;
      const bool active = bag_ok && c < chunks;
      const size_t col = static_cast<size_t>(c) * V;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.f;
      for (int k0 = 0; k0 < K; k0 += lanes) {
        // this lane's element k0 + li of its bag: its row (the cache row of a
        // hit, else the table row) and for K1 its R row
        const int kk = k0 + li;
        const T* my_row = table;
        const T* my_r = r_lut;
        int my_i = 0;
        if (bag_ok && kk < K) {
          const int i = my_i = __ldg(idx + base + kk);
          int s = -1;
          if constexpr (kCached) {
            s = __ldg(slot + base + kk);
            if (s >= cache_rows) __trap();
          }
          if (s < 0 && (i < 0 || i >= table_rows)) __trap();
          my_row = s >= 0 ? cache + static_cast<size_t>(s) * dim
                          : table + static_cast<size_t>(i) * dim;
          if constexpr (kQR) {
            const int r = __ldg(r_idx + base + kk);
            if (r < 0 || r >= r_rows) __trap();
            my_r = r_lut + static_cast<size_t>(r) * dim;
          }
        }
        const int n = min(lanes, K - k0);
        for (int j = 0; j < n; ++j) {
          // K7 shuffles its one index (one shuffle, the shorter chain); the
          // others their row pointers (two shuffles each, no address math)
          const T* row = kQR || kCached
              ? static_cast<const T*>(shfl_ptr(my_row, j, lanes))
              : table + static_cast<size_t>(__shfl_sync(kFull, my_i, j, lanes)) * dim;
          const T* rrow = kQR ? static_cast<const T*>(shfl_ptr(my_r, j, lanes)) : nullptr;
          if (!active) continue;
          float v[V];
          load(row + col, v);
          if constexpr (kQR) {
            float w[V];
            load(rrow + col, w);
#pragma unroll
            for (int e = 0; e < V; ++e) v[e] += w[e];
          }
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] += v[e];
        }
      }
      if (active) store(out + static_cast<size_t>(g) * dim + col, acc);
    }
  }
}

// lanes a bag takes for `chunks` value chunks: the next power of two, at most 32
inline int bag_lanes(int chunks) {
  int l = 1;
  while (l < chunks && l < kWarp) l *= 2;
  return l;
}

template <typename T, int V, bool kQR, bool kCached>
void launch_v(dim3 grid, cudaStream_t st, const T* t, const T* c, const T* r, const int* idx,
              const int* slot, const int* r_idx, T* o, long long num_bags, int K, int dim,
              long long table_rows, long long cache_rows, long long r_rows, int tables,
              int nb) {
  bag_kernel<T, V, kQR, kCached><<<grid, kWarp * kWarpsPerBlock, 0, st>>>(
      t, c, r, idx, slot, r_idx, o, num_bags, K, dim, table_rows, cache_rows, r_rows, tables,
      nb, bag_lanes(dim / V));
}

template <typename T, bool kQR, bool kCached>
int launch(const void* table, const void* cache, const void* r_lut,
           const int* idx, const int* slot, const int* r_idx, void* out,
           long long num_bags, int K, int dim, long long table_rows,
           long long cache_rows, long long r_rows, int tables, int nb, int vec,
           void* stream) {
  if (num_bags <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  if (tables <= 0 || num_bags % tables != 0 || nb <= 0 || dim % vec != 0 ||
      (vec != 1 && vec != 4 && !(vec == 8 && sizeof(T) == 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_table = num_bags / tables;
  const long long blocks = tables * ((per_table + nb - 1) / nb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* t = static_cast<const T*>(table);
  const T* c = static_cast<const T*>(cache);
  const T* r = static_cast<const T*>(r_lut);
  T* o = static_cast<T*>(out);
  if constexpr (sizeof(T) == 2) {
    if (vec == 8) {                              // bf16: 16-byte loads of 8 values
      launch_v<T, 8, kQR, kCached>(grid, st, t, c, r, idx, slot, r_idx, o, num_bags, K, dim,
                                   table_rows, cache_rows, r_rows, tables, nb);
      return static_cast<int>(cudaGetLastError());
    }
  }
  if (vec == 4)
    launch_v<T, 4, kQR, kCached>(grid, st, t, c, r, idx, slot, r_idx, o, num_bags, K, dim,
                                 table_rows, cache_rows, r_rows, tables, nb);
  else
    launch_v<T, 1, kQR, kCached>(grid, st, t, c, r, idx, slot, r_idx, o, num_bags, K, dim,
                                 table_rows, cache_rows, r_rows, tables, nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 / K4b: cached QR bag.
#define QR_BAG(SUFFIX, T)                                                           \
  extern "C" int packed_qr_bag_##SUFFIX(                                            \
      const void* q_table, const void* cache, const void* r_lut, const int* q_idx,  \
      const int* slot, const int* r_idx, void* out, long long num_bags, int K,      \
      int dim, long long q_rows, long long cache_rows, long long r_rows,            \
      int tables, int nb, int vec, void* stream) {                                  \
    return launch<T, true, true>(q_table, cache, r_lut, q_idx, slot, r_idx, out,    \
                                 num_bags, K, dim, q_rows, cache_rows, r_rows,      \
                                 tables, nb, vec, stream);                          \
  }

// K3 / K4a: cached dense bag.
#define BAG(SUFFIX, T)                                                              \
  extern "C" int packed_bag_##SUFFIX(                                               \
      const void* table, const void* cache, const int* idx, const int* slot,        \
      void* out, long long num_bags, int K, int dim, long long table_rows,          \
      long long cache_rows, int tables, int nb, int vec, void* stream) {            \
    return launch<T, false, true>(table, cache, nullptr, idx, slot, nullptr, out,   \
                                  num_bags, K, dim, table_rows, cache_rows, 0,      \
                                  tables, nb, vec, stream);                         \
  }

// K6: QR bag, no cache.
#define GNR_BAG(SUFFIX, T)                                                          \
  extern "C" int gnr_bag_##SUFFIX(                                                  \
      const void* q_table, const void* r_lut, const int* q_idx, const int* r_idx,   \
      void* out, long long num_bags, int K, int dim, long long q_rows,              \
      long long r_rows, int nb, int vec, void* stream) {                            \
    return launch<T, true, false>(q_table, nullptr, r_lut, q_idx, nullptr, r_idx,   \
                                  out, num_bags, K, dim, q_rows, 0, r_rows, 1, nb,  \
                                  vec, stream);                                     \
  }

// K7: dense bag, no cache.
#define GNR_BAG_DENSE(SUFFIX, T)                                                    \
  extern "C" int gnr_bag_dense_##SUFFIX(                                            \
      const void* table, const int* idx, void* out, long long num_bags, int K,      \
      int dim, long long table_rows, int nb, int vec, void* stream) {               \
    return launch<T, false, false>(table, nullptr, nullptr, idx, nullptr, nullptr,  \
                                   out, num_bags, K, dim, table_rows, 0, 0, 1, nb,  \
                                   vec, stream);                                    \
  }

QR_BAG(f32, float)
QR_BAG(bf16, bf16)
BAG(f32, float)
BAG(bf16, bf16)
GNR_BAG(f32, float)
GNR_BAG(bf16, bf16)
GNR_BAG_DENSE(f32, float)
GNR_BAG_DENSE(bf16, bf16)
