// Unpooled quotient-remainder gather for Hopper (sm_90a): K8 qr_gather.
//
// Replaces the TPU kernel repro/kernels/qr_gather.py:42 qr_gather
// (pallas_call :61), body _kernel (:33).
//
// What it computes, over N int32 (q, r) index pairs:
//   out[n] = Q[q_idx[n]] + R[r_idx[n]]
// added in the table type with no fp32 upcast, as the Pallas body adds its
// two blocks (qr_gather.py:36) and writes the table dtype (:74): a plain add
// in fp32, __hadd2 in bf16 (one rounding to nearest even).
//
// Bound: bytes.  Per lookup one Q row is read from device memory (512 B at
// dlrm dim 128 in fp32), one R row (R is 64 rows x 512 B at dlrm width, which
// the 50 MB L2 serves after its first read) and one row is written; one add
// per value, about 0.25 flop per byte.  The least time is the index streams,
// the unique Q and R rows and the output over the memory rate.
//
// Design (first version: simple and right; speed is later work):
// * One thread per 16-byte output chunk (4 fp32 or 8 bf16 values) over a
//   flat N x dim grid, grid-stride: neighbouring threads write neighbouring
//   chunks of one row, so each row is read and written in coalesced 16-byte
//   accesses.  A dim that is not a multiple of the chunk takes the same
//   grid with one value a thread.
// * The TPU pinned R in VMEM (its BlockSpec index map is constant); here R
//   stays in global memory and L2 keeps it.
// * Threads of one row read the same two indices; L1 serves the repeats.
//
// Offsets are 64-bit (size_t).  An index outside its buffer traps (a launch
// fault at the next sync) instead of reading other memory.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched).  Buffers start on 16 bytes (the wrapper
// checks it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void add_chunk(const float* a, const float* b, float* o,
                                          int vec) {
  if (vec) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a));
    const float4 y = __ldg(reinterpret_cast<const float4*>(b));
    *reinterpret_cast<float4*>(o) = make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  } else {
    *o = __ldg(a) + __ldg(b);
  }
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(unsigned u) {
  return __halves2bfloat162(__ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu)),
                            __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16)));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 h) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__low2bfloat16(h))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__high2bfloat16(h))) << 16);
}

__device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
  return bits(__hadd2(as_bf162(a), as_bf162(b)));
}

__device__ __forceinline__ void add_chunk(const bf16* a, const bf16* b, bf16* o, int vec) {
  if (vec) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(b));
    uint4 s;
    s.x = add2(x.x, y.x);
    s.y = add2(x.y, y.y);
    s.z = add2(x.z, y.z);
    s.w = add2(x.w, y.w);
    *reinterpret_cast<uint4*>(o) = s;
  } else {
    const unsigned short x = __ldg(reinterpret_cast<const unsigned short*>(a));
    const unsigned short y = __ldg(reinterpret_cast<const unsigned short*>(b));
    *o = __hadd(__ushort_as_bfloat16(x), __ushort_as_bfloat16(y));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
qr_gather_kernel(const T* __restrict__ q_table, const T* __restrict__ r_lut,
                 const int* __restrict__ q_idx, const int* __restrict__ r_idx,
                 T* __restrict__ out, long long n, int dim, int width,
                 long long q_rows, long long r_rows) {
  // width: values per thread, 16 / sizeof(T) on the vector path, else 1
  const int chunks = dim / width;
  const long long total = n * chunks;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long row = t / chunks;
    const int c = static_cast<int>(t - row * chunks);
    const int qi = __ldg(q_idx + row);
    const int ri = __ldg(r_idx + row);
    if (qi < 0 || qi >= q_rows || ri < 0 || ri >= r_rows) __trap();
    const size_t col = static_cast<size_t>(c) * width;
    add_chunk(q_table + static_cast<size_t>(qi) * dim + col,
              r_lut + static_cast<size_t>(ri) * dim + col,
              out + static_cast<size_t>(row) * dim + col, width > 1);
  }
}

template <typename T>
int launch(const void* q_table, const void* r_lut, const int* q_idx, const int* r_idx,
           void* out, long long n, int dim, long long q_rows, long long r_rows,
           void* stream) {
  if (n <= 0 || dim <= 0) return static_cast<int>(cudaGetLastError());
  const int vec = static_cast<int>(16 / sizeof(T));
  const int width = dim % vec == 0 ? vec : 1;
  const long long total = n * (dim / width);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  qr_gather_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q_table), static_cast<const T*>(r_lut), q_idx, r_idx,
      static_cast<T*>(out), n, dim, width, q_rows, r_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qr_gather_f32(const void* q_table, const void* r_lut, const int* q_idx,
                             const int* r_idx, void* out, long long n, int dim,
                             long long q_rows, long long r_rows, void* stream) {
  return launch<float>(q_table, r_lut, q_idx, r_idx, out, n, dim, q_rows, r_rows, stream);
}

extern "C" int qr_gather_bf16(const void* q_table, const void* r_lut, const int* q_idx,
                              const int* r_idx, void* out, long long n, int dim,
                              long long q_rows, long long r_rows, void* stream) {
  return launch<bf16>(q_table, r_lut, q_idx, r_idx, out, n, dim, q_rows, r_rows, stream);
}
