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
//   out[g] = row_0 + row_1 + ... + row_{K-1}, in k order, no atomics,
//   rounded once to the core type.
// dims (d1, d2, d3, rank) are runtime arguments, so the smoke cores
// (4, 4, 2, 4) and dlrm-tt's (4, 8, 4, 16) run the same code.
//
// Bound: operations.  A dlrm-tt element is (4,16)@(16,128) then (32,16)@(16,4):
// 10,240 FMAs = 20,480 flops for one 8 KiB G2 row, so a serving batch of
// 53,248 bags x 32 is 3.49e10 flops = 0.52 ms at 67 TFLOP/s fp32, against
// at most ~363 MB of unique bytes.  (The bf16 bound at the training batch,
// 0.14 ms, counts the flops at the tensor-core rate: the least the card
// could take, not what this body aims at.)
//
// What the first version lost its time to: every element staged its whole
// G2 row into shared memory, ~14 GB per serving batch through L2, though a
// batch touches at most 36,609 distinct G2 rows (each re-read ~47 times),
// with three barriers per element and nothing in flight.
//
// Design: stage each middle-core row once per run of elements that use it.
// * The wrapper orders the G*K elements by their middle-core source (the
//   cache slot of a hit, else cache_rows + the G2 row), with torch.sort on
//   the card, and passes the order and an fp32 scratch of one output row per
//   element.
// * Pass 1 (tt_rows_kernel): a block of 256 threads takes a window of
//   kWindow = 64 consecutive sorted elements.  It reads their indices (the
//   index traps live here) and finds the window's runs of equal source in
//   one 64-bit ballot mask.  It stages the elements' G1 rows transposed and
//   widened (A^T: column e*d1 + i is element e's row i) and, by cp.async,
//   their G3 rows (Cm) and the first run's middle row M, all in flight at
//   once; each later run's M comes by cp.async into a second buffer while
//   the previous run computes.  For up to kSliceRows / d1 elements of a run
//   at a time, t = A @ M is formed for all of them on the CUDA cores in
//   fp32, each thread an 8 x 4 tile of t: per depth step two broadcast
//   float4 of A^T and one float4 of M feed 32 FMAs, so the FMA pipe and not
//   shared memory sets the pace.  Then row = t @ Cm per element in fp32,
//   and the row goes to the element's scratch slot as float4.  No loop
//   divides: index tables are built once a block.
// * Pass 2 (tt_sum_kernel): out[g] = sum_k scratch[g*K + k] in k order,
//   rounded once to the core type (round to nearest even for bf16).
// Every product is an fmaf in depth order, as the plain version's fp32
// matmuls on the card compute it, so the output is bitwise the plain
// version's.  A tensor-core body for bf16 (mma.sync, t = A @ M from bf16
// operands with fp32 accumulation) held the one-rounding contract but
// rounded 0.01% of outputs one bf16 step away from the plain version, which
// moves the training path's step-1 table gradients by ~6% of scale (see
// PERF.md); this body keeps bf16 on the CUDA cores.
// * A middle-core row too large for the block (rank 64: 128 KiB of fp32 at
//   dim 128, 256 KiB double-buffered) is staged in d2 slices: M's columns
//   j*r .. (j+d2s)*r - 1 for d2s of the d2 column groups at a time (a
//   divisor of d2, the largest whose block fits; d2s = d2 is the one-stage
//   layout above, unchanged).  t = A @ M is formed one slice at a time, and
//   each slice's t rows give the outputs of its d2 indices: every product is
//   the same fmaf chain over the same depth, so the sliced path is bitwise
//   the one-stage path.  Slices of a run and the runs follow each other
//   through the same two buffers, the next one always in flight.
// The scratch round trip (0.87 GB serving, 3.5 GB at the training batch)
// is this design's own floor beside the bound: 0.52 ms and 2.1 ms at
// 3.35 TB/s.
//
// Residency does not carry over.  The TPU kept G1, G3 and the cache block
// in VMEM (VMEM_RESIDENT_BUDGET 12 MiB, packed_gather.py:52).  Here they are
// read from global memory and left to L2: the packed G1 and G3 of 26 tables
// are 0.5 MB, the cache block 1,024 slots x 8 KiB = 8 MiB.
//
// Offsets are 64-bit (size_t).  An index outside its buffer traps (a launch
// fault at the next sync) instead of reading another table's memory.
//
// Plain C interface for ctypes: each entry point launches both passes on
// the given stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for dims it
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 64;          // sorted elements a block takes: run starts in one mask
constexpr int kSliceRows = 32;       // rows of t formed at once
constexpr int kMaxDim = 1024;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory of one block, in bytes from the start, for cores of
// `esize` bytes a value, staging d2s of M's d2 column groups at a time.
struct Layout {
  int ncp;       // columns of an M stage (d2s*r), padded to 4
  int atstride;  // row stride of A^T in floats (= 4 mod 32: transposing stores spread)
  int seg;       // stride of one rank segment of a t row (floats)
  int ts;        // row stride of t (floats)
  int r4;        // rank rounded to 4: the second product's depth
  size_t pos, src, r1, r3, tcol, tij, at, c3, c3f, m, mbytes, t, total;
};

__host__ __device__ inline Layout layout(int d1, int d2s, int d3, int rank, int esize) {
  Layout L;
  const int ncols = d2s * rank;
  L.ncp = round_up(ncols, 4);
  L.atstride = round_up(kWindow * d1 + kSliceRows, 32) + 4;
  L.r4 = round_up(rank, 4);
  L.seg = L.r4 + 4;                           // float4 reads of 8 segments hit 32 banks
  L.ts = d2s * L.seg;
  size_t off = 0;
  L.pos = off; off = align16(off + sizeof(long long) * kWindow);
  L.src = off; off = align16(off + sizeof(long long) * kWindow);
  L.r1 = off;  off = align16(off + sizeof(int) * kWindow);
  L.r3 = off;  off = align16(off + sizeof(int) * kWindow);
  L.tcol = off; off = align16(off + sizeof(int) * L.ncp);
  L.tij = off; off = align16(off + sizeof(int2) * d1 * d2s);
  L.at = off;  off = align16(off + sizeof(float) * rank * L.atstride);
  L.c3 = off;  off = align16(off + static_cast<size_t>(esize) * kWindow * L.r4 * d3);
  L.c3f = L.c3;                               // bf16: Cm widened once a window
  if (esize != 4) {
    L.c3f = off;
    off = align16(off + sizeof(float) * kWindow * L.r4 * d3);
  }
  L.mbytes = align16(static_cast<size_t>(esize) * rank * L.ncp);
  L.m = off;   off += 2 * L.mbytes;
  L.t = off;   off = align16(off + sizeof(float) * kSliceRows * L.ts);
  L.total = off;
  return L;
}

// -- loads and stores ---------------------------------------------------------

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// four consecutive values as fp32 (bf16: 8-byte aligned, widened exactly)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// -- pass 1: one output row per element, each middle row staged once per run --

// three blocks a SM: 80 registers a thread, no spill
template <typename T, bool kCached>
__global__ void __launch_bounds__(kThreads, 3)
tt_rows_kernel(const T* __restrict__ g1, const T* __restrict__ g2, const T* __restrict__ g3,
               const T* __restrict__ cache, const int* __restrict__ i1,
               const int* __restrict__ i2, const int* __restrict__ i3,
               const int* __restrict__ slot, const long long* __restrict__ order,
               float* __restrict__ scratch, long long n, int d1, int d2, int d3, int rank,
               int d2s, long long g1_rows, long long g2_rows, long long g3_rows,
               long long cache_rows) {
  const Layout L = layout(d1, d2s, d3, rank, sizeof(T));
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  long long* pos_s = reinterpret_cast<long long*>(smem + L.pos);
  long long* src_s = reinterpret_cast<long long*>(smem + L.src);
  int* r1_s = reinterpret_cast<int*>(smem + L.r1);
  int* r3_s = reinterpret_cast<int*>(smem + L.r3);
  int* tcol_s = reinterpret_cast<int*>(smem + L.tcol);
  int2* tij_s = reinterpret_cast<int2*>(smem + L.tij);
  float* at_s = reinterpret_cast<float*>(smem + L.at);
  T* c3_s = reinterpret_cast<T*>(smem + L.c3);
  float* c3f_s = reinterpret_cast<float*>(smem + L.c3f);
  float* t_s = reinterpret_cast<float*>(smem + L.t);
  auto m_buf = [&](int u) { return reinterpret_cast<T*>(smem + L.m + (u & 1) * L.mbytes); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long w0 = static_cast<long long>(blockIdx.x) * kWindow;
  const int ne = static_cast<int>(min(static_cast<long long>(kWindow), n - w0));
  const int w1 = d1 * rank, w2 = rank * d2 * rank, w3 = rank * d3;
  const int ncols = d2 * rank, dim = d1 * d2 * d3;
  const int scols = d2s * rank;       // columns of one M stage
  const int nstage = d2 / d2s;        // M stages of a run
  const int es = kSliceRows / d1;   // elements of one slice
  const int dd = d1 * d2s;            // rows of t an element has per stage, (i, j) pairs
  const int c3w = L.r4 * d3;          // Cm values an element, rows padded to r4

  // index tables, so that no loop below divides: column c of an M stage
  // lands at tcol_s[c] of its t row (-1: padding); pair (i, j) of an element
  // (j the stage's j-th d2 index) reads its t row at tij_s[.].x and writes
  // its d3 outputs at tij_s[.].y, plus the stage's first d2 index times d3
  for (int c = tid; c < L.ncp; c += kThreads)
    tcol_s[c] = c < scols ? (c / rank) * L.seg + c % rank : -1;
  for (int x = tid; x < dd; x += kThreads)
    tij_s[x] = make_int2((x / d2s) * L.ts + (x % d2s) * L.seg,
                         ((x / d2s) * d2 + x % d2s) * d3);
  const int el0 = tid / dd, rem0 = tid % dd, del = kThreads / dd, drem = kThreads % dd;

  // the pads stay zero, as nothing below writes them: of Cm and t (ranks not
  // a multiple of 4)
  if (rank != L.r4) {
    for (size_t i = tid; i < (L.m - L.c3) / 16; i += kThreads)
      reinterpret_cast<float4*>(smem + L.c3)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < kSliceRows * d2s * L.r4; i += kThreads) {
      const int q = i % L.r4, seg = i / L.r4;
      if (q >= rank) t_s[(seg / d2s) * L.ts + (seg % d2s) * L.seg + q] = 0.f;
    }
  }

  if (tid < ne) {
    const long long p = order[w0 + tid];
    const int a = __ldg(i1 + p), b = __ldg(i2 + p), c = __ldg(i3 + p);
    const int s = kCached ? __ldg(slot + p) : -1;
    if (a < 0 || a >= g1_rows || c < 0 || c >= g3_rows) __trap();
    if (kCached && s >= cache_rows) __trap();
    if (s < 0 && (b < 0 || b >= g2_rows)) __trap();
    pos_s[tid] = p;
    src_s[tid] = s >= 0 ? s : cache_rows + b;
    r1_s[tid] = a;
    r3_s[tid] = c;
  }
  __syncthreads();

  // the run starts of the window, one bit each: a run's end is the next start
  auto start_at = [&](int j) { return j < ne && (j == 0 || src_s[j] != src_s[j - 1]); };
  const unsigned long long starts =
      __ballot_sync(0xffffffffu, start_at(lane)) |
      static_cast<unsigned long long>(__ballot_sync(0xffffffffu, start_at(lane + 32))) << 32;

  // Cm rows (r4 x d3 each) by cp.async where they are whole 16-byte chunks;
  // one element's row is `chunks` copies, a warp copies 32/chunks elements
  // at once, each lane always the same chunk
  constexpr int kChunk = 16 / sizeof(T);
  const bool c_vec = w3 % kChunk == 0 && c3w % kChunk == 0 &&
                     reinterpret_cast<size_t>(g3) % 16 == 0;
  if (c_vec) {
    const int chunks = w3 / kChunk;
    if (chunks <= 32) {
      const int per = 32 / chunks, el = lane / chunks, c = lane - el * chunks;
      if (el < per)
        for (int e = warp * per + el; e < ne; e += kWarps * per)
          cp_async16(c3_s + e * c3w + c * kChunk,
                     g3 + static_cast<size_t>(r3_s[e]) * w3 + c * kChunk);
    } else {
      for (int e = warp; e < ne; e += kWarps)
        for (int c = lane; c < chunks; c += 32)
          cp_async16(c3_s + e * c3w + c * kChunk,
                     g3 + static_cast<size_t>(r3_s[e]) * w3 + c * kChunk);
    }
  } else {
    for (int e = warp; e < ne; e += kWarps)
      for (int x = lane; x < w3; x += 32)
        c3_s[e * c3w + x] = g3[static_cast<size_t>(r3_s[e]) * w3 + x];
  }
  cp_async_commit();

  // stage columns jj*scols .. (jj+1)*scols - 1 of the middle row of source
  // `src` into buffer u: cp.async when they are whole 16-byte chunks, plain
  // loads otherwise
  const bool vec = scols % kChunk == 0 && reinterpret_cast<size_t>(g2) % 16 == 0 &&
                   (!kCached || reinterpret_cast<size_t>(cache) % 16 == 0);
  auto stage_m = [&](int u, long long src, int jj) {
    const T* row = (src < cache_rows ? cache + static_cast<size_t>(src) * w2
                                     : g2 + static_cast<size_t>(src - cache_rows) * w2) +
                   jj * scols;
    T* dst = m_buf(u);
    if (vec) {
      const int per_row = scols / kChunk;
      for (int c = tid; c < rank * per_row; c += kThreads) {
        const int p = c / per_row, col = (c - p * per_row) * kChunk;
        cp_async16(dst + p * L.ncp + col, row + p * ncols + col);
      }
      cp_async_commit();
    } else {
      for (int c = tid; c < rank * scols; c += kThreads) {
        const int p = c / scols, col = c - p * scols;
        dst[p * L.ncp + col] = row[p * ncols + col];
      }
    }
  };
  if (ne > 0) stage_m(0, src_s[0], 0);

  // A^T, widened: a lane takes one value of every element's G1 row, all
  // loads of the window in flight before the stores
  for (int x = lane; x < w1; x += 32) {
    const int i = x / rank, p = x - i * rank;
    float* col = at_s + p * L.atstride + i;
#pragma unroll 4
    for (int e = warp; e < ne; e += kWarps)
      col[e * d1] = widen(g1[static_cast<size_t>(r1_s[e]) * w1 + x]);
  }

  // stage u is stage jj of a run: the run's M columns jj*scols ..
  for (int s = 0, u = 0; s < ne;) {
    const unsigned long long later = s + 1 < 64 ? starts >> (s + 1) : 0ull;
    const int e = later ? s + __ffsll(static_cast<long long>(later)) : ne;
    for (int jj = 0; jj < nstage; ++jj, ++u) {
      cp_async_wait_all();
      __syncthreads();                 // stage u is in; stage u-1 is done with buffer u+1
      if (jj + 1 < nstage)
        stage_m(u + 1, src_s[s], jj + 1);
      else if (e < ne)
        stage_m(u + 1, src_s[e], 0);
      const T* m_s = m_buf(u);
      const int jout = jj * d2s * d3;    // output offset of the stage's first d2 index
      if (sizeof(T) != 4 && u == 0)      // each Cm value serves d1*d2 items: widen once
        for (int x = tid; x < ne * c3w; x += kThreads) c3f_s[x] = widen(c3_s[x]);

      for (int e0 = s; e0 < e; e0 += es) {
        const int e1 = min(e, e0 + es);
        const int rows = (e1 - e0) * d1;

        // t = A (rows x r) @ M stage (r x d2s*r) into t_s: a thread an 8 x 4 tile,
        // fmaf in depth order
        const float* at0 = at_s + e0 * d1;
        const bool a_vec = (e0 * d1) % 4 == 0;
        const int nrg = (rows + 7) / 8, ncq = L.ncp / 4;
        for (int it = tid; it < nrg * ncq; it += kThreads) {
          const int rg = it / ncq, cq = it - rg * ncq;
          float acc[8][4] = {};
          const float* at = at0 + rg * 8;
          const T* mc = m_s + cq * 4;
#pragma unroll 4
          for (int p = 0; p < rank; ++p) {
            float av[8];
            if (a_vec) {
              const float4 lo = *reinterpret_cast<const float4*>(at + p * L.atstride);
              const float4 hi = *reinterpret_cast<const float4*>(at + p * L.atstride + 4);
              av[0] = lo.x; av[1] = lo.y; av[2] = lo.z; av[3] = lo.w;
              av[4] = hi.x; av[5] = hi.y; av[6] = hi.z; av[7] = hi.w;
            } else {
#pragma unroll
              for (int i = 0; i < 8; ++i) av[i] = at[p * L.atstride + i];
            }
            const float4 mv = load4(mc + p * L.ncp);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              acc[i][0] = fmaf(av[i], mv.x, acc[i][0]);
              acc[i][1] = fmaf(av[i], mv.y, acc[i][1]);
              acc[i][2] = fmaf(av[i], mv.z, acc[i][2]);
              acc[i][3] = fmaf(av[i], mv.w, acc[i][3]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = tcol_s[cq * 4 + j];
            if (o < 0) continue;
#pragma unroll
            for (int i = 0; i < 8; ++i) t_s[(rg * 8 + i) * L.ts + o] = acc[i][j];
          }
        }
        __syncthreads();

        // row = t (d1*d2 x r) @ Cm (r x d3) in fp32, into the scratch slot;
        // one item is one (element, i, j) row of t and its d3 outputs: this
        // thread's items step by kThreads through (element, pair) without
        // dividing
        for (int el = el0, rem = rem0; el < e1 - e0;) {
          const int2 ij = tij_s[rem];
          const float* tr = t_s + el * d1 * L.ts + ij.x;
          const float* cm = c3f_s + (e0 + el) * c3w;
          float* dst = scratch + static_cast<size_t>(pos_s[e0 + el]) * dim + ij.y + jout;
          el += del;
          rem += drem;
          if (rem >= dd) {
            rem -= dd;
            ++el;
          }
          if (d3 % 4 == 0) {              // Cm rows and the output as float4
            for (int c0 = 0; c0 < d3; c0 += 4) {
              float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
              for (int q0 = 0; q0 < L.r4; q0 += 4) {
                const float4 tv = *reinterpret_cast<const float4*>(tr + q0);
                const float tq[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
                for (int qq = 0; qq < 4; ++qq) {
                  const float4 cv = *reinterpret_cast<const float4*>(cm + (q0 + qq) * d3 + c0);
                  acc.x = fmaf(tq[qq], cv.x, acc.x);
                  acc.y = fmaf(tq[qq], cv.y, acc.y);
                  acc.z = fmaf(tq[qq], cv.z, acc.z);
                  acc.w = fmaf(tq[qq], cv.w, acc.w);
                }
              }
              *reinterpret_cast<float4*>(dst + c0) = acc;
            }
            continue;
          }
          for (int c0 = 0; c0 < d3; c0 += 4) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            for (int q0 = 0; q0 < L.r4; q0 += 4) {
              const float4 tv = *reinterpret_cast<const float4*>(tr + q0);
              const float tq[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
              for (int qq = 0; qq < 4; ++qq)
#pragma unroll
                for (int cc = 0; cc < 4; ++cc)
                  if (c0 + cc < d3) acc[cc] = fmaf(tq[qq], cm[(q0 + qq) * d3 + c0 + cc], acc[cc]);
            }
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              if (c0 + cc < d3) dst[c0 + cc] = acc[cc];
          }
        }
        __syncthreads();               // t_s is free for the next slice
      }
    }
    s = e;
  }
}

// -- pass 2: the K sum in k order, rounded once --------------------------------

// one thread per group of kV outputs (kV = 4: dim % 4 == 0, float4 loads)
template <typename T, int kV>
__global__ void __launch_bounds__(256)
tt_sum_kernel(const float* __restrict__ scratch, T* __restrict__ out, long long total, int K,
              int dim) {
  const long long x = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kV;
  if (x >= total) return;
  const long long g = x / dim;
  const int o = static_cast<int>(x - g * dim);
  const float* src = scratch + static_cast<size_t>(g) * K * dim + o;
  float acc[kV] = {};
  for (int k = 0; k < K; ++k) {
    if constexpr (kV == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + static_cast<size_t>(k) * dim);
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    } else {
      acc[0] += src[static_cast<size_t>(k) * dim];
    }
  }
#pragma unroll
  for (int i = 0; i < kV; ++i) store1(out + x + i, acc[i]);
}

// The kernel's dynamic shared memory, and the whole of the SM's unified
// memory as shared memory, so that as many blocks as fit are resident.
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, bool kCached>
int launch(const void* g1, const void* g2, const void* g3, const void* cache, const int* i1,
           const int* i2, const int* i3, const int* slot, const long long* order,
           float* scratch, void* out, long long num_bags, int K, int d1, int d2, int d3,
           int rank, int d2s, long long g1_rows, long long g2_rows, long long g3_rows,
           long long cache_rows, void* stream) {
  if (d1 <= 0 || d2 <= 0 || d3 <= 0 || rank <= 0 || K < 0 || num_bags < 0 ||
      d1 > kSliceRows || d1 * d2 * d3 > kMaxDim || d2s <= 0 || d2 % d2s != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = layout(d1, d2s, d3, rank, sizeof(T)).total;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = num_bags * K;
  const int dim = d1 * d2 * d3;
  if (n > 0) {
    const long long blocks = (n + kWindow - 1) / kWindow;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t set = set_smem(tt_rows_kernel<T, kCached>, smem);
    if (set != cudaSuccess) return static_cast<int>(set);
    tt_rows_kernel<T, kCached><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
        static_cast<const T*>(g1), static_cast<const T*>(g2), static_cast<const T*>(g3),
        static_cast<const T*>(cache), i1, i2, i3, slot, order, scratch, n, d1, d2, d3, rank,
        d2s, g1_rows, g2_rows, g3_rows, cache_rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long total = num_bags * dim;
  if (total > 0 && dim % 4 == 0) {
    tt_sum_kernel<T, 4><<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0, st>>>(
        scratch, static_cast<T*>(out), total, K, dim);
  } else if (total > 0) {
    tt_sum_kernel<T, 1><<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
        scratch, static_cast<T*>(out), total, K, dim);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one block of pass 1 takes for these dims and core type when
// it stages d2s of M's d2 column groups at a time, for the wrapper's choice.
extern "C" long long tt_bag_smem_bytes(int d1, int d2s, int d3, int rank, int bf16_cores) {
  return static_cast<long long>(layout(d1, d2s, d3, rank, bf16_cores ? 2 : 4).total);
}

// K2: packed TT bag, the middle core routed by slot.
#define PACKED_TT_BAG(SUFFIX, T)                                                        \
  extern "C" int packed_tt_bag_##SUFFIX(                                                \
      const void* g1, const void* g2, const void* g3, const void* cache,                \
      const int* i1, const int* i2, const int* i3, const int* slot,                     \
      const long long* order, float* scratch, void* out, long long num_bags, int K,     \
      int d1, int d2, int d3, int rank, int d2s, long long g1_rows, long long g2_rows,  \
      long long g3_rows, long long cache_rows, void* stream) {                          \
    return launch<T, true>(g1, g2, g3, cache, i1, i2, i3, slot, order, scratch, out,    \
                           num_bags, K, d1, d2, d3, rank, d2s, g1_rows, g2_rows,        \
                           g3_rows, cache_rows, stream);                                \
  }

// K5: one table's TT bag, every access reads G2.
#define TT_BAG(SUFFIX, T)                                                               \
  extern "C" int tt_bag_##SUFFIX(                                                       \
      const void* g1, const void* g2, const void* g3, const int* i1, const int* i2,     \
      const int* i3, const long long* order, float* scratch, void* out,                 \
      long long num_bags, int K, int d1, int d2, int d3, int rank, int d2s,             \
      long long g1_rows, long long g2_rows, long long g3_rows, void* stream) {          \
    return launch<T, false>(g1, g2, g3, nullptr, i1, i2, i3, nullptr, order, scratch,   \
                            out, num_bags, K, d1, d2, d3, rank, d2s, g1_rows, g2_rows,  \
                            g3_rows, 0, stream);                                        \
  }

PACKED_TT_BAG(f32, float)
PACKED_TT_BAG(bf16, bf16)
TT_BAG(f32, float)
TT_BAG(bf16, bf16)
