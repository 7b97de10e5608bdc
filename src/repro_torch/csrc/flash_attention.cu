// Online-softmax GQA attention for Hopper (sm_90a): K9 flash_fwd.
//
// Replaces the TPU kernel
//   K9: repro/kernels/flash_attention.py:88 flash_fwd (pallas_call :113),
//       body _kernel (:41).
//
// What it computes, per batch b and query head h (kv head kh = h / (H/KH)):
//   out[b,h] = softmax(fp32(q[b,h]) * d^-1/2 . fp32(k[b,kh])^T [+ mask]) . fp32(v[b,kh])
// with the Pallas body's numerics:
// * q is widened to fp32 before the scale is applied (:54); k and v are
//   widened to fp32; scores, running max m, running sum l and the output
//   accumulator are fp32;
// * the causal mask is top-left aligned: key j is visible from query i iff
//   i >= j (:58-63); a masked score is NEG_INF = -1e30, not -inf, and the
//   running max starts at NEG_INF;
// * per kv tile: m' = max(m, rowmax(s)); p = exp(s - m'); l' = l*exp(m - m')
//   + rowsum(p); acc' = acc*exp(m - m') + p.v (:64-70);
// * out = acc / max(l, 1e-30) (:82), written in q's type, rounded once
//   (round to nearest even for bf16);
// * kv tiles that lie wholly above the causal diagonal are skipped (:72-78).
// Keys past Skv (the ragged last tile) are not part of the softmax: their
// scores are -inf, so they count in neither the max nor the sum.
//
// Bound: operations.  Each (query row, visible key) pair costs 2*D flops for
// the score and 2*D for the p.v update: 4*B*H*Sq*Skv*D flops, halved under
// the causal mask.  At qwen2-1.5b's width (H 12, KH 2, D 128) and seq 4,096,
// batch 4, causal, that is 2.06e11 flops, 3.1 ms at 67 TFLOP/s fp32 and
// 0.21 ms at 989 TFLOP/s on the bf16 tensor cores; the bytes (q, k, v, out:
// 0.11 GB fp32) would take 0.03 ms.
//
// Two bodies, one per type (the wrapper's BODY names them):
//
// fp32 (flash_kernel, CUDA cores; TF32 would break the 1e-4 contract):
// * One block of 128 threads per (b*KH + kh, tile of kBQ rows).  The rows
//   are the (query position, group member) pairs of one kv head, query
//   position major: row r is query position r / G of head kh*G + r % G.  So
//   every K/V tile a block stages serves all G = H/KH query heads of its kv
//   head at once (granite-34b's G = 48 included), and the TPU's _tile_groups
//   fold is not needed.
// * Shared memory holds the block's q rows (scaled once), one tile of
//   kBK = 32 keys and values, and the probability tile p; rows are padded
//   to a multiple of 4 floats plus 4, so the score loop reads float4 from
//   shared memory without bank conflicts.  D is padded with zeros to the
//   block's D bucket (64, 128 or 256), so any D up to 256 runs one body.
// * Thread (ty, tx) of the 8 x 16 grid owns rows ty + 8i of the block: their
//   score columns tx + 16j of each tile and their output columns tx + 16c in
//   registers.  A row's 16 owners are 16 lanes of one warp, so a row max or
//   sum is four __shfl_xor_sync.
//
// bf16 (flash_tc_kernel, tensor cores, wgmma):
// * The same row fold and causal tile skip; one warpgroup of 128 threads
//   and 64 rows a block (the m64 of wgmma: warp w owns rows 16w..16w+15);
//   the heaviest causal blocks are launched first.
// * q stays bf16 and unscaled in shared memory; S = q . k^T by
//   wgmma.m64n64k16 with both operands in shared memory, fp32 accumulate:
//   the products of two bf16 values are exact in fp32.  The d^-1/2 scale
//   goes on the fp32 scores.
// * Online softmax in registers, as the fp32 body: masked -1e30, past Skv
//   -inf, expf, l summed from the fp32 p.  Tiles wholly inside Skv and below
//   every row's causal diagonal skip the mask and fold the scale into the
//   exponent's fma; the accumulator is rescaled only when a row's max moved.
// * O += P . V by wgmma.m64nNk16 with A in registers: P split, P_hi =
//   bf16(p), P_lo = bf16(p - P_hi), two products into one fp32 register
//   tile; B is the V tile as v lies in memory (64 keys x d, d contiguous:
//   N-major), read through wgmma's transpose bit.  Rounding p to bf16 alone
//   would cost ~49x one rounding of the output; the split brings the error
//   to fp32's order.
// * Promotion: the tensor cores' accumulate aligns its addends to the
//   largest and drops the bits below ~25 of it toward zero, a bias that
//   each k16 step adds.  Summed into o over a whole row it piled up: at
//   whisper's decoder (32,768 keys, near-flat weights, outputs ~1/1,600 of
//   the sum of |p v|) to 1.44 of one bf16 rounding.  So each kv tile's
//   products accumulate from zero in a register tile of N = D columns (64
//   at a time in the D 256 bucket), which then joins o by fp32 adds on the
//   CUDA cores, rounded to nearest.
// * Tiles live in shared memory in 128-byte-swizzled atoms of 64-value rows
//   (the layout wgmma's descriptors and TMA's SWIZZLE_128B share); the K and
//   V tiles have one layout.  They come, 64 keys at a time, by TMA into a
//   ring of two stages, counted on one mbarrier a stage, the next tile in
//   flight while the current one computes, where D % 8 == 0; by ordinary
//   loads into the same layout otherwise.  The tensor maps are 3-d (d, key,
//   batch x kv head), so TMA's zero fill pads D and each head's ragged last
//   tile.  q's rows are not one box when G > 1 (the fold), so q comes by
//   cp.async, once.
// * D buckets 64, 128 and 256 (the accumulator is 128 fp32 a thread at D
//   256), padded with zeros.
// * Output acc / max(l, 1e-30), rounded once to bf16.
//
// p_bf16 (both bodies; repro's flash_block_dtype="bf16", _attn_block's
// p_dtype): each probability is rounded to bf16 (round to nearest even, as
// torch's .to(torch.bfloat16) and __floats2bfloat162_rn round) right after
// its exp, and that rounded value goes into both the row sum l and the p.v
// product.  The fp32 body rounds p before it is stored to p_s and added to
// psum; the bf16 body sums the rounded values into l and issues only the
// P_hi product a k16 step (P_lo, what rounding left, is zero).

// Common numerics, as the Pallas body: scores, running max m, running sum l
// and the output accumulator are fp32; the causal mask is top-left aligned
// (key j visible from query i iff i >= j, :58-63), a masked score is
// NEG_INF = -1e30 and the running max starts there; per kv tile m' =
// max(m, rowmax(s)); p = exp(s - m'); l' = l*exp(m - m') + rowsum(p);
// acc' = acc*exp(m - m') + p.v (:64-70); out = acc / max(l, 1e-30) (:82)
// rounded once; kv tiles wholly above the causal diagonal are skipped
// (:72-78).  Keys past Skv count in neither the max nor the sum.  expf, not
// __expf: the accurate exponential.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes it
// does not take.  Offsets are 64-bit (size_t).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 8 row groups x 16 column lanes
constexpr int kBK = 32;             // keys per kv tile
constexpr float kNegInf = -1e30f;   // repro's NEG_INF
constexpr size_t kMaxSmem = 232448; // 227 KB a block
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// -- fp32 body ------------------------------------------------------------------

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Rows of a block for a D bucket: 64, or 32 at D 256 (registers).
template <int kDMax>
struct Tile {
  static constexpr int kBQ = kDMax > 128 ? 32 : 64;
  static constexpr int kRS = kBQ / 8;         // rows a thread owns
  static constexpr int kCS = kBK / 16;        // score columns a thread owns
  static constexpr int kCD = kDMax / 16;      // output columns a thread owns
  static constexpr int kQS = kDMax + 4;       // row strides in floats
  static constexpr int kKS = kDMax + 4;
  static constexpr int kVS = kDMax;
  static constexpr int kPS = kBK + 16;
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * kQS + kBK * kKS + kBK * kVS + kBQ * kPS);
};

// Stage `n` rows of `D` values into shared memory (row stride `stride`),
// widened to fp32 and multiplied by `mul`; the pad up to kDMax and rows past
// `valid` are zero.  `row(i)` gives the global address of row i.
template <typename T, int kDMax, bool kVec, typename RowFn>
__device__ __forceinline__ void stage(float* dst, int stride, int n, int valid, int D,
                                      float mul, RowFn row) {
  if constexpr (kVec) {
    constexpr int kChunks = kDMax / 4;
    for (int e = threadIdx.x; e < n * kChunks; e += kThreads) {
      const int i = e / kChunks, col = (e - i * kChunks) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < valid && col < D) {
        load4(row(i) + col, v);
#pragma unroll
        for (int x = 0; x < 4; ++x) v[x] *= mul;
      }
      *reinterpret_cast<float4*>(dst + i * stride + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = threadIdx.x; e < n * kDMax; e += kThreads) {
      const int i = e / kDMax, col = e - i * kDMax;
      dst[i * stride + col] = (i < valid && col < D) ? load1(row(i) + col) * mul : 0.f;
    }
  }
}

// p rounded to bf16 (nearest even) where kPBf16, else as it is
template <bool kPBf16>
__device__ __forceinline__ float p_tile(float p) {
  if constexpr (kPBf16) return __bfloat162float(__float2bfloat16_rn(p));
  return p;
}

template <typename T, int kDMax, bool kVec, bool kPBf16>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int H, int KH, int Sq, int Skv, int D, float scale,
             int causal) {
  using Tl = Tile<kDMax>;
  constexpr int kBQ = Tl::kBQ, kRS = Tl::kRS, kCS = Tl::kCS, kCD = Tl::kCD;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kBQ * Tl::kQS;
  float* v_s = k_s + kBK * Tl::kKS;
  float* p_s = v_s + kBK * Tl::kVS;

  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y - b * KH;
  const long long rows = static_cast<long long>(G) * Sq;
  const long long r0 = static_cast<long long>(blockIdx.x) * kBQ;
  const int valid_rows = static_cast<int>(min(static_cast<long long>(kBQ), rows - r0));
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int dp = (D + 3) & ~3;  // the score loop's depth, zero padded

  auto q_row = [&](int i) {
    const long long r = r0 + i;
    const long long qpos = r / G, g = r - qpos * G;
    return q + ((static_cast<size_t>(b) * H + kh * G + g) * Sq + qpos) * D;
  };
  const T* k_base = k + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  const T* v_base = v + (static_cast<size_t>(b) * KH + kh) * Skv * D;

  stage<T, kDMax, kVec>(q_s, Tl::kQS, kBQ, valid_rows, D, scale, q_row);

  int qpos[kRS];
#pragma unroll
  for (int i = 0; i < kRS; ++i) qpos[i] = static_cast<int>((r0 + ty + 8 * i) / G);

  // the last query position of the block bounds the causal kv range
  const int q_last = static_cast<int>((r0 + valid_rows - 1) / G);
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;

  float m[kRS], l[kRS], acc[kRS][kCD];
#pragma unroll
  for (int i = 0; i < kRS; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCD; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int keys = min(kBK, Skv - k0);
    __syncthreads();  // the previous tile's k_s, v_s, p_s are consumed
    stage<T, kDMax, kVec>(k_s, Tl::kKS, kBK, keys, D, 1.f,
                          [&](int i) { return k_base + static_cast<size_t>(k0 + i) * D; });
    stage<T, kDMax, kVec>(v_s, Tl::kVS, kBK, keys, D, 1.f,
                          [&](int i) { return v_base + static_cast<size_t>(k0 + i) * D; });
    __syncthreads();

    // s = q . k^T for rows ty + 8i, keys tx + 16j
    float s[kRS][kCS];
#pragma unroll
    for (int i = 0; i < kRS; ++i)
#pragma unroll
      for (int j = 0; j < kCS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dp; d += 4) {
      float4 kv[kCS];
#pragma unroll
      for (int j = 0; j < kCS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * Tl::kKS + d);
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (ty + 8 * i) * Tl::kQS + d);
#pragma unroll
        for (int j = 0; j < kCS; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

    // mask, online softmax, p to shared memory, rescale the accumulator
#pragma unroll
    for (int i = 0; i < kRS; ++i) {
      float tile_max = neg_inf();
#pragma unroll
      for (int j = 0; j < kCS; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= Skv) {
          s[i][j] = neg_inf();                  // past the keys: no weight
        } else if (causal && key > qpos[i]) {
          s[i][j] = kNegInf;                   // the Pallas body's mask value
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group16_max(tile_max));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kCS; ++j) {
        const float p = p_tile<kPBf16>(expf(s[i][j] - m_new));
        p_s[(ty + 8 * i) * Tl::kPS + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + group16_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += p . v for rows ty + 8i, columns tx + 16c
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kCD];
#pragma unroll
      for (int c = 0; c < kCD; ++c) vv[c] = v_s[kk * Tl::kVS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRS; ++i) {
        const float p = p_s[(ty + 8 * i) * Tl::kPS + kk];
#pragma unroll
        for (int c = 0; c < kCD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRS; ++i) {
    const int li = ty + 8 * i;
    if (li >= valid_rows) continue;
    const long long r = r0 + li;
    const long long qp = r / G, g = r - qp * G;
    T* o = out + ((static_cast<size_t>(b) * H + kh * G + g) * Sq + qp) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCD; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store1(o + col, acc[i][c] / denom);
    }
  }
}

// A kernel's dynamic shared memory, and the whole of the SM's unified
// memory as shared memory, so that as many blocks as fit are resident (left
// to its default, the carveout may hold fewer).
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int kDMax, bool kVec, bool kPBf16>
int launch_bucket(const T* q, const T* k, const T* v, T* out, int B, int H, int KH, int Sq,
                  int Skv, int D, float scale, int causal, cudaStream_t stream) {
  using Tl = Tile<kDMax>;
  static_assert(Tl::kSmem <= kMaxSmem, "tile exceeds shared memory");
  const long long rows = static_cast<long long>(H / KH) * Sq;
  const long long blocks = (rows + Tl::kBQ - 1) / Tl::kBQ;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(flash_kernel<T, kDMax, kVec, kPBf16>, Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B * KH));
  flash_kernel<T, kDMax, kVec, kPBf16><<<grid, kThreads, Tl::kSmem, stream>>>(
      q, k, v, out, H, KH, Sq, Skv, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, bool kPBf16>
int launch_f32(const float* q, const float* k, const float* v, float* out, int B, int H, int KH,
               int Sq, int Skv, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch_bucket<float, 64, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                                  causal, stream);
  if (D <= 128)
    return launch_bucket<float, 128, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                                  causal, stream);
  return launch_bucket<float, 256, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                                  causal, stream);
}

// -- bf16 body: tensor cores, wgmma ---------------------------------------------

constexpr int kTcThreads = 128;   // one warpgroup: warp w owns rows 16w..16w+15
constexpr int kTcBQ = 64;         // rows a block (the m64 of wgmma)
constexpr int kTcBK = 64;         // keys a kv tile: one 128-byte swizzle atom of keys
constexpr int kAtom = 64;         // bf16 values in one 128-byte row of an atom

// Tiles in shared memory, each in 128-byte-swizzled atoms (rows of 64 bf16;
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8)), atoms 1024-byte
// aligned: q (64 rows x kD, kD/64 atoms of 64 rows) and a ring of two K and
// two V tiles (64 keys x kD, the same).
template <int kD>
struct TcTile {
  static constexpr int kQBytes = kTcBQ * kD * 2;
  static constexpr int kKBytes = kTcBK * kD * 2;
  static constexpr int kVBytes = kTcBK * kD * 2;
  static constexpr size_t kSmem = 1024 + kQBytes + 2 * (kKBytes + kVBytes) + 16;  // + 2 mbarriers
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of (row, 16-byte chunk) in a 128-byte-swizzled tile of
// 64-value rows
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma operand descriptor of a 128-byte-swizzled tile at shared address
// `addr`: 1024 bytes between 8-row groups (the stride byte offset).  `lbo`,
// the leading byte offset, is the distance between the 64-value atoms along
// an N-major operand's N; a K-major operand does not use it.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo = 16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (m64 x n64, fp32) += A (m64 x k16, smem desc) . B (k16 x n64, smem desc)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, %32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d (m64 x n64, fp32) += A (m64 x k16, registers) . B (k16 x n64, smem desc,
// N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (m64 x n128, fp32) += A (m64 x k16, registers) . B (k16 x n128, smem desc,
// N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, {%64,%65,%66,%67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (m64 x n256, fp32) += A (m64 x k16, registers) . B (k16 x n256, smem desc,
// N-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const unsigned (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, {%128,%129,%130,%131}, %132, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

template <int kD>
__device__ __forceinline__ void wgmma_rs(float (&d)[kD / 2], const unsigned (&a)[4], uint64_t db) {
  if constexpr (kD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (kD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// 16 bytes global -> shared, zero-filled past `bytes` (0..16)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// -- TMA and mbarriers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// a 3-d box of the tensor map into shared memory, counted on `bar`
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar,
                                         int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// two fp32 values rounded to a bf16 pair (the first in the low half) and
// the pair of what rounding left
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// Stage `n` rows of `width` bf16 values (the tile is kCols values wide, in
// kCols/64 atoms of n rows) whose global address row(i) gives; rows past
// `valid` and columns past `width` are zero.  kVec: 16-byte cp.async
// (width % 8 == 0, rows 16-byte aligned), else ordinary loads.
template <int kCols, bool kVec, typename RowFn>
__device__ __forceinline__ void stage_swz(char* tile, int n, int valid, int width, RowFn row) {
  constexpr int kChunks = kCols / 8;
  const int atom_bytes = n * 128;
  for (int e = threadIdx.x; e < n * kChunks; e += kTcThreads) {
    const int i = e / kChunks, c = e - i * kChunks;
    char* dst = tile + (c / 8) * atom_bytes + swz(i, c % 8);
    const int col = c * 8;
    if constexpr (kVec) {
      const bool ok = i < valid && col < width;
      cp_async16(smem_u32(dst), ok ? row(i) + col : row(0), ok ? 16 : 0);
    } else {
      bf16 v[8];
#pragma unroll
      for (int x = 0; x < 8; ++x)
        v[x] = (i < valid && col + x < width) ? row(i)[col + x] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

template <int kD, bool kVec, bool kPBf16>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int H, int KH, int Sq,
                int Skv, int D, float scale, int causal,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map) {
  using Tl = TcTile<kD>;
  constexpr int kNS = kTcBK / 8;    // score n8 chunks a thread holds
  constexpr int kNO = kD / 8;       // output n8 chunks a thread holds
  // output columns a P.V register tile covers (the D 256 bucket in four, to
  // keep o and the tile in registers)
  constexpr int kPN = kD <= 128 ? kD : 64;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~static_cast<uintptr_t>(1023));
  char* q_s = base;
  char* k_s = q_s + Tl::kQBytes;                 // [2][kKBytes]
  char* v_s = k_s + 2 * Tl::kKBytes;             // [2][kVBytes]
  const unsigned bar0 = smem_u32(v_s + 2 * Tl::kVBytes);   // [2] mbarriers (kVec)

  const int G = H / KH;
  const int b = blockIdx.y / KH, kh = blockIdx.y - b * KH;
  const long long rows = static_cast<long long>(G) * Sq;
  // the last row blocks see the most keys under the causal mask: start them first
  const long long r0 = static_cast<long long>(gridDim.x - 1 - blockIdx.x) * kTcBQ;
  const int valid_rows = static_cast<int>(min(static_cast<long long>(kTcBQ), rows - r0));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;

  auto q_row = [&](int i) {
    const long long r = r0 + i;
    const long long qpos = r / G, gm = r - qpos * G;
    return q + ((static_cast<size_t>(b) * H + kh * G + gm) * Sq + qpos) * D;
  };
  const bf16* k_base = k + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  const bf16* v_base = v + (static_cast<size_t>(b) * KH + kh) * Skv * D;
  // kVec: thread 0 loads a K and a V tile (kD/64 boxes of 64 keys x 64 d
  // each) by TMA, counted on the stage's mbarrier; the boxes come swizzled,
  // and zero past the head's Skv and past D.  Otherwise every thread loads
  // them with ordinary loads.
  auto load_kv = [&](int stage, int k0) {
    if constexpr (kVec) {
      if (tid == 0) {
        const unsigned bar = bar0 + 8 * stage;
        mbar_expect(bar, Tl::kKBytes + Tl::kVBytes);
#pragma unroll
        for (int a = 0; a < kD / kAtom; ++a) {
          const int off = stage * Tl::kKBytes + a * kTcBK * 128;
          tma_load(smem_u32(k_s + off), &k_map, bar, a * kAtom, k0, b * KH + kh);
          tma_load(smem_u32(v_s + off), &v_map, bar, a * kAtom, k0, b * KH + kh);
        }
      }
    } else {
      const int keys = min(kTcBK, Skv - k0);
      stage_swz<kD, false>(k_s + stage * Tl::kKBytes, kTcBK, keys, D,
                           [&](int i) { return k_base + static_cast<size_t>(k0 + i) * D; });
      stage_swz<kD, false>(v_s + stage * Tl::kVBytes, kTcBK, keys, D,
                           [&](int i) { return v_base + static_cast<size_t>(k0 + i) * D; });
      cp_async_commit();
    }
  };

  const int q_last = static_cast<int>((r0 + valid_rows - 1) / G);
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int tiles = (kv_end + kTcBK - 1) / kTcBK;
  if (kVec && tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage_swz<kD, kVec>(q_s, kTcBQ, valid_rows, D, q_row);
  cp_async_commit();
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();              // q is in; the mbarriers are initialised
  if (tiles > 0) load_kv(0, 0);

  // this thread's two rows: warp*16 + g and + 8.  Key j is masked from row
  // r (query position r / G) iff j > r / G, that is iff j*G > r: no division
  // in the loop
  const long long rr0 = r0 + warp * 16 + g, rr1 = rr0 + 8;
  float o[kD / 2];
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) o[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: this lane's share
  const unsigned q_addr = smem_u32(q_s);

  for (int t = 0; t < tiles; ++t) {
    if constexpr (kVec) {
      mbar_wait(bar0 + 8 * (t & 1), (t >> 1) & 1);
    } else {
      cp_async_wait_all();
      fence_async_smem();
    }
    __syncthreads();            // tile t is in; every warp is done with tile t-1
    if (t + 1 < tiles) load_kv((t + 1) & 1, (t + 1) * kTcBK);
    const unsigned k_addr = smem_u32(k_s + (t & 1) * Tl::kKBytes);
    const unsigned v_addr = smem_u32(v_s + (t & 1) * Tl::kVBytes);
    const int k0 = t * kTcBK;

    // S = q . k^T, fp32: kD/16 steps of k16, 4 to an atom (32 bytes each)
    float s[kNS * 4];
#pragma unroll
    for (int j = 0; j < kNS * 4; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const unsigned off = (kk / 4) * (kTcBQ * 128) + (kk % 4) * 32;
      const unsigned koff = (kk / 4) * (kTcBK * 128) + (kk % 4) * 32;
      wgmma_ss_n64(s, desc(q_addr + off), desc(k_addr + koff));
    }
    wgmma_commit_wait();

    // scale, mask, online softmax.  Tiles wholly inside Skv and below every
    // row's causal diagonal take no mask; the scale folds into the exponent
    // there (the max commutes with a positive scale)
    const bool masked = k0 + kTcBK > Skv || (causal && (k0 + kTcBK - 1) * static_cast<long long>(G) > r0);
    float mx0 = neg_inf(), mx1 = neg_inf();
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * tig + (e & 1);
          float x = s[4 * j + e] * scale;
          if (key >= Skv) {
            x = neg_inf();                        // past the keys: no weight
          } else if (causal && static_cast<long long>(key) * G > (e < 2 ? rr0 : rr1)) {
            x = kNegInf;                          // the Pallas body's mask value
          }
          s[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 *= scale;
      mx1 *= scale;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    const float sc = masked ? 1.f : scale;  // scores still to scale
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      s[4 * j + 0] = p_tile<kPBf16>(expf(fmaf(s[4 * j + 0], sc, -mn0)));
      s[4 * j + 1] = p_tile<kPBf16>(expf(fmaf(s[4 * j + 1], sc, -mn0)));
      s[4 * j + 2] = p_tile<kPBf16>(expf(fmaf(s[4 * j + 2], sc, -mn1)));
      s[4 * j + 3] = p_tile<kPBf16>(expf(fmaf(s[4 * j + 3], sc, -mn1)));
      ps0 += s[4 * j + 0] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
    if (!__all_sync(kFull, c0 == 1.f && c1 == 1.f)) {   // no row's max moved: o stays
#pragma unroll
      for (int j = 0; j < kNO; ++j) {
        o[4 * j + 0] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    }

    // O += (P_hi + P_lo) . V, promoted: this tile's products accumulate from
    // zero in a register tile t of kPN output columns (the tensor cores'
    // accumulation truncates, so it stays within one tile), then t joins o
    // by fp32 adds on the CUDA cores.  The score chunks of keys
    // 16kk..16kk+15 are the register A operand of that k16 step; B is the V
    // tile's two 8-key groups (1024 bytes each) of those keys and the
    // chunk's columns, its d atoms kTcBK * 128 bytes apart
#pragma unroll
    for (int c = 0; c < kD / kPN; ++c) {
      float t[kPN / 2];
#pragma unroll
      for (int j = 0; j < kPN / 2; ++j) t[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        unsigned ph[4], pl[4];
        split2(s[8 * kk + 0], s[8 * kk + 1], ph[0], pl[0]);
        split2(s[8 * kk + 2], s[8 * kk + 3], ph[1], pl[1]);
        split2(s[8 * kk + 4], s[8 * kk + 5], ph[2], pl[2]);
        split2(s[8 * kk + 6], s[8 * kk + 7], ph[3], pl[3]);
        const uint64_t db =
            desc(v_addr + kk * 2048 + c * (kPN / kAtom) * kTcBK * 128, kTcBK * 128);
        wgmma_rs<kPN>(t, ph, db);
        if constexpr (!kPBf16) wgmma_rs<kPN>(t, pl, db);   // P_lo is zero under kPBf16
      }
      wgmma_commit_wait();
#pragma unroll
      for (int j = 0; j < kPN / 2; ++j) o[c * (kPN / 2) + j] += t[j];
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(kFull, l0, off);
    l1 += __shfl_xor_sync(kFull, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int li = warp * 16 + g + 8 * half;
    if (li >= valid_rows) continue;
    const long long r = r0 + li;
    const long long qp = r / G, gm = r - qp * G;
    bf16* orow = out + ((static_cast<size_t>(b) * H + kh * G + gm) * Sq + qp) * D;
    const float denom = fmaxf(half ? l1 : l0, 1e-30f);
#pragma unroll
    for (int j = 0; j < kNO; ++j) {
      const int col = j * 8 + 2 * tig;
      if (col >= D) break;
      const float x = o[4 * j + 2 * half] / denom, y = o[4 * j + 2 * half + 1] / denom;
      if (col + 1 < D && D % 2 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x, y);
      } else {
        orow[col] = __float2bfloat16(x);
        if (col + 1 < D) orow[col + 1] = __float2bfloat16(y);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda (already loaded by the
// runtime) at first use, so the library links without -lcuda
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// a bf16 tensor map of (heads, keys, cols) (row-major, rows 16-byte
// aligned), boxes of 64 keys x 64 values of one head, 128-byte swizzle, zero
// fill past the ends of each dimension
bool make_map(CUtensorMap* map, const void* base, uint64_t heads, uint64_t keys,
              uint64_t cols) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {cols, keys, heads};
  const cuuint64_t strides[2] = {cols * 2, keys * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kAtom), static_cast<cuuint32_t>(kTcBK), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int kD, bool kVec, bool kPBf16>
int launch_tc_bucket(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int H,
                     int KH, int Sq, int Skv, int D, float scale, int causal,
                     cudaStream_t stream) {
  CUtensorMap k_map = {}, v_map = {};
  if (kVec && Skv > 0 &&
      (!make_map(&k_map, k, static_cast<uint64_t>(B) * KH, Skv, D) ||
       !make_map(&v_map, v, static_cast<uint64_t>(B) * KH, Skv, D)))
    return static_cast<int>(cudaErrorInvalidValue);
  using Tl = TcTile<kD>;
  static_assert(Tl::kSmem <= kMaxSmem, "tile exceeds shared memory");
  const long long rows = static_cast<long long>(H / KH) * Sq;
  const long long blocks = (rows + kTcBQ - 1) / kTcBQ;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = set_smem(flash_tc_kernel<kD, kVec, kPBf16>, Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B * KH));
  flash_tc_kernel<kD, kVec, kPBf16><<<grid, kTcThreads, Tl::kSmem, stream>>>(
      q, k, v, out, H, KH, Sq, Skv, D, scale, causal, k_map, v_map);
  return static_cast<int>(cudaGetLastError());
}

template <bool kVec, bool kPBf16>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out, int B, int H, int KH,
                int Sq, int Skv, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch_tc_bucket<64, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                             causal, stream);
  if (D <= 128)
    return launch_tc_bucket<128, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                             causal, stream);
  return launch_tc_bucket<256, kVec, kPBf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale,
                                             causal, stream);
}

// 0: launch; 1: nothing to do; < 0: shapes the kernels do not take
int check(int B, int H, int KH, int Sq, int Skv, int D) {
  if (B < 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq < 0 || Skv < 0 || D <= 0 || D > 256 ||
      static_cast<long long>(B) * KH > 65535)
    return -1;
  return (B == 0 || Sq == 0) ? 1 : 0;
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int KH, int Sq, int Skv, int D, float scale, int causal,
                             int p_bf16, void* stream) {
  const int c = check(B, H, KH, Sq, Skv, D);
  if (c != 0) return c < 0 ? static_cast<int>(cudaErrorInvalidValue)
                           : static_cast<int>(cudaGetLastError());
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  float* ot = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16) {
    if (D % 4 == 0)
      return launch_f32<true, true>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
    return launch_f32<false, true>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
  }
  if (D % 4 == 0)
    return launch_f32<true, false>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
  return launch_f32<false, false>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int KH, int Sq, int Skv, int D, float scale, int causal,
                              int p_bf16, void* stream) {
  const int c = check(B, H, KH, Sq, Skv, D);
  if (c != 0) return c < 0 ? static_cast<int>(cudaErrorInvalidValue)
                           : static_cast<int>(cudaGetLastError());
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* ot = static_cast<bf16*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16) {
    if (D % 8 == 0)
      return launch_bf16<true, true>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
    return launch_bf16<false, true>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
  }
  if (D % 8 == 0)
    return launch_bf16<true, false>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
  return launch_bf16<false, false>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
}
