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
// 0.11 GB fp32) would take 0.03 ms.  This first version computes in fp32 on
// the CUDA cores in both types, as the Pallas body does (wgmma and TMA are
// later work), so its floor in bf16 is the fp32 rate, 15x the tensor-core
// bound.
//
// Design (first version: simple and right; speed is later work):
// * One block of 128 threads per (b*KH + kh, tile of kBQ rows).  The rows
//   are the (query position, group member) pairs of one kv head, query
//   position major: row r is query position r / G of head kh*G + r % G.  So
//   every K/V tile a block stages serves all G = H/KH query heads of its kv
//   head at once (granite-34b's G = 48 included), and the TPU's _tile_groups
//   fold is not needed.
// * Shared memory holds the block's q rows (widened and scaled once), one
//   tile of kBK = 32 keys and values, and the probability tile p; rows are
//   padded to a multiple of 4 floats plus 4, so the score loop reads float4
//   from shared memory without bank conflicts.  D is padded with zeros to
//   the block's D bucket (64, 128 or 256), so any D up to 256 runs one body.
// * Thread (ty, tx) of the 8 x 16 grid owns rows ty + 8i of the block: their
//   score columns tx + 16j of each tile and their output columns tx + 16c in
//   registers (64 fp32 accumulators a thread at D 128).  A row's 16 owners
//   are 16 lanes of one warp, so a row max or sum is four __shfl_xor_sync.
// * Global loads: 16 bytes (4 fp32) or 8 bytes (4 bf16, widened by moving
//   the bits into a float's high half: exact) a thread when D % 4 == 0,
//   scalar loads otherwise.
// * expf, not __expf: the accurate exponential the Pallas body uses.
//
// Plain C interface for ctypes: each entry point launches on the given
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for shapes it
// does not take.  Offsets are 64-bit (size_t).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;       // 8 row groups x 16 column lanes
constexpr int kBK = 32;             // keys per kv tile
constexpr float kNegInf = -1e30f;   // repro's NEG_INF
constexpr size_t kMaxSmem = 232448; // 227 KB a block
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// -- loads widened to fp32, stores rounded once -------------------------------

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}

__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
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

template <typename T, int kDMax, bool kVec>
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
        const float p = expf(s[i][j] - m_new);
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

template <typename T, int kDMax, bool kVec>
int launch_bucket(const T* q, const T* k, const T* v, T* out, int B, int H, int KH, int Sq,
                  int Skv, int D, float scale, int causal, cudaStream_t stream) {
  using Tl = Tile<kDMax>;
  static_assert(Tl::kSmem <= kMaxSmem, "tile exceeds shared memory");
  const long long rows = static_cast<long long>(H / KH) * Sq;
  const long long blocks = (rows + Tl::kBQ - 1) / Tl::kBQ;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (Tl::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, kDMax, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tl::kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B * KH));
  flash_kernel<T, kDMax, kVec><<<grid, kThreads, Tl::kSmem, stream>>>(
      q, k, v, out, H, KH, Sq, Skv, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec>
int launch_d(const T* q, const T* k, const T* v, T* out, int B, int H, int KH, int Sq,
             int Skv, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 64)
    return launch_bucket<T, 64, kVec>(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal, stream);
  if (D <= 128)
    return launch_bucket<T, 128, kVec>(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal,
                                       stream);
  return launch_bucket<T, 256, kVec>(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KH,
           int Sq, int Skv, int D, float scale, int causal, void* stream) {
  if (B < 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq < 0 || Skv < 0 || D <= 0 || D > 256 ||
      static_cast<long long>(B) * KH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D % 4 == 0)
    return launch_d<T, true>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
  return launch_d<T, false>(qt, kt, vt, ot, B, H, KH, Sq, Skv, D, scale, causal, st);
}

}  // namespace

extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, int B,
                             int H, int KH, int Sq, int Skv, int D, float scale, int causal,
                             void* stream) {
  return launch<float>(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal, stream);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, int B,
                              int H, int KH, int Sq, int Skv, int D, float scale, int causal,
                              void* stream) {
  return launch<bf16>(q, k, v, out, B, H, KH, Sq, Skv, D, scale, causal, stream);
}
