// The Conformer's relative-position self-attention at inference, fused into
// one kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (asv_subtools_tpu/nn/conformer/attention.py:171-249). It was added
// because the port's unfused chain (nn/conformer/attention.py
// RelPositionMultiHeadedAttention) writes [B, H, T, T] f32 scores and
// passes over them about ten times a layer (casts, the sum, the scale,
// masked_fill and its clone, the softmax, the cast back): at T = 1,596 that
// chain, not its three products, took two thirds of the Conformer's batch.
//
// Per head h of batch row b, with q, k, v the [T, 64] slices of the qkv
// projection, p the [T, 64] slice of the position table's projection (no
// batch stride: the table of positions 0..T-1 is the same for every row)
// and u, v_bias the head's [64] biases:
//   S   = [q+u | q+v_bias] . [k | p]^T        one product of depth 128
//   S   = S / 8, keys masked                   1 / sqrt(64)
//   P   = softmax over the valid keys          f32
//   out = P . v, rows of padded frames zero    [B, T, H * 64]
// which is (q+u) k^T + (q+v_bias) p^T, the module's two score products,
// taken as one. A key is valid where mask[b, key] is set (every key when
// the mask is null). For a valid query row the module's -1e9 entries give
// exp(...) = 0 exactly in f32, so leaving those keys out changes nothing;
// a query row whose frame is padded gets zeros, as the module's second
// masked_fill makes it.
//
// Design (FlashAttention-2's scheme on mma.sync): a block of 4 warps takes
// 64 query rows of one (b, h), a warp 16 of them, and walks every key tile
// of 64 up to T (no tile is skipped for a short row: the roofline metric
// counts the padded T^2 work).
//  - Q. [q+u | q+v_bias] is formed on load in f32 and rounded to the
//    compute type, as the module's bias add rounds it, staged in shared
//    memory once and held as mma A fragments in registers (32 a thread).
//  - K, V. [k | p] [64 keys][128] and v [64 keys][64] come by 16-byte
//    cp.async straight from the qkv projection's [B, T, 3, H, 64] output
//    and the [T, H, 64] table (rows 128 bytes, 16-byte aligned), into a
//    two-stage ring: tile j + 1 is in flight while the tensor cores work on
//    tile j. Keys past T are zero-filled.
//  - Scores and softmax. S [16][64] a warp in f32 registers (mma.sync
//    m16n8k16, f32 sums; B fragments by ldmatrix), scaled by log2(e) / 8,
//    masked from a bit a key (the block's mask row, built once by ballot
//    into shared memory), then the online softmax in base 2 (running max
//    and sum a row, the output rescaled when the max moves; ex2.approx).
//  - P . v. The S accumulators are the A fragments of the second product
//    as they lie: P is rounded to the compute type (as the module's
//    attn.to(v.dtype) rounds it) and multiplied with v (ldmatrix.trans)
//    into f32 accumulators [16][64] a warp. The sum of P stays f32 and
//    divides at the end; the rows are written in the compute type.
//  - Rows padded by 16 bytes in shared memory (ldmatrix without bank
//    conflicts). 70.9 KB of shared memory a block at T = 1,596 and 168
//    registers a thread, no spills: three blocks an SM. Blocks of 8 warps
//    (128 rows, 172 registers, two blocks an SM) read 2.65 against 2.20 ms
//    at [128, 1596] and 0.31 against 0.22 at [128, 396].
//
// Precision against the module: the module rounds (q+u) k^T and
// (q+v_bias) p^T to bf16 each before adding them in f32; here the 128-deep
// sum stays f32. The softmax is f32 in both; the module rounds the
// normalised P to bf16, this kernel the unnormalised one (both in [0, 1]).
//
// Bound on an H100 SXM at the Conformer cell's 32-s bucket, [128, 1596]
// frames, D = 256 (4 heads): the three products a head, 6 B T^2 D = 0.501
// TFLOP, 0.506 ms at 989 TFLOP/s; bytes: q, k, v read once (313.8 MB), the
// table (0.8 MB), the output written once (104.6 MB): 0.125 ms at 3.35
// TB/s. Bound by operations. Measured (H100 SXM, 700 W): 2.20 ms at
// [128, 1596], 228 TFLOP/s, 23% of the bound; 0.22 ms at [128, 396].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBM = 16 * kWarps;  // query rows a block
constexpr int kDh = 64;         // head width of q, k, v and p
constexpr int kDqk = 2 * kDh;   // depth of the score product
constexpr int kBN = 64;         // keys a tile
constexpr int kSQ = kDqk + 8;   // row stride (elements) of the Q and K tiles in shared memory
constexpr int kSV = kDh + 8;    // of the V tiles
constexpr float kScaleLog2 = 1.4426950408889634f / 8.0f;  // log2(e) / sqrt(64)

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 round(float v) { return __float2bfloat16_rn(v); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_bf16(lo, hi); }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_bf16_16816(c, a, b);
  }
};

template <>
struct Ops<__half> {
  static __device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
  static __device__ __forceinline__ __half round(float v) { return __float2half_rn(v); }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) { return pack_f16(lo, hi); }
  static __device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
    mma_f16_16816(c, a, b);
  }
};

// Shared memory of a block at T frames, in bytes: the Q tile [kBM][kSQ] |
// the K ring [2][kBN][kSQ] | the V ring [2][kBN][kSV] | the mask row, one
// bit a key, [2 ceil(T / 64)] words.
size_t smem_bytes(int Tn) {
  const size_t tiles = 2 * (kBM * kSQ + 2 * kBN * (kSQ + kSV));
  return tiles + 4 * 2 * (size_t)((Tn + kBN - 1) / kBN);
}

// grid (ceil(T / kBM), H, B). qkv [B, T, 3, H, 64], pos [T, H, 64],
// bias_u and bias_v [H, 64], mask [B, T] (null: every frame valid), out
// [B, T, H, 64]; all contiguous.
template <typename T>
__global__ void __launch_bounds__(kThreads) rel_attention_kernel(
    const T* __restrict__ qkv, const T* __restrict__ pos, const T* __restrict__ bias_u,
    const T* __restrict__ bias_v, const uint8_t* __restrict__ mask, T* __restrict__ out, int Tn,
    int H) {
  typedef Ops<T> O;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);
  T* k_s = q_s + kBM * kSQ;
  T* v_s = k_s + 2 * kBN * kSQ;
  uint32_t* m_s = reinterpret_cast<uint32_t*>(v_s + 2 * kBN * kSV);
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  // ldmatrix: the row and column of the lane's address, for A fragments
  // and for the transposed B fragments of v (rows 0-7 | 8-15, then cols + 8)
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;
  // ... and for the B fragments of [k | p] (keys 0-7 at depth 0-7 | 8-15, then keys 8-15)
  const int krow = (lane & 7) + (lane >> 4) * 8, kcol = ((lane >> 3) & 1) * 8;
  const int D = H * kDh;
  const size_t row3 = 3 * (size_t)D;  // elements from one frame of qkv to the next
  const T* qb = qkv + (size_t)b * Tn * row3 + h * kDh;
  const T* kb = qb + D;
  const T* vb = qb + 2 * D;
  const T* pb = pos + h * kDh;
  const int nK = (Tn + kBN - 1) / kBN;

  // the mask row, one bit a frame, zero past T
  for (int w = warp; w < 2 * nK; w += kWarps) {
    const int t = w * 32 + lane;
    const bool ok = t < Tn && (mask == nullptr || mask[(size_t)b * Tn + t] != 0);
    const uint32_t bits = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) m_s[w] = bits;
  }

  // key tile j into its stage: 16 copies of 16 bytes a key for [k | p], 8 for v
  auto load_kv = [&](int j) {
    const int s0 = j * kBN;
    T* ks = k_s + (j & 1) * kBN * kSQ;
    T* vs = v_s + (j & 1) * kBN * kSV;
    for (int i = tid; i < kBN * 16; i += kThreads) {
      const int r = i >> 4, c = i & 15, t = s0 + r;
      const bool ok = t < Tn;
      const int tt = ok ? t : 0;
      const T* src = c < 8 ? kb + (size_t)tt * row3 + 8 * c : pb + (size_t)tt * D + 8 * (c - 8);
      cp_async16_zfill(smem_u32(ks + r * kSQ + 8 * c), src, ok ? 16u : 0u);
    }
    for (int i = tid; i < kBN * 8; i += kThreads) {
      const int r = i >> 3, c = i & 7, t = s0 + r;
      const bool ok = t < Tn;
      cp_async16_zfill(smem_u32(vs + r * kSV + 8 * c), vb + (size_t)(ok ? t : 0) * row3 + 8 * c,
                       ok ? 16u : 0u);
    }
    cp_async_commit();
  };
  load_kv(0);

  // [q+u | q+v_bias], rounded to T, zero past T
  for (int i = tid; i < kBM * 8; i += kThreads) {
    const int r = i >> 3, c = i & 7, t = t0 + r;
    __align__(16) T qu[8];
    __align__(16) T qv[8];
    if (t < Tn) {
      const uint4 rq = *reinterpret_cast<const uint4*>(qb + (size_t)t * row3 + 8 * c);
      const uint4 ru = *reinterpret_cast<const uint4*>(bias_u + h * kDh + 8 * c);
      const uint4 rv = *reinterpret_cast<const uint4*>(bias_v + h * kDh + 8 * c);
      const T* q8 = reinterpret_cast<const T*>(&rq);
      const T* u8 = reinterpret_cast<const T*>(&ru);
      const T* v8 = reinterpret_cast<const T*>(&rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float qf = O::to_f32(q8[e]);
        qu[e] = O::round(qf + O::to_f32(u8[e]));
        qv[e] = O::round(qf + O::to_f32(v8[e]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qu[e] = qv[e] = O::round(0.f);
    }
    *reinterpret_cast<uint4*>(q_s + r * kSQ + 8 * c) = *reinterpret_cast<const uint4*>(qu);
    *reinterpret_cast<uint4*>(q_s + r * kSQ + kDh + 8 * c) = *reinterpret_cast<const uint4*>(qv);
  }
  __syncthreads();
  uint32_t qf[kDqk / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDqk / 16; ++kk)
    ldmatrix_x4(qf[kk], smem_u32(q_s + (warp * 16 + lrow) * kSQ + 16 * kk + lcol));

  float o[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8 (base 2)
  float l_run[2] = {0.f, 0.f};              // this thread's part of their sums

  for (int j = 0; j < nK; ++j) {
    if (j + 1 < nK) {
      load_kv(j + 1);
    } else {
      cp_async_commit();  // an empty group keeps the count of groups in flight
    }
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = k_s + (j & 1) * kBN * kSQ;
    const T* vs = v_s + (j & 1) * kBN * kSV;

    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDqk / 16; ++kk) {
#pragma unroll
      for (int jn = 0; jn < kBN / 16; ++jn) {
        uint32_t r[4];
        ldmatrix_x4(r, smem_u32(ks + (16 * jn + krow) * kSQ + 16 * kk + kcol));
        O::mma(s[2 * jn], qf[kk], r);
        O::mma(s[2 * jn + 1], qf[kk], r + 2);
      }
    }

    // scale, mask, the running max
    const uint32_t w0 = m_s[2 * j], w1 = m_s[2 * j + 1];
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      const uint32_t word = n < 4 ? w0 : w1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (n & 3) * 8 + 2 * tg + (e & 1);
        const float v = (word >> col) & 1u ? s[n][e] * kScaleLog2 : -INFINITY;
        s[n][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with no valid key yet
      const float alpha = exp2_approx(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(s[n][e] - m_use[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }

    // P . v: the score accumulators of keys 16 kk .. + 15 are the A fragments
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t a[4];
      a[0] = O::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = O::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = O::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = O::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < kDh / 16; ++jd) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_u32(vs + (16 * kk + lrow) * kSV + 16 * jd + lcol));
        O::mma(o[2 * jd], a, r);
        O::mma(o[2 * jd + 1], a, r + 2);
      }
    }
    __syncthreads();  // the stage is refilled by the next iteration's copies
  }

  // the rows' sums, then the normalised rows; a padded frame's row is zero
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + warp * 16 + g + 8 * r;
    if (t >= Tn) continue;
    const bool valid = (m_s[t >> 5] >> (t & 31)) & 1u;
    const float inv = valid && l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    T* orow = out + ((size_t)b * Tn + t) * D + h * kDh;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n + 2 * tg) = O::pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <typename T>
int launch(const void* qkv, const void* pos, const void* bias_u, const void* bias_v,
           const void* mask, void* out, int B, int Tn, int H, cudaStream_t st) {
  const size_t smem = smem_bytes(Tn);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rel_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + kBM - 1) / kBM, H, B);
  rel_attention_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(pos), static_cast<const T*>(bias_u),
      static_cast<const T*>(bias_v), static_cast<const uint8_t*>(mask), static_cast<T*>(out), Tn, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [B, T, 3, H, 64] (the fused q, k, v projection's output), pos [T, H,
// 64] (the position table's projection), bias_u and bias_v [H, 64], all
// in one type (bf16 when half == 0, else fp16), contiguous, 16-byte
// aligned; mask [B, T] uint8 or null; out [B, T, H * 64] in that type.
// Returns the first CUDA error, or 0.
int asv_rel_attention_launch(const void* qkv, const void* pos, const void* bias_u,
                             const void* bias_v, const void* mask, void* out, int B, int T, int H,
                             int half, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || T < 1 || H < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  if (half) return launch<__half>(qkv, pos, bias_u, bias_v, mask, out, B, T, H, st);
  return launch<__nv_bfloat16>(qkv, pos, bias_u, bias_v, mask, out, B, T, H, st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
