// ECAPA channel-wise attentive statistics pooling at inference, for Hopper
// (sm_90a).
//
// Replaces: asv_subtools_tpu/nn/pallas_att_pooling.py
// `fused_attentive_stats_pool` (pallas_call at :177, body `_kernel` :43).
// x [B, T, C] -> [mean_w ; std_w] [B, 2C] f32, where
//   mean, std = masked global mean and unbiased std (+1e-5) over T
//   u = x@Wx + (mean@Wm + std@Ws + b1);  h = tanh(relu(u)*bn_s + bn_t)
//   a = h@W2 + b2;  alpha = softmax over valid t, per channel
//   mean_w = sum alpha x;  std_w = sqrt(max(sum alpha x^2 - mean_w^2, 1e-5))
//
// Design. The TPU kernel carries its sums in scratch across a sequential
// grid (B, 2 phases, T tiles). Hopper's blocks run in parallel, so the
// work is four launches:
//   1. stats:   per (b, 128 channels), masked sum x and x^2 over T ->
//               mean, std; a warp reads two channels' rows at a time as
//               16-byte vectors (a scalar head up to the first 16-byte
//               boundary, then the vectors, then a scalar tail), the mask
//               row cached in shared memory: one coalesced streaming pass.
//   2. glob:    glob = mean@Wm + std@Ws + b1 (the small product the TPU
//               kernel does in its body, :89-94), per 4 batch rows, 128
//               units and a quarter of the channels, as four partial sums
//               that the attend kernels add: the weights are read B/4
//               times, not B times.
//   3. attend:  per (b, 64 frames): u = x@Wx, h = tanh(relu(u + glob) *
//               bn_s + bn_t) rounded to the weights' type (as :107 does),
//               a = h@W2 + b2, and the softmax partials of the tile (max,
//               sum e, sum e x, sum e x^2) per channel, e = exp(a - max).
//   4. combine: per (b, channel), rescale the tiles' partials to the common
//               max and write mean_w, std_w.
// The softmax uses a true running max: the TPU kernel clamps the logits at
// 80 instead (:111-116); both agree wherever the logits stay below 80. A
// tile with no valid frame has max -inf and contributes nothing; a row
// with no valid frame gives mean_w 0 and std_w sqrt(1e-5), as the TPU
// kernel does. Products of bf16 values are exact in f32 and all sums are
// f32.
//
// Two attend kernels; the launcher chooses by type (launch_plan.h att_plan):
//
// attend_mma_kernel serves bf16 x, on the tensor cores (mma.sync.m16n8k16,
// bf16 operands, f32 sums; fragments by ldmatrix). What it answers to:
//  - Orientation. x lies [B, C, T], time contiguous. The first product runs
//    as u^T [K, 64 frames] = Wx^T [K, C] . x^T, the reduction over C: the
//    x chunk [64 channels][64 frames] is the B operand as it lies
//    (ldmatrix.trans), Wx^T the A operand. 8 warps as 4 (units) x 2
//    (frames). h^T [K][64 frames] stays in shared memory and is the B
//    operand of the second product a^T [C, 64] = W2^T [C, K] . h^T, taken
//    128 channels at a time, a warp 16 channels x all 64 frames: each
//    channel's 64 logits sit in one quad of lanes, so the softmax partials
//    are a row reduction in registers and two shuffles.
//  - Copies. The x chunks and the weight chunks (Wx^T and W2^T, prepared
//    by the launcher zero-padded to whole chunks, 16 KB and 32 KB each)
//    stream from device memory and L2 through a two-stage ring by cp.async,
//    the next chunk in flight while the tensor cores work on this one. Not
//    by cp.async.bulk or TMA: at the served T = 998 a channel's row starts
//    1996 bytes after the last, not on the 16 bytes both require, so x
//    comes in 4-byte pieces (2-byte loads when T is odd).
//  - x for sum e x is read again, not held: each lane loads the pairs of
//    frames its accumulator fragment holds, issued before the products
//    (the tile's x, 196 KB, does not fit beside the rest; 132 SMs x 2
//    blocks touch about 50 MB of such tiles at once, the size of L2).
//  - The softmax runs in base 2 (logits times log2 e, ex2.approx), the
//    frames' validity held as bits in a register, two chains of sums.
//  - Rows padded by 16 bytes in shared memory (ldmatrix without bank
//    conflicts). 88 KB of shared memory a block and 127 registers a
//    thread: two blocks an SM, one block's copies and barriers under the
//    other's products. One block an SM, with 4 ring stages or 128-frame
//    tiles, measured slower.
//  - K up to 128 runs 128 units (zero weights past K), up to 256 runs 256
//    (one block an SM then).
// What bounds it now (variants with one statement switched off, on an
// H100): the second product and its softmax take half the kernel, the
// softmax alone about 0.2 ms of 0.72; the waits on x chunks about 0.1 ms;
// removing either product's mma instructions saves little. Work for later:
// overlap a chunk's softmax with the next chunk's products, wgmma.
// attend_kernel serves f32 x on the CUDA cores, where the products must
// stay true f32 (no TF32) to hold 2e-4: per (b, 64 frames), u = x@Wx with
// x and Wx streamed through shared memory in 32-channel chunks (8 frames x
// K/32 units a thread), h in shared memory, then one thread a channel
// computes a over the 64 frames in registers and the partials.
//
// Data layout: x is [B, C, T] in memory (time contiguous), the layout the
// port's model produces, so the model hands it over without a transpose.
//
// Bound on an H100 SXM at x [128, 998, 1536] bf16, K=128: x must be read
// once, 392.4 MB -> 117 us at 3.35 TB/s; the two products are
// 2*2*127,744*1536*128 = 100.5 GFLOP -> 102 us at 989 TFLOP/s. This design
// reads x twice from device memory (the statistics pass, then the first
// product) and a third time from L2: its own floor is 2 x 392.4 MB, 234 us.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_plan.h"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTT = asv_plan::kAttTT;
constexpr int kCC = 32;  // channels per shared-memory chunk in attend
constexpr int kStatsChannels = 128;  // channels per stats block: 8 warps x 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float mask_at(const uint8_t* mask, int b, int t, int Tn) {
  return mask == nullptr ? 1.f : (mask[(size_t)b * Tn + t] != 0 ? 1.f : 0.f);
}

constexpr int kStatsRows = 2;  // channels a warp reads together
constexpr int kMaskWords = 1024;  // the mask row cached in shared memory up to 4088 frames

// stats [B, 2, C]: row 0 mean, row 1 std (unbiased, +1e-5). A block takes
// 128 channels of one batch row, a warp 16 of them, 2 at a time: their
// rows read together as 16-byte vectors, between a scalar head (up to the
// row's first 16-byte boundary) and a scalar tail.
template <typename T>
__global__ void __launch_bounds__(kThreads) att_stats_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ stats,
    int C, int Tn) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  __shared__ uint32_t m_s[kMaskWords];  // mask bytes of row b, zero past T
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cached = mask != nullptr && Tn + 8 <= 4 * kMaskWords;
  if (cached) {
    const uint8_t* mr = mask + (size_t)b * Tn;
    for (int i = tid; i < kMaskWords; i += kThreads) {
      uint32_t w = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * i + q < Tn && mr[4 * i + q] != 0) w |= 1u << (8 * q);
      m_s[i] = w;
    }
  }
  float local = 0.f;
  for (int t = tid; t < Tn; t += kThreads) local += mask_at(mask, b, t, Tn);
  local = warp_sum(local);
  if (lane == 0) red[warp] = local;
  __syncthreads();
  float cnt = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) cnt += red[i];
  cnt = fmaxf(cnt, 1.f);

  // the mask of frames t .. t + 7, a byte each (nonzero = valid)
  auto mask8 = [&](int t) -> uint2 {
    if (mask == nullptr) return make_uint2(0x01010101u, 0x01010101u);
    if (cached) {
      const int w = t >> 2, sh = 8 * (t & 3);
      const uint32_t w0 = m_s[w], w1 = m_s[w + 1], w2 = m_s[w + 2];
      return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
    }
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo |= (uint32_t)(t + q < Tn && mask[(size_t)b * Tn + t + q] != 0) << (8 * q);
      hi |= (uint32_t)(t + 4 + q < Tn && mask[(size_t)b * Tn + t + 4 + q] != 0) << (8 * q);
    }
    return make_uint2(lo, hi);
  };

  constexpr int kWarpRows = kStatsChannels / (kThreads / 32);
  for (int grp = 0; grp < kWarpRows; grp += kStatsRows) {
    const int c0 = blockIdx.x * kStatsChannels + warp * kWarpRows + grp;
    if (c0 >= C) break;
    const T* rows[kStatsRows];
    int head[kStatsRows], n_vec[kStatsRows];
    float s1[kStatsRows], s2[kStatsRows];
    int n_max = 0;
#pragma unroll
    for (int r = 0; r < kStatsRows; ++r) {
      const int c = min(c0 + r, C - 1);  // rows past C are read and not written
      rows[r] = x + ((size_t)b * C + c) * Tn;
      const int mis = (int)((reinterpret_cast<uintptr_t>(rows[r]) & 15) / sizeof(T));
      head[r] = min(mis == 0 ? 0 : V - mis, Tn);
      n_vec[r] = (Tn - head[r]) / V;
      n_max = max(n_max, n_vec[r]);
      s1[r] = 0.f;
      s2[r] = 0.f;
      // the head and the tail (fewer than V frames each) by scalar loads
      const int tail = head[r] + n_vec[r] * V;
      const int t = lane < head[r] ? lane : tail + lane - head[r];
      if (t < Tn && (lane < head[r] || lane - head[r] < V)) {
        const float v = to_f32(rows[r][t]), vm = v * mask_at(mask, b, t, Tn);
        s1[r] += vm;
        s2[r] += vm * v;
      }
    }
    for (int i = lane; i < n_max; i += 32) {
#pragma unroll
      for (int r = 0; r < kStatsRows; ++r) {
        if (i < n_vec[r]) {
          const int t0 = head[r] + i * V;
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(rows[r] + t0));
          const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
          for (int h = 0; h < V; h += 8) {
            const uint2 mv = mask8(t0 + h);
#pragma unroll
            for (int q = 0; q < 8 && h + q < V; ++q) {
              const uint32_t byte = ((q < 4 ? mv.x : mv.y) >> (8 * (q & 3))) & 0xffu;
              const float v = to_f32(e[h + q]), vm = byte ? v : 0.f;
              s1[r] += vm;
              s2[r] += vm * v;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kStatsRows; ++r) {
      const float a1 = warp_sum(s1[r]), a2 = warp_sum(s2[r]);
      if (lane == 0 && c0 + r < C) {
        const float mean = a1 / cnt;
        const float var = (a2 - cnt * mean * mean) / fmaxf(cnt - 1.f, 1.f);
        stats[(size_t)b * 2 * C + c0 + r] = mean;
        stats[(size_t)b * 2 * C + C + c0 + r] = sqrtf(fmaxf(var, 0.f) + 1e-5f);
      }
    }
  }
}

constexpr int kGlobRows = 4;      // batch rows a glob block takes
constexpr int kGlobChunk = 256;   // channels of the statistics staged at a time
constexpr int kGlobThreads = 512; // 128 units x 4 channel groups
constexpr int kGlobSplit = asv_plan::kAttGlobSplit;  // blocks that share a unit's channels: glob's partial sums

// glob[b][k] as the attend kernels read it: the sum of the partial sums
__device__ __forceinline__ float glob_at(const float* glob, int b, int k, int B, int K) {
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < kGlobSplit; ++i) v += glob[((size_t)i * B + b) * K + k];
  return v;
}

// glob [kGlobSplit, B, K]: partial sums of mean@Wm + std@Ws + b1. grid
// (ceil(B / 4), ceil(K / 128), kGlobSplit): block z takes every
// kGlobSplit-th chunk of channels; a thread one unit and every fourth
// channel of a chunk, for four batch rows.
template <typename T>
__global__ void __launch_bounds__(kGlobThreads) glob_kernel(
    const float* __restrict__ stats, const T* __restrict__ wm, const T* __restrict__ ws,
    const float* __restrict__ b1, float* __restrict__ glob, int B, int C, int K) {
  __shared__ float st[kGlobRows][2][kGlobChunk];
  __shared__ float red[4][kGlobRows][128];
  const int b0 = blockIdx.x * kGlobRows;
  const int tid = threadIdx.x, q = tid >> 7;
  const int k = blockIdx.y * 128 + (tid & 127);
  float acc[kGlobRows];
#pragma unroll
  for (int r = 0; r < kGlobRows; ++r) acc[r] = 0.f;
  for (int c0 = blockIdx.z * kGlobChunk; c0 < C; c0 += kGlobSplit * kGlobChunk) {
    __syncthreads();
    for (int i = tid; i < kGlobRows * 2 * kGlobChunk; i += kGlobThreads) {
      const int r = i / (2 * kGlobChunk), which = (i / kGlobChunk) & 1, cc = i % kGlobChunk;
      const int b = b0 + r, c = c0 + cc;
      st[r][which][cc] = (b < B && c < C) ? stats[((size_t)b * 2 + which) * C + c] : 0.f;
    }
    __syncthreads();
    const int cn = min(kGlobChunk, C - c0);
    if (k < K) {
#pragma unroll 4
      for (int cc = q; cc < cn; cc += 4) {
        const float wmv = to_f32(wm[(size_t)(c0 + cc) * K + k]);
        const float wsv = to_f32(ws[(size_t)(c0 + cc) * K + k]);
#pragma unroll
        for (int r = 0; r < kGlobRows; ++r) acc[r] = fmaf(st[r][0][cc], wmv, fmaf(st[r][1][cc], wsv, acc[r]));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kGlobRows; ++r) red[q][r][tid & 127] = acc[r];
  __syncthreads();
  if (q == 0 && k < K) {
#pragma unroll
    for (int r = 0; r < kGlobRows; ++r) {
      const int b = b0 + r;
      if (b < B)
        glob[((size_t)blockIdx.z * B + b) * K + k] = red[0][r][tid] + red[1][r][tid] + red[2][r][tid] +
                                                     red[3][r][tid] + (blockIdx.z == 0 ? b1[k] : 0.f);
    }
  }
}

// part [B, n_tiles, 4, C]: per tile and channel (max a, sum e, sum e x, sum e x^2)
template <typename T, int TK>
__global__ void __launch_bounds__(kThreads) attend_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, const T* __restrict__ wx,
    const float* __restrict__ glob, const float* __restrict__ bns,
    const float* __restrict__ bnt, const T* __restrict__ w2, const float* __restrict__ b2,
    float* __restrict__ part, int C, int Tn, int K) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                // [kCC][kTT]
  float* wx_s = x_s + kCC * kTT;    // [kCC][K]
  float* h_s = wx_s + kCC * K;      // [K][kTT], h transposed
  float* m_s = h_s + K * kTT;       // [kTT]
  const int b = blockIdx.y, tile = blockIdx.x, t0 = tile * kTT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xb = x + (size_t)b * C * Tn;

  for (int i = tid; i < kTT; i += kThreads) {
    const int t = t0 + i;
    m_s[i] = t < Tn ? mask_at(mask, b, t, Tn) : 0.f;
  }

  // u = x@Wx: this thread owns frames warp*8..+7 and units lane + 32*j
  float acc[8][TK];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TK; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();
    for (int i = tid; i < kCC * kTT; i += kThreads) {
      const int cc = i / kTT, tt = i - cc * kTT;
      const int c = c0 + cc, t = t0 + tt;
      x_s[i] = (c < C && t < Tn) ? to_f32(xb[(size_t)c * Tn + t]) : 0.f;
    }
    for (int i = tid; i < kCC * K; i += kThreads) {
      const int cc = i / K, k = i - cc * K;
      const int c = c0 + cc;
      wx_s[i] = c < C ? to_f32(wx[(size_t)c * K + k]) : 0.f;
    }
    __syncthreads();
    const int cn = min(kCC, C - c0);
#pragma unroll 4
    for (int cc = 0; cc < cn; ++cc) {
      const float4 x0 = *reinterpret_cast<const float4*>(x_s + cc * kTT + warp * 8);
      const float4 x1 = *reinterpret_cast<const float4*>(x_s + cc * kTT + warp * 8 + 4);
      const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const int k = lane + 32 * j;
        const float wv = k < K ? wx_s[cc * K + k] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(xv[i], wv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < TK; ++j) {
    const int k = lane + 32 * j;
    if (k < K) {
      const float g = glob_at(glob, b, k, gridDim.y, K), s = bns[k], sh = bnt[k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float h = tanhf(fmaxf(acc[i][j] + g, 0.f) * s + sh);
        h_s[k * kTT + warp * 8 + i] = round_to<T>(h);
      }
    }
  }
  __syncthreads();

  // a = h@W2 + b2 and the softmax partials: one thread per channel
  const int n_tiles = gridDim.x;
  for (int c = tid; c < C; c += kThreads) {
    float a[kTT];
#pragma unroll
    for (int t = 0; t < kTT; ++t) a[t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float w = to_f32(w2[(size_t)k * C + c]);
      const float4* hr = reinterpret_cast<const float4*>(h_s + k * kTT);
#pragma unroll
      for (int q = 0; q < kTT / 4; ++q) {
        const float4 h4 = hr[q];
        a[4 * q] = fmaf(h4.x, w, a[4 * q]);
        a[4 * q + 1] = fmaf(h4.y, w, a[4 * q + 1]);
        a[4 * q + 2] = fmaf(h4.z, w, a[4 * q + 2]);
        a[4 * q + 3] = fmaf(h4.w, w, a[4 * q + 3]);
      }
    }
    const float bias = b2[c];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kTT; ++t) {
      a[t] += bias;
      if (m_s[t] != 0.f) mx = fmaxf(mx, a[t]);
    }
    float s = 0.f, s1 = 0.f, s2 = 0.f;
    if (mx != -INFINITY) {
      const T* xr = xb + (size_t)c * Tn + t0;
#pragma unroll
      for (int t = 0; t < kTT; ++t) {
        if (m_s[t] != 0.f) {
          const float e = expf(a[t] - mx);
          const float xv = to_f32(xr[t]);
          const float ex = e * xv;
          s += e;
          s1 += ex;
          s2 += ex * xv;
        }
      }
    }
    float* p = part + ((size_t)b * n_tiles + tile) * 4 * C + c;
    p[0] = mx;
    p[C] = s;
    p[2 * C] = s1;
    p[3 * C] = s2;
  }
}

// out [B, 2C] f32 = [mean_w ; std_w]
__global__ void combine_kernel(const float* __restrict__ part, float* __restrict__ out,
                               int C, int n_tiles) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p = part + (size_t)b * n_tiles * 4 * C + c;
  float mx = -INFINITY;
  for (int j = 0; j < n_tiles; ++j) mx = fmaxf(mx, p[(size_t)j * 4 * C]);
  float s = 0.f, n1 = 0.f, n2 = 0.f;
  if (mx != -INFINITY) {
    for (int j = 0; j < n_tiles; ++j) {
      const float* q = p + (size_t)j * 4 * C;
      if (q[0] == -INFINITY) continue;
      const float r = expf(q[0] - mx);
      s += r * q[C];
      n1 += r * q[2 * C];
      n2 += r * q[3 * C];
    }
  }
  s = fmaxf(s, 1e-30f);
  const float mean = n1 / s;
  const float var = n2 / s - mean * mean;
  out[(size_t)b * 2 * C + c] = mean;
  out[(size_t)b * 2 * C + C + c] = sqrtf(fmaxf(var, 1e-5f));
}

// ---------------------------------------------------------------------------
// bf16 x on the tensor cores

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

constexpr int kCA = asv_plan::kAttCA;  // channels a chunk of the first product
constexpr int kCB = asv_plan::kAttCB;  // channels a chunk of the second product
static_assert(kCB == 8 * 16, "a warp takes 16 channels of the second product");

// Shared memory of attend_mma_kernel for K padded to KP units and tiles of
// TT frames, in bytes: the ring of kStages stages (each an x chunk
// [64][TT + 8] + a Wx^T chunk [KP][72], or a W2^T chunk [128][KP + 8]) |
// h^T [KP][TT + 8] | the tile's mask [TT] f32.
template <int KP, int TT>
struct MmaPlan {
  static constexpr int kStages = 2;
  static constexpr int kBlocksPerSM = KP == 128 ? 2 : 1;
  static constexpr int SX = TT + 8;    // row stride (bf16) of x chunks and h^T
  static constexpr int SWA = kCA + 8;  // of Wx^T chunks
  static constexpr int SWB = KP + 8;   // of W2^T chunks
  static constexpr int kStageA = 2 * (kCA * SX + KP * SWA);
  static constexpr int kStageB = 2 * kCB * SWB;
  static constexpr int kStage = kStageA > kStageB ? kStageA : kStageB;
  static constexpr int kH = kStages * kStage;
  static constexpr int kMask = kH + 2 * KP * SX;
  static constexpr int kTotal = kMask + 4 * TT;
};

// grid (tiles of TT frames, B). wxt [KP][nA * 64] (Wx^T, zero past K and
// C), w2t [nB * 128][KP] (W2^T, zero past C and K). EVEN: T is even and x
// 4-byte aligned, so a channel's frame pairs come by 4-byte copies.
template <int KP, int TT, bool EVEN>
__global__ void __launch_bounds__(kThreads, MmaPlan<KP, TT>::kBlocksPerSM) attend_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
    const __nv_bfloat16* __restrict__ wxt, const float* __restrict__ glob,
    const float* __restrict__ bns, const float* __restrict__ bnt,
    const __nv_bfloat16* __restrict__ w2t, const float* __restrict__ b2,
    float* __restrict__ part, int C, int Tn, int K) {
  typedef __nv_bfloat16 bf16;
  typedef MmaPlan<KP, TT> P;
  constexpr int kStages = P::kStages;
  constexpr int MA = KP / 4;         // units a warp takes in the first product
  constexpr int MI = MA / 16;        // its m16 tiles
  constexpr int NJ = TT / 16;        // n8 tiles a warp takes there (half the frames)
  constexpr int NB = TT / 8;         // n8 tiles a warp takes in the second (all frames)
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;
  bf16* h_s = reinterpret_cast<bf16*>(smem_raw + P::kH);
  float* m_s = reinterpret_cast<float*>(smem_raw + P::kMask);
  const int b = blockIdx.y, tile = blockIdx.x, t0 = tile * TT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix: row of the lane's address
  const int lcol = (lane >> 4) * 8;                     // ... and its column
  const bf16* xb = x + (size_t)b * C * Tn;
  const int nA = (C + kCA - 1) / kCA, nB = (C + kCB - 1) / kCB, nq = nA + nB;
  const int cpa = nA * kCA;

  for (int i = tid; i < TT; i += kThreads) {
    const int t = t0 + i;
    m_s[i] = t < Tn ? mask_at(mask, b, t, Tn) : 0.f;
  }

  // chunk q into its stage: q < nA the first product's x and Wx^T chunks,
  // then the second product's W2^T chunks; one commit group a chunk
  auto load = [&](int q) {
    unsigned char* st = ring + (q % kStages) * P::kStage;
    if (q < nA) {
      const int c0 = q * kCA;
      bf16* xs = reinterpret_cast<bf16*>(st);
      if (EVEN) {
        for (int i = tid; i < kCA * TT / 2; i += kThreads) {
          const int r = i / (TT / 2), w = i - r * (TT / 2);
          const int c = c0 + r, t = t0 + 2 * w;
          const bool ok = c < C && t < Tn;
          cp_async4(smem_u32(xs + r * P::SX + 2 * w), ok ? xb + (size_t)c * Tn + t : xb, ok ? 4u : 0u);
        }
      } else {
        for (int i = tid; i < kCA * TT; i += kThreads) {
          const int r = i / TT, j = i - r * TT;
          const int c = c0 + r, t = t0 + j;
          xs[r * P::SX + j] = (c < C && t < Tn) ? xb[(size_t)c * Tn + t] : __float2bfloat16_rn(0.f);
        }
      }
      bf16* wa = xs + kCA * P::SX;
      for (int i = tid; i < KP * (kCA / 8); i += kThreads) {
        const int k = i / (kCA / 8), v = i - k * (kCA / 8);
        cp_async16(smem_u32(wa + k * P::SWA + 8 * v), wxt + (size_t)k * cpa + c0 + 8 * v);
      }
    } else {
      const int c0 = (q - nA) * kCB;
      bf16* wb = reinterpret_cast<bf16*>(st);
      for (int i = tid; i < kCB * (KP / 8); i += kThreads) {
        const int r = i / (KP / 8), v = i - r * (KP / 8);
        cp_async16(smem_u32(wb + r * P::SWB + 8 * v), w2t + (size_t)(c0 + r) * KP + 8 * v);
      }
    }
    cp_async_commit();
  };

  float acc[MI][NJ][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int nj = 0; nj < NJ; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  const int wm = warp & 3, wn = warp >> 2;  // first product: unit quarter, frame half
  const int n_tiles = gridDim.x;

  // chunk q is there for every thread, the stage of chunk q - 1 is free,
  // and chunk q + kStages - 1 is on its way
  auto next = [&](int q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (q + kStages - 1 < nq) load(q + kStages - 1); else cp_async_commit();
    return ring + (q % kStages) * P::kStage;
  };

  for (int q = 0; q < kStages - 1 && q < nq; ++q) load(q);
  for (int q = 0; q < nA; ++q) {
    const unsigned char* st = next(q);
    {
      // u^T += Wx^T[units, chunk] . x[chunk, frames]
      const uint32_t xs = smem_u32(st);
      const uint32_t wa = xs + 2 * kCA * P::SX;
#pragma unroll
      for (int kk = 0; kk < kCA / 16; ++kk) {
        uint32_t af[MI][4], bfr[NJ][2];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          ldmatrix_x4(af[mi], wa + 2 * ((wm * MA + mi * 16 + lrow) * P::SWA + kk * 16 + lcol));
#pragma unroll
        for (int p = 0; p < NJ / 2; ++p) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, xs + 2 * ((kk * 16 + lrow) * P::SX + wn * (TT / 2) + p * 16 + lcol));
          bfr[2 * p][0] = r4[0];
          bfr[2 * p][1] = r4[1];
          bfr[2 * p + 1][0] = r4[2];
          bfr[2 * p + 1][1] = r4[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int nj = 0; nj < NJ; ++nj) mma_bf16_16816(acc[mi][nj], af[mi], bfr[nj]);
      }
      if (q == nA - 1) {
        // h^T = tanh(relu(u + glob) * bn_s + bn_t) in bf16; zero past K
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int k = wm * MA + mi * 16 + g + 8 * hf;
            const bool ok = k < K;
            const float gk = ok ? glob_at(glob, b, k, gridDim.y, K) : 0.f;
            const float sk = ok ? bns[k] : 0.f, hk = ok ? bnt[k] : 0.f;
#pragma unroll
            for (int nj = 0; nj < NJ; ++nj) {
              const float h0 = tanhf(fmaxf(acc[mi][nj][2 * hf] + gk, 0.f) * sk + hk);
              const float h1 = tanhf(fmaxf(acc[mi][nj][2 * hf + 1] + gk, 0.f) * sk + hk);
              const int n = wn * (TT / 2) + nj * 8 + 2 * tg;
              *reinterpret_cast<uint32_t*>(h_s + k * P::SX + n) = pack_bf16(h0, h1);
            }
          }
      }
    }
  }
  // bit 2 nj + e: the frame of accumulator column nj * 8 + 2 tg + e is valid
  uint32_t valid = 0;
#pragma unroll
  for (int nj = 0; nj < NB; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (m_s[nj * 8 + 2 * tg + e] != 0.f) valid |= 1u << (2 * nj + e);

  for (int q = nA; q < nq; ++q) {
    const unsigned char* st = next(q);
    {
      // a^T[16 channels of this warp, all frames] = W2^T . h^T, then the
      // tile's softmax partials of each channel
      const int cw = (q - nA) * kCB + warp * 16;  // the warp's first channel
      const int rows[2] = {cw + g, cw + g + 8};
      // x at the accumulator's frame pairs, from L2, issued before the products
      uint32_t xv[2][NB];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int nj = 0; nj < NB; ++nj) {
          const int t = t0 + nj * 8 + 2 * tg;
          const bf16* src = xb + (size_t)rows[hf] * Tn + t;
          if (EVEN) {
            xv[hf][nj] = (rows[hf] < C && t < Tn) ? __ldg(reinterpret_cast<const unsigned int*>(src)) : 0u;
          } else {
            const bf16 z = __float2bfloat16_rn(0.f);
            const bf16 v0 = (rows[hf] < C && t < Tn) ? src[0] : z;
            const bf16 v1 = (rows[hf] < C && t + 1 < Tn) ? src[1] : z;
            xv[hf][nj] = (uint32_t)__bfloat16_as_ushort(v0) | ((uint32_t)__bfloat16_as_ushort(v1) << 16);
          }
        }
      float ab[NB][4];
#pragma unroll
      for (int nj = 0; nj < NB; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) ab[nj][e] = 0.f;
      const uint32_t wb = smem_u32(st), hs = smem_u32(h_s);
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, wb + 2 * ((warp * 16 + lrow) * P::SWB + kk * 16 + lcol));
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, hs + 2 * ((kk * 16 + lrow) * P::SX + p * 16 + lcol));
          mma_bf16_16816(ab[2 * p], af, r4);
          mma_bf16_16816(ab[2 * p + 1], af, r4 + 2);
        }
      }
      // the softmax in base 2: logits of valid frames times log2(e), the
      // others -inf, whose exp2 is 0
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int c = rows[hf];
        const float bias = c < C ? b2[c] : 0.f;
        float mx = -INFINITY;
#pragma unroll
        for (int nj = 0; nj < NB; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = ab[nj][2 * hf + e];
            v = (valid >> (2 * nj + e)) & 1u ? (v + bias) * kLog2e : -INFINITY;
            mx = fmaxf(mx, v);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float s = 0.f, s1 = 0.f, s2 = 0.f;
        if (mx != -INFINITY) {
          float sp[2] = {0.f, 0.f}, sp1[2] = {0.f, 0.f}, sp2[2] = {0.f, 0.f};  // two chains of sums
#pragma unroll
          for (int nj = 0; nj < NB; ++nj)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float ex = exp2_approx(ab[nj][2 * hf + e] - mx);
              const float xf = __uint_as_float(e == 0 ? xv[hf][nj] << 16 : xv[hf][nj] & 0xffff0000u);
              const float exx = ex * xf;
              sp[e] += ex;
              sp1[e] += exx;
              sp2[e] = fmaf(exx, xf, sp2[e]);
            }
          s = sp[0] + sp[1];
          s1 = sp1[0] + sp1[1];
          s2 = sp2[0] + sp2[1];
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        }
        if (tg == 0 && c < C) {
          float* pp = part + ((size_t)b * n_tiles + tile) * 4 * C + c;
          pp[0] = mx * kLn2;  // back to the logits' scale, as combine_kernel reads it
          pp[C] = s;
          pp[2 * C] = s1;
          pp[3 * C] = s2;
        }
      }
    }
  }
}

template <int KP, int TT, bool EVEN>
int launch_attend_mma(const __nv_bfloat16* x, const uint8_t* mask, const __nv_bfloat16* wxt,
                      const float* glob, const float* bns, const float* bnt,
                      const __nv_bfloat16* w2t, const float* b2, float* part, int B, int C, int Tn,
                      int K, cudaStream_t st) {
  const int smem = MmaPlan<KP, TT>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(attend_mma_kernel<KP, TT, EVEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + TT - 1) / TT, B);
  attend_mma_kernel<KP, TT, EVEN><<<grid, kThreads, smem, st>>>(x, mask, wxt, glob, bns, bnt, w2t,
                                                                b2, part, C, Tn, K);
  return (int)cudaGetLastError();
}

int launch_mma(const __nv_bfloat16* x, const uint8_t* mask, const __nv_bfloat16* wxt,
               const float* glob, const float* bns, const float* bnt, const __nv_bfloat16* w2t,
               const float* b2, float* part, int B, int C, int Tn, int K, int kp, bool even,
               cudaStream_t st) {
  if (kp == 128)
    return even ? launch_attend_mma<128, kTT, true>(x, mask, wxt, glob, bns, bnt, w2t, b2, part, B, C, Tn, K, st)
                : launch_attend_mma<128, kTT, false>(x, mask, wxt, glob, bns, bnt, w2t, b2, part, B, C, Tn, K, st);
  return even ? launch_attend_mma<256, kTT, true>(x, mask, wxt, glob, bns, bnt, w2t, b2, part, B, C, Tn, K, st)
              : launch_attend_mma<256, kTT, false>(x, mask, wxt, glob, bns, bnt, w2t, b2, part, B, C, Tn, K, st);
}

size_t attend_smem(int K) {
  return sizeof(float) * ((size_t)kCC * kTT + (size_t)kCC * K + (size_t)K * kTT + kTT);
}

template <typename T, int TK>
int launch_attend(const T* x, const uint8_t* mask, const T* wx, const float* glob,
                  const float* bns, const float* bnt, const T* w2, const float* b2,
                  float* part, int B, int C, int Tn, int K, cudaStream_t st) {
  const size_t smem = attend_smem(K);
  cudaError_t err = cudaFuncSetAttribute(attend_kernel<T, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tn + kTT - 1) / kTT, B);
  attend_kernel<T, TK><<<grid, kThreads, smem, st>>>(x, mask, wx, glob, bns, bnt, w2, b2, part,
                                                     C, Tn, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_all(const void* xv, const void* maskv, const void* wxv, const void* wmv,
               const void* wsv, const void* b1, const void* bns, const void* bnt,
               const void* w2v, const void* b2, void* out, unsigned char* work, int B, int C, int Tn,
               int K, const asv_plan::AttPlan& plan, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const uint8_t* mask = static_cast<const uint8_t*>(maskv);
  float* stats = reinterpret_cast<float*>(work + plan.stats);
  float* g = reinterpret_cast<float*>(work + plan.glob);
  float* p = reinterpret_cast<float*>(work + plan.part);
  att_stats_kernel<T><<<dim3((C + kStatsChannels - 1) / kStatsChannels, B), kThreads, 0, st>>>(
      x, mask, stats, C, Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glob_kernel<T><<<dim3((B + kGlobRows - 1) / kGlobRows, (K + 127) / 128, kGlobSplit), kGlobThreads, 0, st>>>(
      stats, static_cast<const T*>(wmv), static_cast<const T*>(wsv), static_cast<const float*>(b1), g, B, C, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const T* wx = static_cast<const T*>(wxv);
  const T* w2 = static_cast<const T*>(w2v);
  const float* s = static_cast<const float*>(bns);
  const float* t = static_cast<const float*>(bnt);
  const float* bb = static_cast<const float*>(b2);
  int rc;
  if (plan.tensor) {
    typedef __nv_bfloat16 bf;
    rc = padded_transpose<uint16_t>(wxv, work + plan.wxt, 1, C, K, plan.kp, plan.wxt_cols, st);
    if (rc == 0) rc = padded_transpose<uint16_t>(w2v, work + plan.w2t, 1, K, C, plan.w2t_rows, plan.kp, st);
    if (rc != 0) return rc;
    // the frame pairs come by 4-byte copies where T is even and x 4-byte aligned
    const bool even = Tn % 2 == 0 && reinterpret_cast<uintptr_t>(xv) % 4 == 0;
    rc = launch_mma(reinterpret_cast<const bf*>(x), mask, reinterpret_cast<const bf*>(work + plan.wxt), g, s, t,
                    reinterpret_cast<const bf*>(work + plan.w2t), bb, p, B, C, Tn, K, plan.kp, even, st);
  } else if (K <= 32) {
    rc = launch_attend<T, 1>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  } else if (K <= 64) {
    rc = launch_attend<T, 2>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  } else if (K <= 128) {
    rc = launch_attend<T, 4>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  } else {
    rc = launch_attend<T, 8>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  }
  if (rc != 0) return rc;
  combine_kernel<<<dim3((C + 255) / 256, B), 256, 0, st>>>(p, static_cast<float*>(out), C, plan.tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The C interface is declared, and its arguments described, in launch_plan.h.
int asv_att_pool_workspace_bytes(int B, int C, int T, int K, int bf16, long long* bytes) {
  asv_plan::AttPlan plan;
  if (!asv_plan::att_plan(B, C, T, K, bf16, &plan)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)plan.bytes;
  return 0;
}

int asv_att_pool_launch(const void* x, const void* mask, const void* wx, const void* wm,
                        const void* ws, const void* b1, const void* bns, const void* bnt,
                        const void* w2, const void* b2, void* out, void* work, int B, int C, int T,
                        int K, int bf16, int* route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  asv_plan::AttPlan plan;
  if (!asv_plan::att_plan(B, C, T, K, bf16, &plan)) return (int)cudaErrorInvalidValue;
  if (route != nullptr) *route = plan.tensor;
  unsigned char* w = static_cast<unsigned char*>(work);
  if (bf16)
    return launch_all<__nv_bfloat16>(x, mask, wx, wm, ws, b1, bns, bnt, w2, b2, out, w, B, C, T, K, plan, st);
  return launch_all<float>(x, mask, wx, wm, ws, b1, bns, bnt, w2, b2, out, w, B, C, T, K, plan, st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
