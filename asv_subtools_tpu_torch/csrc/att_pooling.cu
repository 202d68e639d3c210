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
//   1. stats:   per (b, 32 channels), masked sum x and x^2 over T -> mean,
//               std, one warp per channel.
//   2. glob:    per b, glob = mean@Wm + std@Ws + b1 (the small product the
//               TPU kernel does in its body, :89-94).
//   3. attend:  per (b, 64 frames): u = x@Wx (x and Wx streamed through
//               shared memory in 32-channel chunks; 8 frames x K/32
//               bottleneck units per thread), h in shared memory (rounded
//               to the weights' type, as :107 does), then one thread per
//               channel computes a over the 64 frames in registers and
//               writes the partials (max, sum e, sum e x, sum e x^2) of
//               the softmax, e = exp(a - max).
//   4. combine: per (b, channel), rescale the tiles' partials to the common
//               max and write mean_w, std_w.
// The softmax uses a true running max: the TPU kernel clamps the logits at
// 80 instead (:111-116); both agree wherever the logits stay below 80. A
// tile with no valid frame has max -inf and contributes nothing; a row
// with no valid frame gives mean_w 0 and std_w sqrt(1e-5), as the TPU
// kernel does. Products of bf16 values are exact in f32 and all sums are
// f32.
//
// Data layout: x is [B, C, T] in memory (time contiguous), the layout the
// port's model produces, so the model hands it over without a transpose.
//
// Bound on an H100 SXM at x [128, 998, 1536] bf16, K=128: x must be read
// once, 392.4 MB -> 117 us at 3.35 TB/s; the two products are
// 2*2*127,744*1536*128 = 100.5 GFLOP -> 102 us at 989 TFLOP/s. This first
// kernel reads x twice (stats, attend) and runs the products on the CUDA
// cores (67 TFLOP/s f32 peak: 1.5 ms for this work); tensor cores are
// later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTT = 64;  // frames per attend block: 8 warps x 8
constexpr int kCC = 32;  // channels per shared-memory chunk in attend
constexpr int kStatsChannels = 32;  // channels per stats block: 8 warps x 4

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

// stats [B, 2, C]: row 0 mean, row 1 std (unbiased, +1e-5)
template <typename T>
__global__ void __launch_bounds__(kThreads) stats_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ stats,
    int C, int Tn) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float local = 0.f;
  for (int t = tid; t < Tn; t += kThreads) local += mask_at(mask, b, t, Tn);
  local = warp_sum(local);
  if (lane == 0) red[warp] = local;
  __syncthreads();
  float cnt = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) cnt += red[i];
  cnt = fmaxf(cnt, 1.f);

  for (int j = 0; j < kStatsChannels / (kThreads / 32); ++j) {
    const int c = blockIdx.x * kStatsChannels + warp * (kStatsChannels / (kThreads / 32)) + j;
    if (c >= C) break;
    const T* row = x + ((size_t)b * C + c) * Tn;
    float s1 = 0.f, s2 = 0.f;
    for (int t = lane; t < Tn; t += 32) {
      const float v = to_f32(row[t]);
      const float vm = v * mask_at(mask, b, t, Tn);
      s1 += vm;
      s2 += vm * v;
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mean = s1 / cnt;
      const float var = (s2 - cnt * mean * mean) / fmaxf(cnt - 1.f, 1.f);
      stats[(size_t)b * 2 * C + c] = mean;
      stats[(size_t)b * 2 * C + C + c] = sqrtf(fmaxf(var, 0.f) + 1e-5f);
    }
  }
}

// glob [B, K] = mean@Wm + std@Ws + b1
template <typename T>
__global__ void glob_kernel(const float* __restrict__ stats, const T* __restrict__ wm,
                            const T* __restrict__ ws, const float* __restrict__ b1,
                            float* __restrict__ glob, int C, int K) {
  const int b = blockIdx.x;
  const float* mean = stats + (size_t)b * 2 * C;
  const float* stdv = mean + C;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float gm = 0.f, gs = 0.f;
    for (int c = 0; c < C; ++c) {
      gm = fmaf(mean[c], to_f32(wm[(size_t)c * K + k]), gm);
      gs = fmaf(stdv[c], to_f32(ws[(size_t)c * K + k]), gs);
    }
    glob[(size_t)b * K + k] = gm + gs + b1[k];
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
      const float g = glob[(size_t)b * K + k], s = bns[k], sh = bnt[k];
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
               const void* w2v, const void* b2, void* stats, void* glob, void* part, void* out,
               int B, int C, int Tn, int K, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const uint8_t* mask = static_cast<const uint8_t*>(maskv);
  stats_kernel<T><<<dim3((C + kStatsChannels - 1) / kStatsChannels, B), kThreads, 0, st>>>(
      x, mask, static_cast<float*>(stats), C, Tn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  glob_kernel<T><<<B, 128, 0, st>>>(static_cast<const float*>(stats),
                                    static_cast<const T*>(wmv), static_cast<const T*>(wsv),
                                    static_cast<const float*>(b1), static_cast<float*>(glob),
                                    C, K);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const T* wx = static_cast<const T*>(wxv);
  const T* w2 = static_cast<const T*>(w2v);
  const float* g = static_cast<const float*>(glob);
  const float* s = static_cast<const float*>(bns);
  const float* t = static_cast<const float*>(bnt);
  const float* bb = static_cast<const float*>(b2);
  float* p = static_cast<float*>(part);
  int rc;
  if (K <= 32)
    rc = launch_attend<T, 1>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  else if (K <= 64)
    rc = launch_attend<T, 2>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  else if (K <= 128)
    rc = launch_attend<T, 4>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  else
    rc = launch_attend<T, 8>(x, mask, wx, g, s, t, w2, bb, p, B, C, Tn, K, st);
  if (rc != 0) return rc;
  const int n_tiles = (Tn + kTT - 1) / kTT;
  combine_kernel<<<dim3((C + 255) / 256, B), 256, 0, st>>>(p, static_cast<float*>(out), C,
                                                          n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, C, T] (bf16 when bf16 != 0, else f32); mask [B, T] uint8 or null;
// wx, wm, ws [C, K] and w2 [K, C] in x's type; b1, bns, bnt [K] and b2 [C]
// f32. Scratch: stats [B, 2, C], glob [B, K], part [B, ceil(T/64), 4, C]
// f32. out [B, 2C] f32. K <= 256. Returns the first CUDA error, or 0.
int asv_att_pool_launch(const void* x, const void* mask, const void* wx, const void* wm,
                        const void* ws, const void* b1, const void* bns, const void* bnt,
                        const void* w2, const void* b2, void* stats, void* glob, void* part,
                        void* out, int B, int C, int T, int K, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_all<__nv_bfloat16>(x, mask, wx, wm, ws, b1, bns, bnt, w2, b2, stats, glob,
                                     part, out, B, C, T, K, st);
  return launch_all<float>(x, mask, wx, wm, ws, b1, bns, bnt, w2, b2, stats, glob, part, out,
                           B, C, T, K, st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
