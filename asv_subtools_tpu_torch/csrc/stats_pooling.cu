// Masked statistics pooling (mean ++ biased std over time) in one pass over
// x, for Hopper (sm_90a).
//
// Replaces: asv_subtools_tpu/nn/pallas_pooling.py `fused_stats_pooling`
// (pallas_call at :70, body `_kernel` :34).
// x [B, T, D] (f32 or bf16), mask [B, T] -> out [B, 2D] f32:
//   cnt  = max(sum_t mask, 1)
//   mean = sum_t mask x / cnt
//   std  = sqrt(max(sum_t mask x^2 / cnt - mean^2, eps))
//
// Design. The TPU kernel accumulates into its output block across a
// sequential grid over T, after a host-side cast to f32 and padding (one
// more pass over x). Here x is read once in its own type, 16 bytes a
// thread: a block takes one row b, 32 lanes x VEC features and one span
// of T; its 8 warps stride over the span's frames, four loads in flight
// each, and meet in shared memory. Frames whose mask is 0 are not loaded.
// With one span (splits == 1) the block writes mean and std itself;
// otherwise it writes partial sums [B, splits, 2, D] and a second small
// kernel combines them, so short-T inputs with few (b, D tile) pairs still
// fill the card.
//
// The sums are of (x - x[b, 0, :]), the row's first frame standing in for
// the mean: the result is the same function for any shift, and the
// one-pass variance keeps its digits when |mean| >> std. All spans of a
// row use the same shift, so their partial sums simply add.
//
// Bound on an H100 SXM: bytes. x [128, 125, 2560] bf16 is 81.9 MB, read
// once, plus the mask and 2.6 MB of f32 output -> 25 us at 3.35 TB/s; the
// arithmetic (4 operations an element) is far below the f32 peak.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // frames in flight per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC consecutive features as f32: one 16-byte load when VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "f32 vectors hold 4 features");
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors hold 8 features");
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// number of valid frames of row b, summed by the whole block (all threads
// must call; uses one __syncthreads)
__device__ __forceinline__ float block_count(const uint8_t* __restrict__ mb, int Tn,
                                             float* cnt_s) {
  if (mb == nullptr) return (float)Tn;
  const int tid = threadIdx.x;
  float local = 0.f;
  for (int t = tid; t < Tn; t += blockDim.x) local += mb[t] != 0 ? 1.f : 0.f;
  local = warp_sum(local);
  if ((tid & 31) == 0) cnt_s[tid >> 5] = local;
  __syncthreads();
  float raw = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) raw += cnt_s[i];
  return raw;
}

__device__ __forceinline__ void write_out(float* __restrict__ out, int b, int D, int d,
                                          float shift, float a1, float a2, float raw,
                                          float eps) {
  const float cnt = fmaxf(raw, 1.f);
  const float mu = a1 / cnt;
  const float var = a2 / cnt - mu * mu;
  out[(size_t)b * 2 * D + d] = (raw > 0.f ? shift : 0.f) + mu;
  out[(size_t)b * 2 * D + D + d] = sqrtf(fmaxf(var, eps));
}

// grid (D tiles of 32*VEC, splits, B)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) stats_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ part,
    float* __restrict__ out, long long sb, long long st, int Tn, int D, int splits, float eps) {
  __shared__ float red[kWarps][2 * VEC * 32];
  __shared__ float cnt_s[kWarps];
  const int b = blockIdx.z, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = (blockIdx.x * 32 + lane) * VEC;
  const bool live = d0 < D;
  const T* xb = x + (size_t)b * sb;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Tn;
  const int rows = (Tn + splits - 1) / splits;
  const int tbeg = split * rows, tend = min(Tn, tbeg + rows);

  float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) shift[e] = s1[e] = s2[e] = 0.f;
  if (live) load_vec<T, VEC>(xb + d0, shift);

  for (int t = tbeg + warp; t < tend; t += kWarps * kUnroll) {
    float v[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t + u * kWarps;
      ok[u] = live && tt < tend && (mb == nullptr || mb[tt] != 0);
      if (ok[u]) load_vec<T, VEC>(xb + (size_t)tt * st + d0, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (ok[u]) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float dl = v[u][e] - shift[e];
          s1[e] += dl;
          s2[e] = fmaf(dl, dl, s2[e]);
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[warp][e * 32 + lane] = s1[e];
    red[warp][(VEC + e) * 32 + lane] = s2[e];
  }
  const float raw = splits == 1 ? block_count(mb, Tn, cnt_s) : 0.f;
  __syncthreads();
  if (warp != 0 || !live) return;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a1 += red[w][e * 32 + lane];
      a2 += red[w][(VEC + e) * 32 + lane];
    }
    const int d = d0 + e;
    if (splits == 1) {
      write_out(out, b, D, d, shift[e], a1, a2, raw, eps);
    } else {
      float* p = part + ((size_t)b * splits + split) * 2 * D;
      p[d] = a1;
      p[D + d] = a2;
    }
  }
}

// grid (D tiles of 256, B): add the spans' partial sums
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, const float* __restrict__ part,
    float* __restrict__ out, long long sb, int Tn, int D, int splits, float eps) {
  __shared__ float cnt_s[kWarps];
  const int b = blockIdx.y;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Tn;
  const float raw = block_count(mb, Tn, cnt_s);
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float a1 = 0.f, a2 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* p = part + ((size_t)b * splits + s) * 2 * D;
    a1 += p[d];
    a2 += p[D + d];
  }
  write_out(out, b, D, d, to_f32(x[(size_t)b * sb + d]), a1, a2, raw, eps);
}

template <typename T, int VEC>
int launch(const void* xv, const void* maskv, void* part, void* out, long long sb, long long st,
           int B, int Tn, int D, int splits, float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const uint8_t* mask = static_cast<const uint8_t*>(maskv);
  const dim3 grid((D + 32 * VEC - 1) / (32 * VEC), splits, B);
  stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      x, mask, static_cast<float*>(part), static_cast<float*>(out), sb, st, Tn, D, splits, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  combine_kernel<T><<<dim3((D + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(
      x, mask, static_cast<const float*>(part), static_cast<float*>(out), sb, Tn, D, splits, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, T, D] with element strides sb (batch), st (time) and 1 (feature),
// bf16 when bf16 != 0, else f32; mask [B, T] uint8 or null; part scratch
// [B, splits, 2, D] f32 (unused when splits == 1); out [B, 2D] f32.
// vec: features per load, 1 or 16 bytes' worth (4 f32, 8 bf16); the caller
// passes 16 bytes' worth only when D, sb, st are multiples of it and x is
// 16-byte aligned. Returns the first CUDA error, or 0.
int asv_stats_pool_launch(const void* x, const void* mask, void* part, void* out, long long sb,
                          long long st, int B, int T, int D, int splits, int vec, int bf16,
                          float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || splits < 1 || splits > 65535 || T < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (vec == 8)
      return launch<__nv_bfloat16, 8>(x, mask, part, out, sb, st, B, T, D, splits, eps, s);
    if (vec == 1)
      return launch<__nv_bfloat16, 1>(x, mask, part, out, sb, st, B, T, D, splits, eps, s);
  } else {
    if (vec == 4) return launch<float, 4>(x, mask, part, out, sb, st, B, T, D, splits, eps, s);
    if (vec == 1) return launch<float, 1>(x, mask, part, out, sb, st, B, T, D, splits, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
