// Fused Kaldi log-mel fbank for Hopper (sm_90a): framing, DC removal,
// preemphasis, window, DFT, power, mel and log in one kernel.
//
// Replaces: asv_subtools_tpu/features/pallas_fbank.py `fused_fbank`
// (pallas_call at :283, body `_kernel` at :139). Semantics are those of
// compute_fbank at dither=0, snip_edges=True.
//
// Design. Window processing is linear, so the host folds DC removal,
// preemphasis and the window into one effective DFT matrix
// eff = (M0 D A diag(win)) @ [C | S], shape [window, 2*256], rows past the
// window zero-padded to a multiple of 16 (asv_subtools_tpu_torch/features/
// fused_fbank.py, as pallas_fbank.py:103-124 does). One block takes one
// batch row and a tile of 64 frames and frames straight from the waveform
// span it holds in shared memory: (64-1)*shift + window samples, 41.9 KB in
// f32 at 25 ms / 10 ms. The DFT is a [64, window] @ [window, 512] product on
// the CUDA cores; the folded matrix (819 KB in f32) does not fit in shared
// memory, so it streams through in chunks of 16 rows from L2. Each thread
// keeps 8 frames x 8 bins of [re | im] in registers (128 f32 accumulators),
// squares them into a [64, 256] power tile in shared memory (aliasing the
// span and the chunk), and the mel product walks each filter's band of
// non-zero weights only. The ragged tail is masked here: the kernel writes
// exactly [B, T, nb].
//
// bf16 mode (the serving default) reproduces the TPU kernel's rounding
// points (pallas_fbank.py:179-199): the raw samples and the folded matrix
// are rounded to bf16, and products are taken and summed in f32. A product
// of two bf16 values is exact in f32.
//
// Shared memory per block (f32 floats): max(span + 16*512, 64*256) + mel
// weights + 3*nb ints. At 25/10 ms and 80 bins: 74.7 KB + 2.4 KB.
//
// Bound on an H100 SXM at [128, 160000] -> [128, 998, 80], bf16 mode: the
// DFT is 2*127,744*400*512 = 52.3 GFLOP (the mel band product adds 0.13
// GFLOP); 82 MB read + 41 MB written. At 989 TFLOP/s (bf16 tensor-core
// peak) that is 53 us; at 3.35 TB/s, 37 us. This first kernel runs on the
// CUDA cores (67 TFLOP/s f32 peak, 0.78 ms for this work); the tensor-core
// (wgmma) version is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 64;            // frames per block: 8 warps x 8
constexpr int kFramesPerThread = 8;
constexpr int kBins = 256;             // kept DFT bins (padded window 512)
constexpr int kCols = 2 * kBins;       // [cos | sin]
constexpr int kChunk = 16;             // folded-matrix rows per chunk
constexpr float kEps = 1.1920928955078125e-07f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline int span_len(int shift, int window_pad) {
  return (kFrames - 1) * shift + window_pad;
}

__host__ __device__ inline int region_len(int shift, int window_pad) {
  int a = span_len(shift, window_pad) + kChunk * kCols;
  int b = kFrames * kBins;
  return a > b ? a : b;
}

template <typename TE, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) fbank_kernel(
    const float* __restrict__ wave,      // [B, S]
    const TE* __restrict__ eff,          // [window_pad, 512] folded [cos | sin]
    const int* __restrict__ mel_meta,    // [nb, 3]: first bin, count, offset
    const float* __restrict__ mel_w,     // [nnz] band weights
    float* __restrict__ out,             // [B, T, nb]
    float* __restrict__ energy,          // [B, T] raw log-energy, or null
    int S, int T, int shift, int window, int window_pad, int nb, int nnz,
    int use_power, int use_log, int remove_dc) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_span = span_len(shift, window_pad);

  float* span = smem;                    // waveform span of the tile
  float* chunk = smem + n_span;          // kChunk rows of the folded matrix
  float* power = smem;                   // [kFrames, kBins], aliases both
  float* melw_s = smem + region_len(shift, window_pad);
  int* meta_s = reinterpret_cast<int*>(melw_s + nnz);

  const float* w = wave + (size_t)b * S;
  const long long base = (long long)t0 * shift;
  for (int i = tid; i < n_span; i += kThreads) {
    const long long s = base + i;
    span[i] = s < S ? w[s] : 0.f;
  }
  for (int i = tid; i < nnz; i += kThreads) melw_s[i] = mel_w[i];
  for (int i = tid; i < 3 * nb; i += kThreads) meta_s[i] = mel_meta[i];
  __syncthreads();

  if (energy != nullptr) {
    // raw energy over the true window, in f32 from the unrounded samples
    // (pallas_fbank.py:209-220): one warp per frame
    for (int f = warp; f < kFrames; f += kThreads / 32) {
      const float* fr = span + f * shift;
      float s1 = 0.f, s2 = 0.f;
      for (int n = lane; n < window; n += 32) {
        const float v = fr[n];
        s1 += v;
        s2 += v * v;
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0 && t0 + f < T) {
        const float e = remove_dc ? s2 - s1 * s1 / (float)window : s2;
        energy[(size_t)b * T + t0 + f] = logf(fmaxf(e, kEps));
      }
    }
    __syncthreads();
  }
  if (kBf16) {
    for (int i = tid; i < n_span; i += kThreads) span[i] = round_bf16(span[i]);
    __syncthreads();
  }

  // DFT: this thread owns frames fbase..fbase+7 and bins lane*4..+3,
  // 128+lane*4..+3 of both the cosine and the sine half.
  const int fbase = warp * kFramesPerThread;
  float re[kFramesPerThread][8];
  float im[kFramesPerThread][8];
#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }

  for (int n0 = 0; n0 < window_pad; n0 += kChunk) {
    const TE* src = eff + (size_t)n0 * kCols;
    for (int i = tid; i < kChunk * kCols; i += kThreads) chunk[i] = to_f32(src[i]);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float4 a[kFramesPerThread];
#pragma unroll
      for (int i = 0; i < kFramesPerThread; ++i)
        a[i] = *reinterpret_cast<const float4*>(span + (fbase + i) * shift + n0 + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* row = chunk + (kk + u) * kCols;
        const float4 c0 = *reinterpret_cast<const float4*>(row + lane * 4);
        const float4 c1 = *reinterpret_cast<const float4*>(row + 128 + lane * 4);
        const float4 s0 = *reinterpret_cast<const float4*>(row + 256 + lane * 4);
        const float4 s1 = *reinterpret_cast<const float4*>(row + 384 + lane * 4);
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int i = 0; i < kFramesPerThread; ++i) {
          const float av = u == 0 ? a[i].x : u == 1 ? a[i].y : u == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            re[i][j] = fmaf(av, cv[j], re[i][j]);
            im[i][j] = fmaf(av, sv[j], im[i][j]);
          }
        }
      }
    }
    __syncthreads();  // chunk (and at the end the span) free for reuse
  }

#pragma unroll
  for (int i = 0; i < kFramesPerThread; ++i) {
    float p[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      p[j] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
      if (!use_power) p[j] = sqrtf(p[j]);
    }
    float* prow = power + (fbase + i) * kBins;
    *reinterpret_cast<float4*>(prow + lane * 4) = make_float4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<float4*>(prow + 128 + lane * 4) = make_float4(p[4], p[5], p[6], p[7]);
  }
  __syncthreads();

  // mel over each filter's band, then log; coalesced [T, nb] rows
  for (int idx = tid; idx < kFrames * nb; idx += kThreads) {
    const int f = idx / nb;
    const int m = idx - f * nb;
    const int t = t0 + f;
    if (t >= T) break;
    const int lo = meta_s[3 * m], cnt = meta_s[3 * m + 1], off = meta_s[3 * m + 2];
    const float* pr = power + f * kBins + lo;
    const float* wr = melw_s + off;
    float s = 0.f;
    for (int q = 0; q < cnt; ++q) s = fmaf(pr[q], wr[q], s);
    if (use_log) s = logf(fmaxf(s, kEps));
    out[((size_t)b * T + t) * nb + m] = s;
  }
}

template <typename TE, bool kBf16>
int launch(const void* wave, const void* eff, const void* mel_meta, const void* mel_w,
           void* out, void* energy, int B, int S, int T, int shift, int window,
           int window_pad, int nb, int nnz, int use_power, int use_log, int remove_dc,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)region_len(shift, window_pad) + nnz) + sizeof(int) * 3 * nb;
  cudaError_t err = cudaFuncSetAttribute(fbank_kernel<TE, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + kFrames - 1) / kFrames, B);
  fbank_kernel<TE, kBf16><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(wave), static_cast<const TE*>(eff),
      static_cast<const int*>(mel_meta), static_cast<const float*>(mel_w),
      static_cast<float*>(out), static_cast<float*>(energy), S, T, shift, window,
      window_pad, nb, nnz, use_power, use_log, remove_dc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory bytes a launch with this geometry needs.
size_t asv_fbank_smem_bytes(int shift, int window_pad, int nb, int nnz) {
  return sizeof(float) * ((size_t)region_len(shift, window_pad) + nnz) + sizeof(int) * 3 * nb;
}

// wave [B, S] f32; eff [window_pad, 512] (bf16 when dft_bf16, else f32);
// mel_meta [nb, 3] int32; mel_w [nnz] f32; out [B, T, nb] f32; energy
// [B, T] f32 or null. All contiguous on one device. Returns cudaGetLastError().
int asv_fbank_launch(const void* wave, const void* eff, const void* mel_meta,
                     const void* mel_w, void* out, void* energy, int B, int S, int T,
                     int shift, int window, int window_pad, int nb, int nnz,
                     int use_power, int use_log, int remove_dc, int dft_bf16,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dft_bf16)
    return launch<__nv_bfloat16, true>(wave, eff, mel_meta, mel_w, out, energy, B, S, T,
                                       shift, window, window_pad, nb, nnz, use_power,
                                       use_log, remove_dc, st);
  return launch<float, false>(wave, eff, mel_meta, mel_w, out, energy, B, S, T, shift,
                              window, window_pad, nb, nnz, use_power, use_log, remove_dc,
                              st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
