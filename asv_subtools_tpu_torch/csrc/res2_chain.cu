// The ECAPA Res2Net chain at inference, fused into one kernel, for Hopper
// (sm_90a).
//
// Replaces: asv_subtools_tpu/nn/pallas_res2.py `fused_res2_chain`
// (pallas_call at :113, body `_kernel` :41).
// x [B, T, C], C = (n + 1) * h. Group 0 passes through. Stage s = 0..n-1:
//   sp  = part[s+1] (+ sp)                      chain state, f32
//   z   = [sp(t-d) | sp(t) | sp(t+d)] @ w[s]     k=3 dilated conv, zero "same"
//                                               padding, operands rounded to
//                                               x's type, f32 sums
//   sp  = relu(z + b[s]) * bn_scale[s] + bn_shift[s]
//   out[:, :, (s+1)h : (s+2)h] = sp              in x's type
//
// Design. The TPU kernel holds one whole row [T, C] in VMEM (T <= 1280,
// h % 128 == 0). A [998, 128] stage does not fit a Hopper block's shared
// memory beside its weights, so T is tiled: a block takes one batch row and
// TT output frames, loads the input window [t0 - n*d, t0 + TT + n*d) and
// recomputes the halo, which shrinks by d a side each stage. The state
// lives in shared memory as [h][rows] f32 (time contiguous, as x is in
// memory, so loads and stores to device memory run along T), already
// rounded to the operand type. A stage's weights stream through shared
// memory in 32-row chunks. A thread owns up to 3 x 8 frames x h/32 output
// channels in registers for the whole stage, so the state is updated in
// place after one barrier. Frames outside [0, T) are written back as zero
// after every stage, on both sides: they are the conv's zero padding for
// the next stage, though relu(bias) * scale + shift is not zero there.
//
// Two kernels share this scheme. `res2_kernel` runs the products on the
// CUDA cores (f32 FMA; a product of two bf16 values is exact in f32): it
// serves f32 x, where operands and state must stay f32, and any h <= 128.
// `res2_mma_kernel` serves bf16 x with h in {16, 32, 64, 128} on the
// tensor cores: `mma.sync.m16n8k16` on bf16 with f32 accumulation, the
// state held in shared memory as bf16 [rows][h] (the A operand, input
// channel contiguous), a whole stage's weights as [h out][3h] (the B
// operand, one copy a stage), fragments read with plain 32-bit loads from
// rows padded by 16 bytes (conflict-free). Each of 8 warps owns one half of
// the output channels and up to three 16-frame tiles, so a stage's 192 rows
// are one pass with all sums in registers; the stage's f32 result then
// goes through the weights' shared memory (free until the next stage) so
// that device memory is read and written along T. The loads of the part
// that a stage adds at its end are slow (2 bytes a lane, transposing), and
// issued after the products they left the kernel waiting: so each stage
// first asks for that part to be brought into L2, and 4 more warps fetch it
// into shared memory while the 8 multiply. wgmma and TMA are later work.
//
// Data layout: x and out are [B, C, T] in memory (time contiguous), the
// layout the port's model holds, so the model pays no transpose.
//
// Cost of the tiling: with n = 7, the block's 192 rows give TT <= 192 - 12 d
// (168, 156, 144 frames at d = 2, 3, 4); a stage computes its rows in
// passes of 64, so every stage of a full tile costs 3 passes: 192 computed
// frames for TT written, 1.14x to 1.33x the least work, and the input
// window is read (TT + 12 d) / TT times.
//
// Bound on an H100 SXM at x [128, 998, 1024] bf16, h = 128: bytes. x in and
// out 2 x 261.6 MB + 0.7 MB of weights -> 156 us at 3.35 TB/s; the products
// are 2 * 127,744 * 7 * 384 * 128 = 87.9 GFLOP -> 89 us at 989 TFLOP/s
// (bf16 tensor cores), 1.3 ms at the CUDA cores' 67 TFLOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 8;                   // frames per thread and pass
constexpr int kPassRows = kWarps * kFrames;  // 64
constexpr int kPasses = 3;                   // 192 rows per stage at most
constexpr int kKC = 32;                      // weight rows per shared-memory chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f32(from_f32<T>(v)); }

// grid (tiles, B). TC = ceil(h / 32): output channels per thread.
template <typename T, int TC>
__global__ void __launch_bounds__(kThreads, 1) res2_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ bns, const float* __restrict__ bnt, T* __restrict__ out,
    int Tn, int h, int n, int d, int TT, int RP) {
  extern __shared__ __align__(16) float smem[];
  float* sp_s = smem;           // [h][RP] chain state, rows = window frames
  float* w_s = smem + h * RP;   // [kKC][h] weight chunk
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tt_n = min(TT, Tn - t0);  // frames this tile writes
  const int halo = n * d;
  const int R = TT + 2 * halo;  // window rows: row r is frame t0 - halo + r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xb = x + (size_t)b * (n + 1) * h * Tn;
  T* ob = out + (size_t)b * (n + 1) * h * Tn;

  // group 0 passes through
  for (int o = warp; o < h; o += kWarps) {
    const T* src = xb + (size_t)o * Tn + t0;
    T* dst = ob + (size_t)o * Tn + t0;
    for (int r = lane; r < tt_n; r += 32) dst[r] = src[r];
  }
  // stage 0 reads part 1 over the whole window; zero outside [0, T) and in
  // the spare rows
  for (int o = warp; o < h; o += kWarps) {
    const T* xr = xb + (size_t)(h + o) * Tn;
    float* sr = sp_s + o * RP;
    for (int r = lane; r < RP; r += 32) {
      const int t = t0 - halo + r;
      sr[r] = (r < R && t >= 0 && t < Tn) ? to_f32(xr[t]) : 0.f;
    }
  }

  for (int s = 0; s < n; ++s) {
    const int lo = (s + 1) * d, hi = R - (s + 1) * d;  // rows this stage computes
    const int np = (hi - lo + kPassRows - 1) / kPassRows;
    float acc[kPasses][kFrames][TC];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
#pragma unroll
      for (int r = 0; r < kFrames; ++r)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[p][r][j] = 0.f;

    const T* ws = w + (size_t)s * 3 * h * h;
    for (int k = 0; k < 3; ++k) {
      for (int i0 = 0; i0 < h; i0 += kKC) {
        const int cn = min(kKC, h - i0);
        __syncthreads();  // the last chunk is consumed; the state's writes are visible
        const T* wc = ws + (size_t)(k * h + i0) * h;
        for (int idx = tid; idx < cn * h; idx += kThreads) w_s[idx] = to_f32(wc[idx]);
        __syncthreads();
        const float* xbase = sp_s + i0 * RP + lo + warp * kFrames + (k - 1) * d;
#pragma unroll 2
        for (int ii = 0; ii < cn; ++ii) {
          float wv[TC];
#pragma unroll
          for (int j = 0; j < TC; ++j) {
            const int col = lane + 32 * j;
            wv[j] = col < h ? w_s[ii * h + col] : 0.f;
          }
          const float* xr = xbase + ii * RP;
#pragma unroll
          for (int p = 0; p < kPasses; ++p) {
            if (p < np) {
#pragma unroll
              for (int r = 0; r < kFrames; ++r) {
                const float xv = xr[p * kPassRows + r];
#pragma unroll
                for (int j = 0; j < TC; ++j) acc[p][r][j] = fmaf(xv, wv[j], acc[p][r][j]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // bias, relu, folded BN, in place; frames outside [0, T) stay zero
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = lane + 32 * j;
      if (col < h) {
        const float bb = bias[s * h + col], sc = bns[s * h + col], sh = bnt[s * h + col];
        float* sr = sp_s + col * RP;
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          if (p < np) {
#pragma unroll
            for (int r = 0; r < kFrames; ++r) {
              const int row = lo + p * kPassRows + warp * kFrames + r;
              if (row < hi) {
                const int t = t0 - halo + row;
                const float z = fmaxf(acc[p][r][j] + bb, 0.f) * sc + sh;
                sr[row] = (t >= 0 && t < Tn) ? z : 0.f;
              }
            }
          }
        }
      }
    }
    __syncthreads();

    // this stage's output for the tile's own frames; then the next state
    const bool last = s == n - 1;
    for (int o = warp; o < h; o += kWarps) {
      const T* xn = xb + (size_t)((s + 2) * h + o) * Tn;  // part s+2, read unless last
      T* og = ob + (size_t)((s + 1) * h + o) * Tn;
      float* sr = sp_s + o * RP;
      for (int row = lo + lane; row < hi; row += 32) {
        const int t = t0 - halo + row;
        const float v = sr[row];
        if (t >= t0 && t < t0 + tt_n) og[t] = from_f32<T>(v);
        if (!last) sr[row] = (t >= 0 && t < Tn) ? round_to<T>(v + to_f32(xn[t])) : 0.f;
      }
    }
    // the next stage's first barrier orders these writes before its reads
  }
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Ask for a line of device memory to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

constexpr int kTiles = 3;                           // 16-frame tiles per warp
constexpr int kMmaRows = 16 * kTiles * kWarps / 2;  // 192: 4 warp pairs x 3 tiles
constexpr int kLoadWarps = 4;                       // warps that fetch the next part meanwhile
constexpr int kMmaWarps = kWarps + kLoadWarps;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kLaneRows = kMmaRows / 32;            // rows a lane takes in a pass along T
constexpr int kGroup = 4;                           // channels whose loads are issued together

// bf16 x on the tensor cores. grid (tiles, B), 12 warps: 8 multiply, 4
// fetch. NT = h / 16: n8 tiles in one half of the output channels. wt is
// [n][h out][3h] (tap-major, then input channel, contiguous).
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 1) res2_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ bns, const float* __restrict__ bnt,
    __nv_bfloat16* __restrict__ out, int Tn, int n, int d, int TT, int RP) {
  typedef __nv_bfloat16 bf16;
  constexpr int h = 16 * NT;
  constexpr int SA = h + 8;      // state row stride (bf16): +16 bytes, conflict-free fragments
  constexpr int SW = 3 * h + 8;  // weight row stride (bf16)
  constexpr int SZ = h + 1;      // stage result row stride (f32)
  constexpr int kWzBytes = 2 * h * SW > 4 * kMmaRows * SZ ? 2 * h * SW : 4 * kMmaRows * SZ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sp_s = reinterpret_cast<bf16*>(smem_raw);   // [RP][SA] chain state, rounded to bf16
  bf16* w_s = sp_s + (size_t)RP * SA;                // [h][SW] the stage's weights
  float* z_s = reinterpret_cast<float*>(w_s);        // [192][SZ] the stage's result, same memory
  bf16* p_s = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(w_s) + kWzBytes);
                                                     // [h][192] the part added at the stage's end
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tt_n = min(TT, Tn - t0);
  const int halo = n * d;
  const int R = TT + 2 * halo;  // window rows: row r is frame t0 - halo + r
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;       // fragment coordinates
  const int nh = warp & 1, mt0 = warp >> 1;     // channel half; first frame tile (warps 0..7)
  const bf16* xb = x + (size_t)b * (n + 1) * h * Tn;
  bf16* ob = out + (size_t)b * (n + 1) * h * Tn;

  // group 0 passes through
  for (int o = warp; o < h; o += kMmaWarps) {
    const bf16* src = xb + (size_t)o * Tn + t0;
    bf16* dst = ob + (size_t)o * Tn + t0;
    for (int r = lane; r < tt_n; r += 32) dst[r] = src[r];
  }
  // stage 0 reads part 1 over the whole window; zero outside [0, T) and in
  // the spare rows
  for (int o = warp; o < h; o += kMmaWarps) {
    const bf16* xr = xb + (size_t)(h + o) * Tn;
    for (int r = lane; r < RP; r += 32) {
      const int t = t0 - halo + r;
      sp_s[r * SA + o] = (r < R && t >= 0 && t < Tn) ? xr[t] : __float2bfloat16_rn(0.f);
    }
  }

  for (int s = 0; s < n; ++s) {
    const int lo = (s + 1) * d, hi = R - (s + 1) * d;  // rows this stage computes
    const int n_tiles = (hi - lo + 15) / 16;           // <= 12
    const bool last = s == n - 1;
    if (!last) {
      // part s+2 is added at this stage's end: start it on its way from
      // device memory now (at most 384 bytes a channel: four 128-byte lines)
      const int ta = max(t0 - halo + lo, 0), tb = min(t0 - halo + hi, Tn);
      for (int idx = tid; idx < 4 * h && tb > ta; idx += kMmaThreads) {
        const int o = idx >> 2, line = idx & 3;
        prefetch_l2(xb + (size_t)((s + 2) * h + o) * Tn + ta + min(64 * line, tb - ta - 1));
      }
    }
    __syncthreads();  // the state is written; the last stage's result and part are consumed
    {
      const uint4* src = reinterpret_cast<const uint4*>(wt + (size_t)s * h * 3 * h);
      constexpr int kRowVecs = 3 * h / 8;  // 16-byte vectors in a weight row
      for (int idx = tid; idx < h * kRowVecs; idx += kMmaThreads) {
        const int o = idx / kRowVecs, v = idx - o * kRowVecs;
        *reinterpret_cast<uint4*>(w_s + o * SW + 8 * v) = src[idx];
      }
    }
    __syncthreads();

    float acc[kTiles][NT][4];
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

    if (warp >= kWarps) {
      // the fetching warps: part s+2 over the rows [lo, hi) into p_s, while
      // the others multiply. A warp takes every fourth channel, a lane the
      // rows lane, lane + 32, ...; four channels' loads are issued together.
      for (int o0 = warp - kWarps; o0 < h && !last; o0 += kLoadWarps * kGroup) {
        bf16 pv[kGroup][kLaneRows];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int o = o0 + kLoadWarps * q;
          const bf16* xn = xb + (size_t)((s + 2) * h + o) * Tn;
#pragma unroll
          for (int i = 0; i < kLaneRows; ++i) {
            const int row = lo + lane + 32 * i;
            const int t = t0 - halo + row;
            const bool want = o < h && row < hi && t >= 0 && t < Tn;
            pv[q][i] = want ? xn[t] : __float2bfloat16_rn(0.f);
          }
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int o = o0 + kLoadWarps * q;
#pragma unroll
          for (int i = 0; i < kLaneRows; ++i)
            if (o < h) p_s[o * kMmaRows + lane + 32 * i] = pv[q][i];
        }
      }
    } else {
      for (int tap = 0; tap < 3; ++tap) {
        const bf16* a_tap = sp_s + (lo + (tap - 1) * d + g) * SA + 2 * tg;
        const bf16* b_tap = w_s + (nh * (h / 2) + g) * SW + tap * h + 2 * tg;
#pragma unroll 2
        for (int ci = 0; ci < h; ci += 16) {
          uint32_t bfrag[NT][2];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const bf16* wp = b_tap + 8 * j * SW + ci;
            bfrag[j][0] = *reinterpret_cast<const uint32_t*>(wp);
            bfrag[j][1] = *reinterpret_cast<const uint32_t*>(wp + 8);
          }
#pragma unroll
          for (int u = 0; u < kTiles; ++u) {
            const int mt = mt0 + 4 * u;
            if (mt < n_tiles) {
              const bf16* ap = a_tap + 16 * mt * SA + ci;
              uint32_t afrag[4];
              afrag[0] = *reinterpret_cast<const uint32_t*>(ap);
              afrag[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * SA);
              afrag[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
              afrag[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * SA + 8);
#pragma unroll
              for (int j = 0; j < NT; ++j) mma_bf16_16816(acc[u][j], afrag, bfrag[j]);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of the state and of the weights is done

    // bias, relu, folded BN into the f32 staging area (rows relative to lo)
    if (warp < kWarps) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = nh * (h / 2) + 8 * j + 2 * tg;
        const float b0 = bias[s * h + col], b1 = bias[s * h + col + 1];
        const float s0 = bns[s * h + col], s1 = bns[s * h + col + 1];
        const float h0 = bnt[s * h + col], h1 = bnt[s * h + col + 1];
#pragma unroll
        for (int u = 0; u < kTiles; ++u) {
          const int mt = mt0 + 4 * u;
          if (mt < n_tiles) {
            float* zr = z_s + (16 * mt + g) * SZ + col;
            zr[0] = fmaxf(acc[u][j][0] + b0, 0.f) * s0 + h0;
            zr[1] = fmaxf(acc[u][j][1] + b1, 0.f) * s1 + h1;
            zr[8 * SZ] = fmaxf(acc[u][j][2] + b0, 0.f) * s0 + h0;
            zr[8 * SZ + 1] = fmaxf(acc[u][j][3] + b1, 0.f) * s1 + h1;
          }
        }
      }
    }
    __syncthreads();

    // this stage's output for the tile's own frames; then the next state.
    // Frames outside [0, T) become zero: the next stage's zero padding.
    for (int o = warp; o < h; o += kMmaWarps) {
      bf16* og = ob + (size_t)((s + 1) * h + o) * Tn;
      for (int row = lo + lane; row < hi; row += 32) {
        const int t = t0 - halo + row;
        const float v = z_s[(row - lo) * SZ + o];
        if (t >= t0 && t < t0 + tt_n) og[t] = __float2bfloat16_rn(v);
        if (!last) {
          const float next = v + __bfloat162float(p_s[o * kMmaRows + row - lo]);
          sp_s[row * SA + o] = __float2bfloat16_rn((t >= 0 && t < Tn) ? next : 0.f);
        }
      }
    }
  }
}

template <int NT>
int launch_mma(const void* x, const void* wt, const void* bias, const void* bns, const void* bnt,
               void* out, int B, int Tn, int n, int d, int TT, int tiles, int RP, int smem,
               cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(res2_mma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  res2_mma_kernel<NT><<<dim3(tiles, B), kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(bns),
      static_cast<const float*>(bnt), static_cast<__nv_bfloat16*>(out), Tn, n, d, TT, RP);
  return (int)cudaGetLastError();
}

template <typename T, int TC>
int launch_tc(const T* x, const T* w, const float* bias, const float* bns, const float* bnt,
              T* out, int B, int Tn, int h, int n, int d, int TT, int tiles, int RP, int smem,
              cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(res2_kernel<T, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  res2_kernel<T, TC><<<dim3(tiles, B), kThreads, smem, st>>>(x, w, bias, bns, bnt, out, Tn, h, n,
                                                             d, TT, RP);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* wv, const void* bias, const void* bns, const void* bnt,
           void* outv, int B, int Tn, int h, int n, int d, int TT, int tiles, int RP, int smem,
           cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(bns);
  const float* t = static_cast<const float*>(bnt);
  T* out = static_cast<T*>(outv);
  if (h <= 32) return launch_tc<T, 1>(x, w, b, s, t, out, B, Tn, h, n, d, TT, tiles, RP, smem, st);
  if (h <= 64) return launch_tc<T, 2>(x, w, b, s, t, out, B, Tn, h, n, d, TT, tiles, RP, smem, st);
  return launch_tc<T, 4>(x, w, b, s, t, out, B, Tn, h, n, d, TT, tiles, RP, smem, st);
}

}  // namespace

extern "C" {

// x, out [B, (n+1)h, T] (bf16 when bf16 != 0, else f32); bias, bns, bnt
// [n, h] f32. TT frames per tile, tiles = ceil(T / TT), TT + 2(n-1)d <= 192;
// RP >= (n+1)d + 192: rows of the shared-memory state.
// tensor == 0, the CUDA-core kernel: w [n, 3h, h] in x's type (rows:
// tap-major, then input channel), h <= 128, smem = 4 (h RP + 32 h) bytes.
// tensor != 0, the tensor-core kernel: bf16 only, h in {16, 32, 64, 128},
// w [n, h, 3h] (each output channel's taps contiguous), smem =
// 2 RP (h + 8) + max(2 h (3h + 8), 4 * 192 (h + 1)) + 2 * 192 h bytes.
// Returns the first CUDA error, or 0.
int asv_res2_chain_launch(const void* x, const void* w, const void* bias, const void* bns,
                          const void* bnt, void* out, int B, int T, int h, int n, int d, int TT,
                          int tiles, int RP, int smem, int bf16, int tensor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static_assert(kMmaRows == kPasses * kPassRows, "both kernels compute 192 rows a stage");
  if (B < 1 || B > 65535 || T < 1 || h < 1 || h > 128 || n < 1 || d < 1 || TT < 1 ||
      TT + 2 * (n - 1) * d > kPasses * kPassRows || RP < (n + 1) * d + kPasses * kPassRows ||
      (long long)tiles * TT < T)
    return (int)cudaErrorInvalidValue;
  if (tensor) {
    if (!bf16) return (int)cudaErrorInvalidValue;
    switch (h) {
      case 16: return launch_mma<1>(x, w, bias, bns, bnt, out, B, T, n, d, TT, tiles, RP, smem, st);
      case 32: return launch_mma<2>(x, w, bias, bns, bnt, out, B, T, n, d, TT, tiles, RP, smem, st);
      case 64: return launch_mma<4>(x, w, bias, bns, bnt, out, B, T, n, d, TT, tiles, RP, smem, st);
      case 128: return launch_mma<8>(x, w, bias, bns, bnt, out, B, T, n, d, TT, tiles, RP, smem, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (bf16)
    return launch<__nv_bfloat16>(x, w, bias, bns, bnt, out, B, T, h, n, d, TT, tiles, RP, smem, st);
  return launch<float>(x, w, bias, bns, bnt, out, B, T, h, n, d, TT, tiles, RP, smem, st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
