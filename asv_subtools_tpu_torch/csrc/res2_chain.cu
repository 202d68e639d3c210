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
// recomputes the halo, which shrinks by d a side each stage. The chain
// state lives in shared memory, already rounded to the operand type, and
// is updated in place after one barrier, each thread holding its output
// rows' sums in registers for the whole stage. Frames outside [0, T) are
// written back as zero after every stage, on both sides: they are the
// conv's zero padding for the next stage, though relu(bias) * scale +
// shift is not zero there.
//
// Two kernels share this scheme.
//
// res2_kernel runs the products on the CUDA cores (f32 FMA; a product of
// two bf16 values is exact in f32): it serves f32 x, where operands and
// state must stay f32, and any h <= 128. Its state is [h][rows] f32 (time
// contiguous, as x is in memory), a stage's weights stream through shared
// memory in 32-row chunks, and a thread owns up to 3 x 8 frames x h/32
// output channels.
//
// res2_mma_kernel serves bf16 x with h in {16, 32, 64, 128} on the tensor
// cores (mma.sync.m16n8k16, bf16 operands, f32 sums, fragments by
// ldmatrix), 16 warps (8 at h = 16): the output channels in 4 groups (2),
// a stage's 192 rows in 12 tiles of 16 frames, a warp one group and the
// tiles w / G, + 4, + 8, all sums in registers (101 registers a thread at
// h = 128; the 8-warp layout of halves read 0.81 against 0.67 ms).
// What it answers to:
//  - Weights. Each tap's weights, [h out][h in + 8] (32 KB at h = 128,
//    rows padded by the launcher so that ldmatrix reads without bank
//    conflicts), are one cp.async.bulk into a ring of two slots on
//    mbarriers: thread 0 requests tap q + 1 when tap q starts, once every
//    warp has released its slot, so the weights arrive while the products
//    run. No copy sits between two barriers.
//  - Parts. The part a stage adds at its end is brought in at the stage's
//    start by cp.async into a [h][SP] buffer, in the order it lies in
//    memory (time contiguous), and waited for only after the products.
//    Not by the bulk copy or TMA: at T = 998 a channel's row starts 1996
//    bytes after the last, not on the 16 bytes both require; 4-byte
//    copies from an even frame take it (2-byte loads when T is odd). Part
//    1's window comes the same way and is transposed into the state
//    [rows][h + 8] once, in shared memory.
//  - The stage's end. The warps add bias, relu and the folded BN to their
//    sums, write the next state (z + part, in bf16) in place and store z
//    of the tile's own frames straight from the registers: 8 lanes write
//    16 contiguous bytes of a channel's row. (Staged through shared memory
//    and sent along T as 4-byte pairs of frames after a barrier, it read
//    0.654 against 0.629 ms; 16-byte vectors along T need 16-byte row
//    starts, which T = 998 does not give.) Group 0 moves as 16-byte
//    vectors, the tiles of a batch row splitting its [h, T] block.
//  - Products: mma.sync, not wgmma. At the served shape they are 88 GFLOP,
//    under 0.15 ms at mma.sync's rate; a 64-row wgmma tile over a
//    warpgroup would need the state as a descriptor-described operand,
//    whose rows move by d at each tap.
//  - Shared memory: the state (57-83 KB at h = 128 for dilation 2-14), the
//    ring (70 KB) and the part buffer (51-68 KB) keep one block on an SM.
// What bounds it now (variants with one statement switched off, on an
// H100, d = 4, before the outputs left from the registers): the output
// stores about 0.17 ms of 0.61, the parts' copies 0.07, the products 0.05;
// the rest is the stage's barriers and the halo's recomputed rows.
//
// Data layout: x and out are [B, C, T] in memory (time contiguous), the
// layout the port's model holds, so the model pays no transpose.
//
// Cost of the tiling: with n = 7, the block's 192 rows give TT <= 192 - 12 d
// (168, 144, 144 frames at d = 2, 3, 4, even); a stage computes its rows in
// tiles of 16, so every stage of a full tile costs 192 computed frames for
// TT written, 1.14x to 1.33x the least work, and the input window is read
// (TT + 14 d) / TT times.
//
// Bound on an H100 SXM at x [128, 998, 1024] bf16, h = 128: bytes. x in and
// out 2 x 261.6 MB + 0.7 MB of weights -> 156 us at 3.35 TB/s; the products
// are 2 * 127,744 * 7 * 384 * 128 = 87.9 GFLOP -> 89 us at 989 TFLOP/s
// (bf16 tensor cores), 1.3 ms at the CUDA cores' 67 TFLOP/s.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_plan.h"
#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = 8;                   // frames per thread and pass
constexpr int kPassRows = kWarps * kFrames;  // 64
constexpr int kPasses = 3;                   // 192 rows per stage at most
constexpr int kKC = asv_plan::kRes2KC;       // weight rows per shared-memory chunk

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

constexpr int kTiles = 3;                           // 16-frame tiles per warp
constexpr int kMmaRows = 16 * kTiles * 4;  // 192: 4 rows of warps x 3 tiles
constexpr int kSlots = asv_plan::kRes2Slots;        // weight ring slots
static_assert(kMmaRows == kPasses * kPassRows && kMmaRows == asv_plan::kRes2Rows,
              "both kernels compute the plan's rows a stage");

// Channel groups of res2_mma_kernel: the output channels are split in G
// groups and a stage's 12 frame tiles in 4 rows of 3, one warp each.
__host__ __device__ constexpr int mma_groups(int NT) { return NT >= 2 ? 4 : 2; }

// bf16 x on the tensor cores. grid (tiles, B), 4 G warps: warp w takes the
// output channels of group w % G and the frame tiles w / G, + 4, + 8 of a
// stage's 192 rows. wt is [n][3][h out][h in + 8] (the taps' weights, rows
// padded by 16 bytes, zero). EVEN: T is even and x 4-byte aligned.
template <int NT, bool EVEN>
__global__ void __launch_bounds__(128 * mma_groups(NT), 1) res2_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, const float* __restrict__ bns, const float* __restrict__ bnt,
    __nv_bfloat16* __restrict__ out, int Tn, int n, int d, int TT, int RP, int SP) {
  typedef __nv_bfloat16 bf16;
  constexpr int h = 16 * NT;
  constexpr int G = mma_groups(NT);       // channel groups
  constexpr int NTG = 2 * NT / G;         // n8 tiles of a group
  constexpr int kW = 4 * G, kT = 32 * kW; // warps, threads
  constexpr int SA = h + 8;               // state and weight row stride (bf16)
  constexpr int kChunk = 2 * h * SA;      // bytes of one tap's weights
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const asv_plan::MmaLayout lay = asv_plan::res2_mma_layout(h, RP, SP);
  bf16* sp_s = reinterpret_cast<bf16*>(smem_raw);  // [RP][SA]: row r is frame t0 - halo + r
  unsigned char* ring = smem_raw + lay.ring;
  bf16* p_s = reinterpret_cast<bf16*>(smem_raw + lay.part);  // [h][SP]: col j is frame ta + j
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kSlots);
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tt_n = min(TT, Tn - t0);
  const int halo = n * d;
  const int R = TT + 2 * halo;  // window rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;     // fragment coordinates
  const int grp = warp % G, mt0 = warp / G;   // channel group; first frame tile
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8, lcol = (lane >> 4) * 8;  // ldmatrix
  const size_t row_elems = (size_t)(n + 1) * h * Tn;
  const bf16* xb = x + (size_t)b * row_elems;
  bf16* ob = out + (size_t)b * row_elems;
  const int n_chunks = 3 * n;

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full0 + 8 * i, 1);        // the requesting thread's arrive; the bytes ride on it
      mbar_init(empty0 + 8 * i, kW);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: tap chunk q (stage q / 3, tap q % 3) into slot q % kSlots once
  // every warp has released what was there
  auto request = [&](int q) {
    if (q >= n_chunks) return;
    const uint32_t slot = q % kSlots, phase = (q / kSlots) & 1;
    mbar_wait(empty0 + 8 * slot, phase ^ 1u);  // first pass: free at once
    mbar_arrive_expect_tx(full0 + 8 * slot, kChunk);
    bulk_copy(smem_u32(ring + slot * kChunk), reinterpret_cast<const unsigned char*>(wt) + (size_t)q * kChunk,
              kChunk, full0 + 8 * slot);
  };
  if (tid == 0) request(0);

  // frames [ta, ta + 2 * words) of channel rows into p_s by 4-byte copies
  // (EVEN), zero outside [0, T); ta even
  auto fetch_part = [&](const bf16* src, int ta, int frames) {
    // a warp a channel row at a time, its lanes along T
    if (EVEN) {
      const int words = (frames + 1) / 2;
      for (int o = warp; o < h; o += kW) {
        const bf16* row = src + (size_t)o * Tn;
        const uint32_t dst = smem_u32(p_s + o * SP);
        for (int w = lane; w < words; w += 32) {
          const int t = ta + 2 * w;
          const bool ok = t >= 0 && t < Tn;
          cp_async4(dst + 4 * w, ok ? row + t : src, ok ? 4u : 0u);
        }
      }
    } else {
      for (int o = warp; o < h; o += kW) {
        const bf16* row = src + (size_t)o * Tn;
        for (int j = lane; j < frames; j += 32) {
          const int t = ta + j;
          p_s[o * SP + j] = (t >= 0 && t < Tn) ? row[t] : __float2bfloat16_rn(0.f);
        }
      }
    }
    cp_async_commit();
  };

  // part 1 over the whole window, then transposed into the state
  const int wa = (t0 - halo) & ~1;  // even start of the window's copy
  fetch_part(xb + (size_t)h * Tn, wa, R + (t0 - halo - wa));
  // group 0 passes through: the tiles of a batch row split its [h, T] block
  {
    const size_t elems = (size_t)h * Tn;
    const size_t lo = elems * blockIdx.x / gridDim.x, hi = elems * (blockIdx.x + 1) / gridDim.x;
    const bool vec = ((reinterpret_cast<uintptr_t>(xb) | reinterpret_cast<uintptr_t>(ob)) & 15) == 0;
    size_t i = lo;
    if (vec) {
      const size_t va = (lo + 7) / 8, vb = hi / 8;  // whole 16-byte vectors inside [lo, hi)
      for (size_t v = va + tid; v < vb; v += kT)
        reinterpret_cast<uint4*>(ob)[v] = __ldg(reinterpret_cast<const uint4*>(xb) + v);
      const size_t head_end = hi < 8 * va ? hi : 8 * va;
      for (size_t e = lo + tid; e < head_end; e += kT) ob[e] = xb[e];
      i = 8 * vb > lo ? 8 * vb : lo;
    }
    for (size_t e = i + tid; e < hi; e += kT) ob[e] = xb[e];
  }
  cp_async_wait<0>();
  __syncthreads();
  {
    // a warp moves 8 rows x 4 channel pairs at a time: conflict-free reads
    // of p_s and writes of the state. Rows past the window are zero.
    const int n_rb = (RP + 7) / 8, groups = n_rb * (h / 8);
    for (int gi = warp; gi < groups; gi += kW) {
      const int r = (gi % n_rb) * 8 + (lane & 7), o = 2 * ((gi / n_rb) * 4 + (lane >> 3));
      if (r >= RP) continue;
      const int j = r + (t0 - halo - wa);
      __nv_bfloat162 pr;
      pr.x = r < R ? p_s[o * SP + j] : __float2bfloat16_rn(0.f);
      pr.y = r < R ? p_s[(o + 1) * SP + j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<__nv_bfloat162*>(sp_s + r * SA + o) = pr;
    }
  }

  for (int s = 0; s < n; ++s) {
    const int lo = (s + 1) * d, hi = R - (s + 1) * d;  // rows this stage computes
    const int n_tiles = (hi - lo + 15) / 16;           // <= 12
    const bool last = s == n - 1;
    const int ta = (t0 - halo + lo) & ~1;              // even start of the part's copy
    __syncthreads();  // the state is written; p_s is free (the last output went out)
    if (!last) fetch_part(xb + (size_t)(s + 2) * h * Tn, ta, (hi - lo) + (t0 - halo + lo - ta));

    float acc[kTiles][NTG][4];
#pragma unroll
    for (int u = 0; u < kTiles; ++u)
#pragma unroll
      for (int j = 0; j < NTG; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

    for (int tap = 0; tap < 3; ++tap) {
      const int q = 3 * s + tap;
      if (tid == 0) request(q + 1);
      const uint32_t slot = q % kSlots;
      mbar_wait(full0 + 8 * slot, (q / kSlots) & 1);
      const uint32_t a_tap = smem_u32(sp_s) + 2 * ((lo + (tap - 1) * d + lrow) * SA + lcol);
      const uint32_t w_tap = smem_u32(ring + slot * kChunk);
#pragma unroll
      for (int ci = 0; ci < h; ci += 16) {
        uint32_t bfr[NTG][2];
        if (NTG == 1) {
          // one n8 tile: matrices k 0-7 and 8-15 of its 8 channels
          uint32_t r2[4];
          ldmatrix_x4(r2, w_tap + 2 * ((grp * (h / G) + (lane & 7)) * SA + ci + ((lane >> 3) & 1) * 8));
          bfr[0][0] = r2[0];
          bfr[0][1] = r2[1];
        } else {
#pragma unroll
          for (int j = 0; j + 1 < NTG; j += 2) {
            // two n8 tiles: (channels j*8.., k 0-7), (k 8-15), (channels +8, k 0-7), (k 8-15)
            uint32_t r4[4];
            ldmatrix_x4(r4, w_tap + 2 * ((grp * (h / G) + 8 * j + (lane & 7) + (lane >> 4) * 8) * SA + ci +
                                         ((lane >> 3) & 1) * 8));
            bfr[j][0] = r4[0];
            bfr[j][1] = r4[1];
            bfr[j + 1][0] = r4[2];
            bfr[j + 1][1] = r4[3];
          }
        }
#pragma unroll
        for (int u = 0; u < kTiles; ++u) {
          const int mt = mt0 + 4 * u;
          if (mt < n_tiles) {
            uint32_t afr[4];
            ldmatrix_x4(afr, a_tap + 2 * (16 * mt * SA + ci));
#pragma unroll
            for (int j = 0; j < NTG; ++j) mma_bf16_16816(acc[u][j], afr, bfr[j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    }
    cp_async_wait<0>();
    __syncthreads();  // every read of the state is done; the part has landed

    // bias, relu, folded BN; frames outside [0, T) are zero (the next
    // stage's padding). The next state is z + part, in place; z of the
    // tile's own frames goes out from the registers (8 lanes store 16
    // contiguous bytes of a channel's row), with no barrier before the
    // next stage's products
#pragma unroll
    for (int j = 0; j < NTG; ++j) {
      const int col = grp * (h / G) + 8 * j + 2 * tg;
      const float b0 = bias[s * h + col], b1 = bias[s * h + col + 1];
      const float s0 = bns[s * h + col], s1 = bns[s * h + col + 1];
      const float h0 = bnt[s * h + col], h1 = bnt[s * h + col + 1];
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        const int mt = mt0 + 4 * u;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = lo + 16 * mt + g + 8 * hf;
          if (mt < n_tiles && row < hi) {
            const int t = t0 - halo + row;
            const bool in = t >= 0 && t < Tn;
            const float z0 = in ? fmaxf(acc[u][j][2 * hf] + b0, 0.f) * s0 + h0 : 0.f;
            const float z1 = in ? fmaxf(acc[u][j][2 * hf + 1] + b1, 0.f) * s1 + h1 : 0.f;
            if (!last) {
              const bf16* p0 = p_s + col * SP + (t - ta);
              __nv_bfloat162 nx;
              nx.x = __float2bfloat16_rn(z0 + __bfloat162float(p0[0]));
              nx.y = __float2bfloat16_rn(z1 + __bfloat162float(p0[SP]));
              *reinterpret_cast<__nv_bfloat162*>(sp_s + row * SA + col) = nx;
            }
            if (t >= t0 && t < t0 + tt_n) {
              bf16* og = ob + ((size_t)(s + 1) * h + col) * Tn + t;
              og[0] = __float2bfloat16_rn(z0);
              og[Tn] = __float2bfloat16_rn(z1);
            }
          }
        }
      }
    }
  }
}

template <int NT, bool EVEN>
int launch_mma(const void* x, const void* wt, const void* bias, const void* bns, const void* bnt,
               void* out, int B, int Tn, int n, int d, const asv_plan::Res2Plan& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(res2_mma_kernel<NT, EVEN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  res2_mma_kernel<NT, EVEN><<<dim3(p.tiles, B), 128 * mma_groups(NT), p.smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
      static_cast<const float*>(bias), static_cast<const float*>(bns),
      static_cast<const float*>(bnt), static_cast<__nv_bfloat16*>(out), Tn, n, d, p.tt, (int)p.rp, (int)p.sp);
  return (int)cudaGetLastError();
}

// The weights [n, 3, h in, h out] into the workspace as [n, 3, h out, h in
// + 8] (each tap's weights one bulk copy, rows padded by 16 bytes), then the
// kernel; bf16 x, h = 16 NT.
template <int NT>
int launch_mma_any(const void* x, const void* w, const void* bias, const void* bns, const void* bnt,
                   void* out, void* work, int B, int Tn, int n, int d, const asv_plan::Res2Plan& p,
                   cudaStream_t st) {
  constexpr int h = 16 * NT;
  const int rc = padded_transpose<uint16_t>(w, work, 3 * n, h, h, h, h + 8, st);
  if (rc != 0) return rc;
  // the parts come as 4-byte pairs of frames where T is even and x 4-byte aligned
  const bool even = Tn % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  return even ? launch_mma<NT, true>(x, work, bias, bns, bnt, out, B, Tn, n, d, p, st)
              : launch_mma<NT, false>(x, work, bias, bns, bnt, out, B, Tn, n, d, p, st);
}

template <typename T, int TC>
int launch_tc(const T* x, const T* w, const float* bias, const float* bns, const float* bnt,
              T* out, int B, int Tn, int h, int n, int d, const asv_plan::Res2Plan& p, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(res2_kernel<T, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  res2_kernel<T, TC><<<dim3(p.tiles, B), kThreads, p.smem, st>>>(x, w, bias, bns, bnt, out, Tn, h, n,
                                                                 d, p.tt, (int)p.rp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xv, const void* wv, const void* bias, const void* bns, const void* bnt,
           void* outv, int B, int Tn, int h, int n, int d, const asv_plan::Res2Plan& p, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(bns);
  const float* t = static_cast<const float*>(bnt);
  T* out = static_cast<T*>(outv);
  if (h <= 32) return launch_tc<T, 1>(x, w, b, s, t, out, B, Tn, h, n, d, p, st);
  if (h <= 64) return launch_tc<T, 2>(x, w, b, s, t, out, B, Tn, h, n, d, p, st);
  return launch_tc<T, 4>(x, w, b, s, t, out, B, Tn, h, n, d, p, st);
}

}  // namespace

extern "C" {

// The C interface is declared, and its arguments described, in launch_plan.h.
int asv_res2_chain_workspace_bytes(int B, int T, int h, int n, int d, int bf16, long long* bytes) {
  asv_plan::Res2Plan p;
  if (!asv_plan::res2_plan(B, T, h, n, d, bf16, &p)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)p.bytes;
  return 0;
}

int asv_res2_chain_launch(const void* x, const void* w, const void* bias, const void* bns,
                          const void* bnt, void* out, void* work, int B, int T, int h, int n, int d,
                          int bf16, int* route, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  asv_plan::Res2Plan p;
  if (!asv_plan::res2_plan(B, T, h, n, d, bf16, &p)) return (int)cudaErrorInvalidValue;
  if (route != nullptr) *route = p.tensor;
  if (p.tensor) {
    switch (h) {
      case 16: return launch_mma_any<1>(x, w, bias, bns, bnt, out, work, B, T, n, d, p, st);
      case 32: return launch_mma_any<2>(x, w, bias, bns, bnt, out, work, B, T, n, d, p, st);
      case 64: return launch_mma_any<4>(x, w, bias, bns, bnt, out, work, B, T, n, d, p, st);
      case 128: return launch_mma_any<8>(x, w, bias, bns, bnt, out, work, B, T, n, d, p, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (bf16) return launch<__nv_bfloat16>(x, w, bias, bns, bnt, out, B, T, h, n, d, p, st);
  return launch<float>(x, w, bias, bns, bnt, out, B, T, h, n, d, p, st);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
