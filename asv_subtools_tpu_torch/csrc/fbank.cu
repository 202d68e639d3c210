// Fused Kaldi log-mel fbank for Hopper (sm_90a): framing, DC removal,
// preemphasis, window, DFT, power, mel and log in one kernel.
//
// Replaces: asv_subtools_tpu/features/pallas_fbank.py `fused_fbank`
// (pallas_call at :283, body `_kernel` at :139). Semantics are those of
// compute_fbank at dither=0, snip_edges=True.
//
// Window processing is linear, so the host folds DC removal, preemphasis
// and the window into one effective DFT matrix
// eff = (M0 D A diag(win)) @ [C | S], shape [window, 2*256], rows past the
// window zero (asv_subtools_tpu_torch/features/fused_fbank.py, as
// pallas_fbank.py:103-124 does). A block takes one batch row and a tile of
// 64 frames and frames straight from the waveform span it holds in shared
// memory: frame f is span[f*shift : f*shift + window], a view, never a copy.
// The DFT is then a [64, window] @ [window, 512] product, followed by the
// power, the mel product over each filter's band of non-zero weights (f32,
// CUDA cores: 0.13 GFLOP against the DFT's 52 at the served shape) and the
// log. The ragged tail is masked here: the kernel writes exactly [B, T, nb].
//
// Bound on an H100 SXM at [128, 160000] -> [128, 998, 80], bf16 mode: the
// DFT is 2*127,744*400*512 = 52.3 GFLOP; 82 MB read + 41 MB written. At 989
// TFLOP/s (bf16 tensor-core peak) that is 53 us; at 3.35 TB/s, 37 us. So
// operations bound it, and only the tensor cores come near.
//
// Two kernels:
//
// fbank_mma_kernel, the bf16 mode (the serving setting) on the tensor
// cores. It keeps the TPU kernel's rounding points (pallas_fbank.py:179-199):
// samples and folded matrix rounded to bf16, sums in f32, power, mel and log
// in f32. What the design answers to:
//  - The product runs as mma.sync.m16n8k16 (bf16 operands, f32 sums). wgmma
//    was not taken: its shared-memory descriptor cannot describe A's
//    overlapping rows (a core matrix wants its 8 rows 16 bytes apart, a
//    frame's rows are `shift` samples apart), so A would come from registers
//    through the same ldmatrix loads as here, and products that run
//    asynchronously gain little while those loads set the pace; mma.sync
//    keeps the kernel simple.
//  - The register file sets the tile: 64 frames x 512 columns of f32 sums
//    are 128 registers a thread over 8 warps. A warp owns all 64 frames and
//    64 columns, so an A fragment (ldmatrix.x4 from the span) feeds 8
//    products and a B fragment 4.
//  - The span is held once in bf16, in 16-byte pieces. A frame's rows are
//    shift/8 pieces apart; when that is even, eight frames' rows would fall
//    on two bank groups, so one spare piece is laid after every shift/8
//    pieces and the stride becomes odd: ldmatrix reads without conflicts.
//  - Re and im of a bin in one thread: the host orders the matrix's columns
//    as (cos c, sin c) pairs, so the accumulator fragment that holds re of
//    (frame, bin) holds im beside it; the power is taken in registers and
//    only the power tile goes to shared memory.
//  - The matrix (416 x 512 bf16 = 426 KB) does not fit beside the rest. The
//    host lays it out in the order the fragments are read (k-step, warp,
//    quarter, lane), so a chunk of 32 rows is 32 KB of contiguous memory and
//    one cp.async.bulk brings it from L2 into a three-stage ring, completion
//    on mbarriers; a lane's B fragments are then 16-byte loads without
//    conflicts. One thread requests chunk q + 2 when chunk q starts, into the
//    stage every warp has released. No warp is set aside for it: a ninth
//    warp would cap all at 168 registers a thread (three warps a scheduler),
//    and 128 of them hold sums. The grid is persistent (one block an SM, the
//    wrapper passes the count), so the ring runs on across a block's tiles.
//  - The next tile's f32 samples arrive by one bulk copy during this tile's
//    products, into the region that later holds the power tile; they are
//    rounded to bf16 into the span after the last product has read it.
//  - The power tile is held [bin][frame] with a row stride of 72 floats: the
//    fragments' writes fall on 32 banks, and so do the mel phase's reads,
//    where a warp takes 32 frames (a lane each) and four neighbouring
//    filters. With two warps a scheduler only a thread's own independent
//    loads hide latency, so the four filters' sums advance together. (A
//    lane a filter would put the wide high filters' bands 8 banks apart.)
//  - The raw log-energy (f32 sums over the unrounded samples) reads the
//    waveform from device memory: it is not on the serving path.
// What bounds it now: the products' loop runs at about two thirds of what
// mma.sync can give with two warps a scheduler (a warp reads 4 KB of shared
// memory for every 32 products and little overlaps them), and the phases of
// a tile (products, rounding, power, mel) follow each other with the tensor
// cores idle in the last three. Streaming the matrix from L2 for every tile
// (0.87 GB a launch at the served shape) costs nothing measurable yet.
// wgmma with the sums split over two warpgroups, a second set of warps for
// the mel phase, and multicast of the matrix across a cluster are later work.
//
// fbank_kernel, the f32 mode (which must hold 2e-5 against compute_fbank)
// and bf16 geometries the tensor-core kernel does not take (a frame shift
// that is not a multiple of 8): the product as f32 FMAs on the CUDA cores.
// Each thread keeps 8 frames x 8 bins of [re | im] in registers (128 f32
// accumulators); the folded matrix streams through shared memory in chunks
// of 16 rows from L2; the power tile aliases the span and the chunk. Shared
// memory (f32 floats): max(span + 16*512, 64*256) + mel weights + 3*nb ints.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_plan.h"
#include "mma.cuh"

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


// ---------------------------------------------------------------------------
// bf16 mode on the tensor cores

constexpr int kMmaWarps = kThreads / 32;        // 8 warps, 2 a scheduler: 255 registers a thread
constexpr int kKC = 32;                         // folded-matrix rows per ring stage
constexpr int kChunkBytes = kKC * kCols * 2;    // 32 KB of bf16
constexpr int kStages = 3;
constexpr int kPT = kFrames + 8;                // power tile [bin][frame] row stride (floats):
                                                // conflict-free for the fragments' writes

// Shared memory of the tensor-core kernel, in bytes from the start:
// the matrix ring | the region (next tile's f32 samples, later the power
// tile) | the span in bf16 pieces | mel weights | mel meta | mbarriers.
struct MmaLayout {
  int pieces;      // 16-byte pieces (8 samples) in a span
  int p;           // pieces between two frames' rows (shift / 8)
  int pad;         // spare pieces after every p: 1 when p is even
  size_t region, span, melw, meta, bars, total;
};

__host__ __device__ inline MmaLayout mma_layout(int shift, int window_pad, int nb, int nnz) {
  MmaLayout l;
  const int n_span = span_len(shift, window_pad);
  l.pieces = n_span / 8;
  l.p = shift / 8;
  l.pad = (l.p & 1) ? 0 : 1;
  const size_t staging = sizeof(float) * (size_t)n_span;
  const size_t power = sizeof(float) * (size_t)kBins * kPT;
  l.region = (size_t)kStages * kChunkBytes;
  l.span = l.region + (((staging > power ? staging : power) + 15) / 16) * 16;
  l.melw = l.span + 16 * (size_t)(l.pieces + (l.pieces / l.p + 1) * l.pad);
  l.meta = l.melw + sizeof(float) * (size_t)nnz;
  l.bars = ((l.meta + sizeof(int) * 3 * (size_t)nb + 7) / 8) * 8;
  l.total = l.bars + sizeof(uint64_t) * (2 * kStages + 1);
  return l;
}

// grid: persistent blocks, block k takes tiles k, k + grid, ...; tile =
// (row b, 64 frames). effp is the folded matrix in bf16, in fragment order:
// [window_pad / 16 k-steps][8 warps][4 quarters][32 lanes][4 registers][2].
__global__ void __launch_bounds__(kThreads, 1) fbank_mma_kernel(
    const float* __restrict__ wave,      // [B, S], rows 16-byte aligned
    const unsigned char* __restrict__ effp,
    const int* __restrict__ mel_meta,    // [nb, 3]: first bin, count, offset
    const float* __restrict__ mel_w,     // [nnz] band weights
    float* __restrict__ out,             // [B, T, nb]
    float* __restrict__ energy,          // [B, T] raw log-energy, or null
    int S, int T, int shift, int window, int window_pad, int nb, int nnz,
    int use_power, int use_log, int remove_dc, int tiles_per_row, int tiles) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const MmaLayout lay = mma_layout(shift, window_pad, nb, nnz);
  unsigned char* ring = smem_raw;
  float* region = reinterpret_cast<float*>(smem_raw + lay.region);
  unsigned char* span = smem_raw + lay.span;
  float* melw_s = reinterpret_cast<float*>(smem_raw + lay.melw);
  int* meta_s = reinterpret_cast<int*>(smem_raw + lay.meta);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw + lay.bars);
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);
  const uint32_t stg_bar = smem_u32(bars + 2 * kStages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_chunks = window_pad / kKC;
  const int n_span = span_len(shift, window_pad);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);           // the requesting thread's arrive; the bytes ride on it
      mbar_init(empty0 + 8 * s, kMmaWarps);  // one arrive a warp
    }
    mbar_init(stg_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  for (int i = tid; i < nnz; i += kThreads) melw_s[i] = mel_w[i];
  for (int i = tid; i < 3 * nb; i += kThreads) meta_s[i] = mel_meta[i];
  __syncthreads();

  // thread 0 keeps the matrix ring full: chunk qi of this block's sequence
  // (its tiles one after the other, n_chunks each) goes to stage qi % kStages
  // once every warp has released what was there
  const int my_tiles = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const uint32_t total_chunks = (uint32_t)my_tiles * (uint32_t)n_chunks;
  auto request_chunk = [&](uint32_t qi) {
    const uint32_t stage = qi % kStages, phase = (qi / kStages) & 1u;
    mbar_wait(empty0 + 8 * stage, phase ^ 1u);  // first pass: free at once
    mbar_arrive_expect_tx(full0 + 8 * stage, kChunkBytes);
    bulk_copy(smem_u32(ring + (size_t)stage * kChunkBytes),
              effp + (size_t)(qi % (uint32_t)n_chunks) * kChunkBytes, kChunkBytes, full0 + 8 * stage);
  };
  if (tid == 0)
    for (uint32_t qi = 0; qi < kStages - 1 && qi < total_chunks; ++qi) request_chunk(qi);

  // thread 0: ask for a tile's f32 samples; what lies past the row's end is
  // not copied (and read as zero below)
  auto request_samples = [&](int tile) {
    const int b = tile / tiles_per_row;
    const long long start = (long long)(tile - b * tiles_per_row) * kFrames * shift;
    const long long avail = min((long long)n_span, (long long)S - start);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the region was written as the power tile
    mbar_arrive_expect_tx(stg_bar, (uint32_t)(avail * 4));
    bulk_copy(smem_u32(region), wave + (size_t)b * S + start, (uint32_t)(avail * 4), stg_bar);
  };
  // all: round the samples in the region to bf16 into the span's pieces
  auto round_into_span = [&](int tile) {
    const int b = tile / tiles_per_row;
    const long long start = (long long)(tile - b * tiles_per_row) * kFrames * shift;
    const int avail = (int)min((long long)n_span, (long long)S - start);  // a multiple of 4
    for (int j = tid; j < lay.pieces; j += kThreads) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 lo = 8 * j < avail ? *reinterpret_cast<const float4*>(region + 8 * j) : z;
      const float4 hi = 8 * j + 4 < avail ? *reinterpret_cast<const float4*>(region + 8 * j + 4) : z;
      const uint4 piece = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                                     pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
      *reinterpret_cast<uint4*>(span + 16 * (size_t)(j + (j / lay.p) * lay.pad)) = piece;
    }
  };

  const int g = lane >> 2, tg = lane & 3;   // fragment coordinates
  const int pstr = lay.p + lay.pad;         // pieces between two frames' rows in the span
  // ldmatrix: lanes 0-7 rows 0-7 of k 0-7, 8-15 rows 8-15, 16-23 rows 0-7 of k 8-15, 24-31 rows 8-15
  const int lane_frame = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lane_kp = lane >> 4;
  const uint32_t span_u32 = smem_u32(span);
  uint32_t row_off[4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) row_off[mt] = span_u32 + 16u * (uint32_t)((16 * mt + lane_frame) * pstr);

  uint32_t q = 0, stg_phase = 0;
  int tile = blockIdx.x;
  if (tile < tiles) {
    if (tid == 0) request_samples(tile);
    mbar_wait(stg_bar, stg_phase);
    stg_phase ^= 1u;
    round_into_span(tile);
    __syncthreads();
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const bool has_next = next < tiles;
    if (tid == 0 && has_next) request_samples(next);  // lands while this tile multiplies

    float acc[4][8][4];  // [16-frame tile][8-column tile][fragment]
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

    for (int c = 0; c < n_chunks; ++c, ++q) {
      // kStages - 1 chunks ahead: into the stage that the last chunk has just left
      if (tid == 0 && q + kStages - 1 < total_chunks) request_chunk(q + kStages - 1);
      __syncwarp();
      const uint32_t stage = q % kStages, phase = (q / kStages) & 1u;
      mbar_wait(full0 + 8 * stage, phase);
      const unsigned char* chunk = ring + (size_t)stage * kChunkBytes;
      uint32_t bq[kKC / 16][16];  // registers 2j, 2j+1 of a k-step: the B fragment of column tile j
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks)
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              chunk + (size_t)(((ks * kMmaWarps + warp) * 4 + j4) * 32 + lane) * 16);
          bq[ks][4 * j4] = v.x; bq[ks][4 * j4 + 1] = v.y; bq[ks][4 * j4 + 2] = v.z; bq[ks][4 * j4 + 3] = v.w;
        }
#pragma unroll
      for (int ks = 0; ks < kKC / 16; ++ks) {
        const int kp = c * (kKC / 8) + ks * 2 + lane_kp;  // this lane's piece within a frame's row
        const uint32_t k_off = 16u * (uint32_t)(kp + (kp / lay.p) * lay.pad);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t a[4];
          ldmatrix_x4(a, row_off[mt] + k_off);
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[mt][j], a, bq[ks] + 2 * j);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }
    __syncthreads();  // the span has been read for the last time
    if (has_next) {
      mbar_wait(stg_bar, stg_phase);
      stg_phase ^= 1u;
      round_into_span(next);
    }
    __syncthreads();  // the region's samples are in the span: the region is free

    // power, as [bin][frame]: this thread holds re and im of frames 16 mt + g (+ 8), bins 32 warp + 4 j + tg
    float* power = region;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p0 = acc[mt][j][0] * acc[mt][j][0] + acc[mt][j][1] * acc[mt][j][1];
        float p1 = acc[mt][j][2] * acc[mt][j][2] + acc[mt][j][3] * acc[mt][j][3];
        if (!use_power) {
          p0 = sqrtf(p0);
          p1 = sqrtf(p1);
        }
        float* pr = power + (32 * warp + 4 * j + tg) * kPT + 16 * mt + g;
        pr[0] = p0;
        pr[8] = p1;
      }
    __syncthreads();

    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * kFrames;
    // mel over each filter's band, then log. The power tile is [bin][frame]:
    // a warp takes 32 frames (a lane each) and four neighbouring filters, so
    // the bands' bounds are the same for all lanes, a weight is one broadcast
    // and the power loads fall on 32 banks. With two warps a scheduler nothing
    // hides a load's latency but the thread's own independent work: the four
    // filters' sums advance together, two band positions a step, sixteen loads
    // in flight (positions past a band's end load nothing and add zero). A
    // lane writes its four values at once.
    const int groups = (nb + 3) / 4;
    for (int item = warp; item < 2 * groups; item += kMmaWarps) {
      const int f = 32 * (item & 1) + lane, m0 = 4 * (item >> 1);
      if (t0 + 32 * (item & 1) >= T) continue;
      int lo[4], cnt[4], off[4], longest = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int m = min(m0 + u, nb - 1);
        lo[u] = meta_s[3 * m];
        cnt[u] = m0 + u < nb ? meta_s[3 * m + 1] : 0;
        off[u] = meta_s[3 * m + 2];
        longest = max(longest, cnt[u]);
      }
      float r[4] = {0.f, 0.f, 0.f, 0.f};
      for (int qq = 0; qq < longest; qq += 2) {
        float pv[4][2], wv[4][2];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool in = qq + i < cnt[u];
            pv[u][i] = in ? power[(lo[u] + qq + i) * kPT + f] : 0.f;
            wv[u][i] = in ? melw_s[off[u] + qq + i] : 0.f;
          }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          r[u] = fmaf(pv[u][0], wv[u][0], r[u]);
          r[u] = fmaf(pv[u][1], wv[u][1], r[u]);
        }
      }
      if (use_log) {
#pragma unroll
        for (int u = 0; u < 4; ++u) r[u] = logf(fmaxf(r[u], kEps));
      }
      if (t0 + f < T) {
        float* o = out + ((size_t)b * T + t0 + f) * nb + m0;
        if (nb % 4 == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(r[0], r[1], r[2], r[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (m0 + u < nb) o[u] = r[u];
        }
      }
    }
    if (energy != nullptr) {
      // raw energy over the true window, in f32 from the unrounded samples
      // (pallas_fbank.py:209-220): one warp per frame, from device memory
      for (int f = warp; f < kFrames && t0 + f < T; f += kMmaWarps) {
        const float* fr = wave + (size_t)b * S + (size_t)(t0 + f) * shift;
        float s1 = 0.f, s2 = 0.f;
        for (int n = lane; n < window; n += 32) {
          const float v = fr[n];
          s1 += v;
          s2 += v * v;
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
          const float e = remove_dc ? s2 - s1 * s1 / (float)window : s2;
          energy[(size_t)b * T + t0 + f] = logf(fmaxf(e, kEps));
        }
      }
    }
    __syncthreads();  // the power tile has been read: the region may take samples again
  }
}

}  // namespace

extern "C" {

// The shared memory a block may use (launch_plan.h), which the wrapper
// holds each kernel's geometry to.
int asv_smem_limit() { return asv_plan::kSmemLimit; }

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

// Shared memory bytes a tensor-core launch with this geometry needs.
size_t asv_fbank_mma_smem_bytes(int shift, int window_pad, int nb, int nnz) {
  return mma_layout(shift, window_pad, nb, nnz).total;
}

// bf16 mode on the tensor cores. wave [B, S] f32 with S a multiple of 4 and
// 16-byte aligned; effp the folded matrix in bf16 in fragment order (see
// fbank_mma_kernel), window_pad a multiple of 32 rows; shift a multiple of
// 8; blocks: persistent blocks to launch (one for each SM). The rest as
// asv_fbank_launch. Returns cudaGetLastError().
int asv_fbank_mma_launch(const void* wave, const void* effp, const void* mel_meta,
                         const void* mel_w, void* out, void* energy, int B, int S, int T,
                         int shift, int window, int window_pad, int nb, int nnz, int use_power,
                         int use_log, int remove_dc, int blocks, void* stream) {
  if (B < 1 || T < 1 || blocks < 1 || shift < 8 || shift % 8 || window_pad % kKC || S % 4 ||
      window > window_pad || reinterpret_cast<uintptr_t>(wave) % 16 ||
      reinterpret_cast<uintptr_t>(effp) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = mma_layout(shift, window_pad, nb, nnz).total;
  cudaError_t err = cudaFuncSetAttribute(fbank_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_row = (T + kFrames - 1) / kFrames;
  const long long tiles = (long long)B * tiles_per_row;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < blocks ? tiles : blocks);
  fbank_mma_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const unsigned char*>(effp),
      static_cast<const int*>(mel_meta), static_cast<const float*>(mel_w),
      static_cast<float*>(out), static_cast<float*>(energy), S, T, shift, window, window_pad, nb,
      nnz, use_power, use_log, remove_dc, tiles_per_row, (int)tiles);
  return (int)cudaGetLastError();
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
