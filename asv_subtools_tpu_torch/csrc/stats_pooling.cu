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
// Bound on an H100 SXM: bytes. x [128, 125, 2560] bf16 is 81.9 MB, read
// once, plus the mask and 2.6 MB of f32 output -> 25 us at 3.35 TB/s; the
// arithmetic (4 operations an element) is far below the f32 peak. So the
// design is about keeping device memory busy from the first microsecond to
// the last; the sums are cheap.
//
// Work items. An item is one row b, one tile of 512 contiguous bytes of D
// (32 lanes x 16 bytes) and one span of T. With splits == 1 an item writes
// mean and std itself; otherwise it writes its partial sums and a second
// small kernel merges the spans, so inputs with few (b, D tile) pairs still
// fill the card.
//
// The ring kernel (x aligned to 16 bytes: the served shapes). The TPU
// kernel walks T in a sequential grid and accumulates into its output
// block; a grid of short-lived blocks on this card pays its fill and drain
// for every 64 KB. Here the grid is persistent (the launcher takes two
// blocks for each SM) and each block walks its items in a loop. One
// producer warp copies an item's rows, 32 at a time, into a ring of
// shared-memory stages with cp.async.bulk (each lane one row of 512 bytes,
// completion counted in bytes on the stage's mbarrier), several stages
// ahead of the eight consumer warps, which sum from shared memory. An
// item's reduction and output are therefore overlapped by the copies of the
// next items, already in flight. The producer reads the mask once: a frame
// whose mask is 0 is not copied at all (masked frames may hold anything),
// the stage's mask bits travel with it in shared memory and give the
// consumers the count too. Long T goes through the same ring in as many
// stages as it takes.
//
// The direct kernel (loads straight from device memory to registers, one
// block an item) takes inputs that are not aligned to 16 bytes, which
// cp.async.bulk does not.
//
// The sums are of (x - shift), where shift is the span's first valid frame
// standing in for the mean: the result is the same function for any shift,
// and the one-pass variance keeps its digits when |mean| >> std. A masked
// frame is never read into a sum, the shift included. Spans of one row have
// their own shifts; the merge kernel combines their (count, mean, M2) by
// the pairwise update of Chan et al.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "launch_plan.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // frames in flight per warp (direct kernel)

constexpr int kRingRows = asv_plan::kStatsRingRows;    // rows per stage: one per producer lane
static_assert(kRingRows == 32, "a stage's rows are the producer warp's lanes and its ballot's bits");
constexpr int kRowBytes = 512;                          // 32 lanes x 16 bytes
constexpr int kStageBytes = kRingRows * kRowBytes;      // 16 KB
constexpr int kStages = 5;
constexpr int kRingThreads = kThreads + 32;             // eight consumer warps and the producer
constexpr int kRowsPerWarp = kRingRows / kWarps;
constexpr int kTileMax = kRowBytes / 2;                 // features in a tile, at most (bf16)
constexpr size_t kRingSmem = (size_t)kStages * kStageBytes + sizeof(float) * (2 * kWarps + 1) * kTileMax +
                             sizeof(uint64_t) * 2 * kStages + sizeof(uint32_t) * kStages;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// VEC consecutive features as f32: one 16-byte load when VEC > 1 (from
// device or shared memory)
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

template <int VEC>
__device__ __forceinline__ void add_frame(const float* v, const float* shift, float* s1, float* s2) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float dl = v[e] - shift[e];
    s1[e] += dl;
    s2[e] = fmaf(dl, dl, s2[e]);
  }
}

// One feature's result from the sums of (x - shift) over `raw` valid frames.
__device__ __forceinline__ void write_out(float* __restrict__ out, int b, int D, int d,
                                          float shift, float a1, float a2, float raw,
                                          float eps) {
  const float cnt = fmaxf(raw, 1.f);
  const float mu = a1 / cnt;
  const float var = a2 / cnt - mu * mu;
  out[(size_t)b * 2 * D + d] = shift + mu;  // no valid frame: shift = a1 = 0
  out[(size_t)b * 2 * D + D + d] = sqrtf(fmaxf(var, eps));
}

// A span's partial result: part [B, splits, 3, D] = shift, sum, sum of squares
__device__ __forceinline__ void write_part(float* __restrict__ part, int b, int split, int splits,
                                           int D, int d, float shift, float a1, float a2) {
  float* p = part + ((size_t)b * splits + split) * 3 * D;
  p[d] = shift;
  p[D + d] = a1;
  p[2 * D + d] = a2;
}

// barrier of the consumer warps only (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// ---------------------------------------------------------------------------
// The ring kernel. grid: persistent blocks; block: 8 consumer warps + 1
// producer warp. Item i = (pair, split), pair = (b, D tile); block k takes
// items k, k + grid, ...; producer and consumers walk the same sequence of
// stages (32 rows of one item each).

struct Item {
  int b, split, d_base, tbeg, tend;
};

__device__ __forceinline__ Item decode_item(int item, int d_tiles, int splits, int span_rows,
                                            int Tn, int tile) {
  Item it;
  const int pair = item / splits;
  it.split = item - pair * splits;
  it.b = pair / d_tiles;
  it.d_base = (pair - it.b * d_tiles) * tile;
  it.tbeg = it.split * span_rows;
  it.tend = min(Tn, it.tbeg + span_rows);
  return it;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kRingThreads) stats_ring_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ part,
    float* __restrict__ cnt, float* __restrict__ out, long long sb, long long st, int Tn, int D,
    int d_tiles, int splits, int span_rows, int items, float eps) {
  constexpr int kTile = 32 * VEC;  // features in a tile: 512 bytes
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* red = reinterpret_cast<float*>(smem + (size_t)kStages * kStageBytes);  // [kWarps][2][kTileMax]
  float* shift_s = red + 2 * kWarps * kTileMax;                                  // [kTileMax]
  uint64_t* bars = reinterpret_cast<uint64_t*>(shift_s + kTileMax);              // full, then empty
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(bars + 2 * kStages);            // a stage's valid rows
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t full0 = smem_u32(bars), empty0 = smem_u32(bars + kStages);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);        // the producer's arrive; the bytes ride on it
      mbar_init(empty0 + 8 * s, kWarps);  // one arrive a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: lane r copies row r of each stage; the next stage's mask
    // byte is on its way while this stage waits for its slot
    int item = blockIdx.x;
    if (item >= items) return;
    Item it = decode_item(item, d_tiles, splits, span_rows, Tn, kTile);
    int t0 = it.tbeg;
    auto row_valid = [&](const Item& i, int t_first) {
      const int t = t_first + lane;
      return t < i.tend && (mask == nullptr || mask[(size_t)i.b * Tn + t] != 0);
    };
    bool valid = row_valid(it, t0);
    for (uint32_t q = 0;; ++q) {
      // the stage after this one
      Item nit = it;
      int nitem = item, nt0 = t0 + kRingRows;
      if (nt0 >= it.tend) {
        nitem = item + gridDim.x;
        if (nitem < items) {
          nit = decode_item(nitem, d_tiles, splits, span_rows, Tn, kTile);
          nt0 = nit.tbeg;
        }
      }
      const bool more = nitem < items;
      const bool nvalid = more && row_valid(nit, nt0);

      const uint32_t stage = q % kStages, phase = (q / kStages) & 1u;
      const uint32_t bits = __ballot_sync(0xffffffffu, valid);
      const uint32_t row_bytes = (uint32_t)(min(kTile, D - it.d_base) * (int)sizeof(T));
      mbar_wait(empty0 + 8 * stage, phase ^ 1u);  // first pass: free at once
      if (lane == 0) {
        bits_s[stage] = bits;
        mbar_arrive_expect_tx(full0 + 8 * stage, __popc(bits) * row_bytes);
      }
      __syncwarp();
      if (valid) {
        const T* src = x + (size_t)it.b * sb + (size_t)(t0 + lane) * st + it.d_base;
        bulk_copy(smem_u32(ring + (size_t)stage * kStageBytes + lane * kRowBytes), src, row_bytes,
                  full0 + 8 * stage);
      }
      if (!more) break;
      it = nit; item = nitem; t0 = nt0; valid = nvalid;
    }
    return;
  }

  // ---- consumers
  uint32_t q = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = decode_item(item, d_tiles, splits, span_rows, Tn, kTile);
    float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) shift[e] = s1[e] = s2[e] = 0.f;
    bool have_shift = false;
    float raw = 0.f;
    for (int t0 = it.tbeg; t0 < it.tend; t0 += kRingRows, ++q) {
      const uint32_t stage = q % kStages, phase = (q / kStages) & 1u;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t bits = bits_s[stage];
      const T* rows = reinterpret_cast<const T*>(ring + (size_t)stage * kStageBytes) + lane * VEC;
      constexpr int kRowElems = kRowBytes / (int)sizeof(T);
      if (!have_shift && bits != 0) {
        load_vec<T, VEC>(rows + (__ffs(bits) - 1) * kRowElems, shift);  // the first valid frame
        have_shift = true;
      }
      raw += (float)__popc(bits);
      float v[kRowsPerWarp][VEC];
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u)  // rows never copied hold stale bytes: read, not used
        load_vec<T, VEC>(rows + (warp + kWarps * u) * kRowElems, v[u]);
#pragma unroll
      for (int u = 0; u < kRowsPerWarp; ++u)
        if ((bits >> (warp + kWarps * u)) & 1u) add_frame<VEC>(v[u], shift, s1, s2);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    }

    // the warps meet in shared memory, indexed by feature within the tile
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      red[(2 * warp) * kTileMax + lane * VEC + e] = s1[e];
      red[(2 * warp + 1) * kTileMax + lane * VEC + e] = s2[e];
      if (warp == 0) shift_s[lane * VEC + e] = shift[e];
    }
    consumer_sync();
    const int d = it.d_base + tid;
    if (tid < kTile && d < D) {
      float a1 = 0.f, a2 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        a1 += red[(2 * w) * kTileMax + tid];
        a2 += red[(2 * w + 1) * kTileMax + tid];
      }
      if (splits == 1) {
        write_out(out, it.b, D, d, shift_s[tid], a1, a2, raw, eps);
      } else {
        write_part(part, it.b, it.split, splits, D, d, shift_s[tid], a1, a2);
        if (d == 0) cnt[(size_t)it.b * splits + it.split] = raw;
      }
    }
    consumer_sync();  // red and shift_s are free for the next item
  }
}

// ---------------------------------------------------------------------------
// The direct kernel. grid (D tiles of 32*VEC, splits, B).

// first valid frame (or INT_MAX) and number of valid frames of a span,
// found by the whole block (all threads must call; one __syncthreads)
__device__ __forceinline__ void span_scan(const uint8_t* __restrict__ mb, int tbeg, int tend,
                                          int* first_s, float* cnt_s, int& first, float& raw) {
  if (mb == nullptr) {
    first = tbeg < tend ? tbeg : INT_MAX;
    raw = (float)max(tend - tbeg, 0);
    return;
  }
  const int tid = threadIdx.x;
  int f = INT_MAX;
  float local = 0.f;
  for (int t = tbeg + tid; t < tend; t += blockDim.x) {
    if (mb[t] != 0) {
      local += 1.f;
      f = min(f, t);
    }
  }
  local = warp_sum(local);
  f = warp_min(f);
  if ((tid & 31) == 0) {
    cnt_s[tid >> 5] = local;
    first_s[tid >> 5] = f;
  }
  __syncthreads();
  raw = 0.f;
  first = INT_MAX;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) {
    raw += cnt_s[i];
    first = min(first, first_s[i]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) stats_kernel(
    const T* __restrict__ x, const uint8_t* __restrict__ mask, float* __restrict__ part,
    float* __restrict__ cnt, float* __restrict__ out, long long sb, long long st, int Tn, int D,
    int splits, int span_rows, float eps) {
  __shared__ float red[kWarps][2 * VEC * 32];
  __shared__ float cnt_s[kWarps];
  __shared__ int first_s[kWarps];
  const int b = blockIdx.z, split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = (blockIdx.x * 32 + lane) * VEC;
  const bool live = d0 < D;
  const T* xb = x + (size_t)b * sb;
  const uint8_t* mb = mask == nullptr ? nullptr : mask + (size_t)b * Tn;
  const int tbeg = split * span_rows, tend = min(Tn, tbeg + span_rows);

  int first;
  float raw;
  span_scan(mb, tbeg, tend, first_s, cnt_s, first, raw);
  float shift[VEC], s1[VEC], s2[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) shift[e] = s1[e] = s2[e] = 0.f;
  if (live && first != INT_MAX) load_vec<T, VEC>(xb + (size_t)first * st + d0, shift);

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
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) add_frame<VEC>(v[u], shift, s1, s2);
  }

#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[warp][e * 32 + lane] = s1[e];
    red[warp][(VEC + e) * 32 + lane] = s2[e];
  }
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
      write_part(part, b, split, splits, D, d, shift[e], a1, a2);
      if (d == 0) cnt[(size_t)b * splits + split] = raw;
    }
  }
}

// grid (D tiles of 256, B): merge the spans' (count, mean, M2)
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ part, const float* __restrict__ cnt, float* __restrict__ out, int D,
    int splits, float eps) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float ns = cnt[(size_t)b * splits + s];
    if (ns <= 0.f) continue;
    const float* p = part + ((size_t)b * splits + s) * 3 * D;
    const float a1 = p[D + d];
    const float mean_s = p[d] + a1 / ns;
    const float m2_s = p[2 * D + d] - a1 * a1 / ns;
    const float tot = n + ns, delta = mean_s - mean;
    mean += delta * (ns / tot);
    m2 += m2_s + delta * delta * (n * ns / tot);
    n = tot;
  }
  out[(size_t)b * 2 * D + d] = mean;
  out[(size_t)b * 2 * D + D + d] = sqrtf(fmaxf(m2 / fmaxf(n, 1.f), eps));
}

int launch_combine(float* part, float* cnt, float* out, int B, int D, int splits, float eps,
                   cudaStream_t stream) {
  combine_kernel<<<dim3((D + kThreads - 1) / kThreads, B), kThreads, 0, stream>>>(part, cnt, out, D,
                                                                                   splits, eps);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_direct(const void* xv, const void* maskv, float* part, float* cnt, float* out,
                  long long sb, long long st, int B, int Tn, int D, int splits, int span_rows,
                  float eps, cudaStream_t stream) {
  if (B > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + 32 * VEC - 1) / (32 * VEC), splits, B);
  stats_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(xv), static_cast<const uint8_t*>(maskv), part, cnt, out, sb, st, Tn, D,
      splits, span_rows, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine(part, cnt, out, B, D, splits, eps, stream);
}

template <typename T, int VEC>
int launch_ring(const void* xv, const void* maskv, float* part, float* cnt, float* out,
                long long sb, long long st, int B, int Tn, int D, int splits, int span_rows,
                int blocks, float eps, cudaStream_t stream) {
  const int d_tiles = (D + 32 * VEC - 1) / (32 * VEC);
  const long long items = (long long)B * d_tiles * splits;
  if (items > 0x7fffffffLL || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(stats_ring_kernel<T, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kRingSmem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(items < blocks ? items : blocks);
  stats_ring_kernel<T, VEC><<<grid, kRingThreads, kRingSmem, stream>>>(
      static_cast<const T*>(xv), static_cast<const uint8_t*>(maskv), part, cnt, out, sb, st, Tn, D,
      d_tiles, splits, span_rows, (int)items, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return launch_combine(part, cnt, out, B, D, splits, eps, stream);
}

// The plan of a call on the current device, whose SM count sizes the ring
// kernel's grid (0 where the query fails: the ring launch then refuses).
bool plan_call(const void* x, long long sb, long long st, int B, int T, int D, int bf16, int route,
               asv_plan::StatsPlan* p) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return asv_plan::stats_plan(reinterpret_cast<uintptr_t>(x), bf16 ? 2 : 4, sb, st, B, T, D, route, sms, p);
}

}  // namespace

extern "C" {

// The C interface is declared, and its arguments described, in launch_plan.h.
int asv_stats_pool_workspace_bytes(const void* x, long long sb, long long st, int B, int T, int D, int bf16,
                                   int route, long long* bytes) {
  asv_plan::StatsPlan p;
  if (!plan_call(x, sb, st, B, T, D, bf16, route, &p)) return (int)cudaErrorInvalidValue;
  *bytes = (long long)p.bytes;
  return 0;
}

int asv_stats_pool_launch(const void* mask, void* out, void* work, const void* x, long long sb, long long st,
                          int B, int T, int D, int bf16, int route, float eps, int* taken, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  asv_plan::StatsPlan p;
  if (!plan_call(x, sb, st, B, T, D, bf16, route, &p)) return (int)cudaErrorInvalidValue;
  if (taken != nullptr) *taken = p.ring;
  const int splits = p.splits, span_rows = p.span_rows;
  float* part = static_cast<float*>(work);
  float* cnt = splits > 1 ? part + (size_t)B * splits * 3 * D : nullptr;
  float* o = static_cast<float*>(out);
  if (p.ring) {
    if (bf16)
      return launch_ring<__nv_bfloat16, 8>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, p.blocks,
                                           eps, s);
    return launch_ring<float, 4>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, p.blocks, eps, s);
  }
  if (bf16) {
    if (p.vec == 8)
      return launch_direct<__nv_bfloat16, 8>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, eps, s);
    return launch_direct<__nv_bfloat16, 1>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, eps, s);
  }
  if (p.vec == 4)
    return launch_direct<float, 4>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, eps, s);
  return launch_direct<float, 1>(x, mask, part, cnt, o, sb, st, B, T, D, splits, span_rows, eps, s);
}

const char* asv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
