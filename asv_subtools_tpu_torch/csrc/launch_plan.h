// The launch plans of K2 (att_pooling.cu), K3 (res2_chain.cu) and K4
// (stats_pooling.cu) and their launchers' C interface: constants, the
// shared-memory budget, route, tile and span plans and workspace, each
// decided here once, for the kernels, their launchers and the CPU tests
// (tests/kernel_plans.cc). Host C++17, no CUDA include; the kernels call
// its constexpr functions on the device (nvcc --expt-relaxed-constexpr).

#pragma once

#include <stddef.h>
#include <stdint.h>

namespace asv_plan {

constexpr int kSmemLimit = 232448;  // bytes of shared memory a Hopper block may use

constexpr long long cdiv(long long a, long long b) { return (a + b - 1) / b; }
constexpr size_t align256(size_t n) { return (n + 255) / 256 * 256; }  // workspace parts' alignment

// ---- K2: attentive statistics pooling ---------------------------------------

constexpr int kAttTT = 64;        // frames per attend block, both kernels
constexpr int kAttMaxK = 256;     // bottleneck units
constexpr int kAttCA = 64;        // channels a chunk of the tensor-core kernel's first product
constexpr int kAttCB = 128;       // channels a chunk of its second product: 8 warps x 16
constexpr int kAttGlobSplit = 4;  // partial sums of glob

// Workspace: stats [B, 2, C], glob [kAttGlobSplit, B, K], part [B, tiles,
// 4, C] f32; on the tensor cores Wx^T [kp][wxt_cols], W2^T [w2t_rows][kp].
struct AttPlan {
  int tensor;  // 1: attend_mma_kernel (bf16 x), 0: attend_kernel (f32 x)
  int tiles, kp, wxt_cols, w2t_rows;
  size_t stats, glob, part, wxt, w2t, bytes;
};

// False when the call is outside the kernels' range.
inline bool att_plan(int B, int C, int T, int K, bool bf16, AttPlan* p) {
  if (B < 1 || B > 65535 || C < 1 || T < 1 || K < 1 || K > kAttMaxK) return false;
  p->tensor = bf16;
  p->tiles = (int)cdiv(T, kAttTT);
  p->kp = K <= 128 ? 128 : 256;
  p->wxt_cols = (int)cdiv(C, kAttCA) * kAttCA;
  p->w2t_rows = (int)cdiv(C, kAttCB) * kAttCB;
  p->stats = 0;
  p->glob = align256(sizeof(float) * B * 2 * C);
  p->part = p->glob + align256(sizeof(float) * kAttGlobSplit * B * K);
  p->wxt = p->part + align256(sizeof(float) * B * p->tiles * 4 * C);
  p->w2t = p->wxt + (bf16 ? align256(2 * (size_t)p->kp * p->wxt_cols) : 0);
  p->bytes = p->w2t + (bf16 ? 2 * (size_t)p->w2t_rows * p->kp : 0);
  return true;
}

// ---- K3: the Res2Net chain ---------------------------------------------------

constexpr int kRes2Rows = 192;  // frames a block computes per stage, both kernels
constexpr int kRes2KC = 32;     // weight rows per shared-memory chunk of the CUDA-core kernel
constexpr int kRes2MaxH = 128;  // a thread's output channels stay in registers up to here
constexpr int kRes2Slots = 2;   // weight ring slots of the tensor-core kernel

// Shared memory of res2_mma_kernel, bytes: the state [RP][h + 8] bf16 |
// the weight ring, kRes2Slots chunks [h out][h in + 8] | the part [h][SP]
// bf16 | mbarriers (full, empty a slot).
struct MmaLayout {
  long long ring, part, bars, total;
};

constexpr MmaLayout res2_mma_layout(int h, long long RP, long long SP) {
  const long long ring = (2 * RP * (h + 8) + 127) / 128 * 128;
  const long long part = ring + kRes2Slots * 2LL * h * (h + 8);
  const long long bars = (part + 2 * h * SP + 7) / 8 * 8;
  return {ring, part, bars, bars + 8 * 2 * kRes2Slots};
}

// TT frames a tile (even: tiles start on even frames), the state's rows RP,
// the part's row stride SP and the weights [n, 3, h out, h in + 8] bf16 as
// workspace (tensor cores only).
struct Res2Plan {
  int tensor;  // 1: res2_mma_kernel (tensor cores), 0: res2_kernel (CUDA cores)
  int tt, tiles;
  long long rp, sp, smem;
  size_t bytes;
};

// A tile of TT frames reads [t0 - n*d, t0 + TT + n*d) and recomputes the
// halo; stage 0's TT + 2*(n-1)*d frames fit kRes2Rows. False (tiles 0)
// when the halo leaves fewer than 16.
inline bool res2_tiles(int T, int n, int d, Res2Plan* p) {
  const long long max_tt = kRes2Rows - 2LL * (n - 1) * d;  // even
  if (max_tt < 16) return false;
  p->tiles = (int)cdiv(T, max_tt);
  p->tt = (int)cdiv(T, p->tiles);
  p->tt += p->tt % 2;
  return true;
}

// The CUDA-core kernel: the f32 state [h][RP], RP odd (conflict-free column
// writes), and a chunk of weights. False when it does not fit.
inline bool res2_cuda_core_plan(int T, int h, int n, int d, Res2Plan* p) {
  *p = Res2Plan{};
  if (!res2_tiles(T, n, d, p)) return false;
  p->rp = ((n + 1LL) * d + kRes2Rows) | 1;
  p->smem = 4 * (h * p->rp + kRes2KC * h);
  return p->smem <= kSmemLimit;
}

// The tensor-core kernel: the part buffer holds a channel's TT + 2*n*d
// window frames from an even start, plus one for it and a spare; SP = 8
// (mod 64) puts the fragments' 2-byte accesses on 32 banks. Filled as far
// as the tiles go; false when it does not fit.
inline bool res2_tensor_core_plan(int T, int h, int n, int d, Res2Plan* p) {
  *p = Res2Plan{};
  p->tensor = 1;
  if (!res2_tiles(T, n, d, p)) return false;
  const long long need = p->tt + 2LL * n * d + 2;
  p->rp = (n + 1LL) * d + kRes2Rows;
  p->sp = need + ((8 - need) % 64 + 64) % 64;
  p->smem = res2_mma_layout(h, p->rp, p->sp).total;
  p->bytes = 2 * (size_t)n * 3 * h * (h + 8);
  return p->smem <= kSmemLimit;
}

// The route: bf16 x with h in {16, 32, 64, 128} on the tensor cores where
// they fit (h = 128: up to dilation 14), else the CUDA cores. False when
// the call is out of range or nothing fits.
inline bool res2_plan(int B, int T, int h, int n, int d, bool bf16, Res2Plan* p) {
  if (B < 1 || B > 65535 || T < 1 || h < 1 || h > kRes2MaxH || n < 1 || d < 1) return false;
  if (bf16 && (h == 16 || h == 32 || h == 64 || h == 128) && res2_tensor_core_plan(T, h, n, d, p)) return true;
  return res2_cuda_core_plan(T, h, n, d, p);
}

// ---- K4: statistics pooling --------------------------------------------------

constexpr int kStatsRingRows = 32;          // rows in a stage of the ring kernel: one a producer lane
constexpr int kStatsRingBlocksPerSm = 2;    // persistent blocks of the ring kernel an SM
constexpr int kStatsRingItemsPerBlock = 4;  // cut T until every persistent block has about this many items
constexpr int kStatsTargetBlocks = 1056;    // direct kernel: 8 blocks for each of an H100's 132 SMs

// vec: features a load (16 bytes' worth where x is aligned, else 1); T in
// `splits` spans of span_rows, merged by a second kernel from their partial
// sums, B * splits * (3 * D + 1) f32 of workspace.
struct StatsPlan {
  int ring;  // 1: the ring kernel on `blocks` persistent blocks, 0: the direct kernel
  int vec, blocks, splits, span_rows;
  size_t bytes;
};

// Direct kernel, blocks over T for one (row, D tile): enough blocks to fill
// the card when B x D tiles alone are few, with at least 32 frames each.
inline int stats_t_splits(int B, int T, int D, int vec) {
  const long long want = cdiv(kStatsTargetBlocks, B * cdiv(D, 32LL * vec));
  const long long cap = want < T / 32 ? want : T / 32;
  return (int)(cap > 1 ? cap : 1);
}

// Spans of either kernel, none empty; the ring kernel's are whole stages,
// enough to give each of `blocks` about kStatsRingItemsPerBlock items.
inline void stats_spans(bool ring, int B, int T, int D, int vec, int blocks, StatsPlan* p) {
  if (ring) {
    const long long pairs = B * cdiv(D, 32LL * vec), stages = cdiv(T, kStatsRingRows);
    const long long want = cdiv((long long)kStatsRingItemsPerBlock * blocks, pairs);
    const long long cut = want < stages ? want : stages;
    p->span_rows = (int)(cdiv(stages, cut > 1 ? cut : 1) * kStatsRingRows);
  } else {
    p->span_rows = (int)cdiv(T, stats_t_splits(B, T, D, vec));
  }
  p->splits = (int)cdiv(T, p->span_rows);
}

// x [B, T, D] at `x`, strides sb, st, 1. route -1: the ring kernel where x
// is aligned for it (D, strides and address on 16 bytes), else the direct
// one; 0 direct; 1 ring. False when the route does not take x or the call
// is out of range.
inline bool stats_plan(uintptr_t x, int elem_bytes, long long sb, long long st, int B, int T, int D, int route,
                       int sms, StatsPlan* p) {
  if (B < 1 || T < 1 || D < 1 || route < -1 || route > 1) return false;
  const int full = 16 / elem_bytes;  // elements in one 16-byte load
  const bool aligned = D % full == 0 && sb % full == 0 && st % full == 0 && x % 16 == 0;
  if (route == 1 && !aligned) return false;
  p->ring = route == -1 ? aligned : route;
  p->vec = aligned ? full : 1;
  p->blocks = kStatsRingBlocksPerSm * sms;
  stats_spans(p->ring, B, T, D, p->vec, p->blocks, p);
  p->bytes = p->splits > 1 ? sizeof(float) * B * p->splits * (3 * (size_t)D + 1) : 0;
  return true;
}

}  // namespace asv_plan

// ---- the launchers (defined in the kernels' sources) ------------------------
// `asv_X_launch(pointers, work, facts, [eps,] route, stream)` takes the
// facts of the call that `asv_X_workspace_bytes(facts, bytes)` plans from,
// launches on `stream` and returns the first CUDA error, or 0; both refuse
// (cudaErrorInvalidValue, 1) a call no plan takes. `route` (may be null)
// receives 1 for the tensor cores (K2, K3) or the ring kernel (K4), else 0.
// A tensor-core route first writes the weight layout it reads into `work`.
extern "C" {

// K2. x [B, C, T] (bf16 or f32); mask [B, T] bytes (0 = masked) or null;
// wx, wm, ws [C, K], w2 [K, C] in x's type; b1, bns, bnt [K], b2 [C] and
// out [B, 2C] f32.
int asv_att_pool_workspace_bytes(int B, int C, int T, int K, int bf16, long long* bytes);
int asv_att_pool_launch(const void* x, const void* mask, const void* wx, const void* wm, const void* ws,
                        const void* b1, const void* bns, const void* bnt, const void* w2, const void* b2, void* out,
                        void* work, int B, int C, int T, int K, int bf16, int* route, void* stream);

// K3. x, out [B, (n+1)h, T] (bf16 or f32); w [n, 3, h in, h out] in x's
// type; bias, bns, bnt [n, h] f32; dilation d.
int asv_res2_chain_workspace_bytes(int B, int T, int h, int n, int d, int bf16, long long* bytes);
int asv_res2_chain_launch(const void* x, const void* w, const void* bias, const void* bns, const void* bnt,
                          void* out, void* work, int B, int T, int h, int n, int d, int bf16, int* route,
                          void* stream);

// K4. x [B, T, D] (bf16 or f32, strides sb, st, 1); mask as K2's; out [B,
// 2D] f32; route as stats_plan takes it; blocks from the device's SMs.
int asv_stats_pool_workspace_bytes(const void* x, long long sb, long long st, int B, int T, int D, int bf16,
                                   int route, long long* bytes);
int asv_stats_pool_launch(const void* mask, void* out, void* work, const void* x, long long sb, long long st, int B,
                          int T, int D, int bf16, int route, float eps, int* taken, void* stream);

const char* asv_error_string(int code);

}  // extern "C"
