// C++ registrations of the kernels' custom ops for the native binaries.
//
// An AOTInductor package keeps K2, K3 and K4 as extern calls of
// asv_subtools_tpu_torch::fused_* (nn/fused_att_pooling.py:170,
// nn/fused_res2.py:190, nn/fused_stats_pooling.py:172), which its proxy
// executor finds by name and schema in the dispatcher. In a Python process
// torch.library defines them; the C++ binaries link this file instead, and
// no Python process ever loads it. The schemas are the Python ops', string
// for string. Each CUDA implementation repeats its Python `_launch_kernel`'s
// host-side preparation, calls the same C launch function of
// build/lib<name>.so on the current stream, checks the returned code and
// raises, and counts its launches (CountOpLaunch). There is no CPU
// implementation: a CPU package never holds these ops (the wrappers run the
// plain versions on CPU tensors), and nothing here stands in for a kernel
// whose launch fails.
#include <torch/library.h>

#include "cuda_executor.h"

#ifdef ASV_WITH_CUDA
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <algorithm>
#include <optional>
#include <string>

extern "C" {
int asv_att_pool_launch(const void* x, const void* mask, const void* wx, const void* wm, const void* ws,
                        const void* b1, const void* bns, const void* bnt, const void* w2, const void* b2,
                        void* stats, void* glob, void* part, void* out, int B, int C, int T, int K, int bf16,
                        int even, void* stream);
int asv_res2_chain_launch(const void* x, const void* w, const void* bias, const void* bns, const void* bnt,
                          void* out, int B, int T, int h, int n, int d, int TT, int tiles, int RP, int SP,
                          int smem, int bf16, int tensor, int even, void* stream);
int asv_stats_pool_launch(const void* x, const void* mask, void* part, void* out, long long sb, long long st,
                          int B, int T, int D, int splits, int span_rows, int vec, int bf16, int ring,
                          int blocks, float eps, void* stream);
const char* asv_error_string(int code);
}
#endif  // ASV_WITH_CUDA

namespace {

// The Python ops' schemas (torch.ops.asv_subtools_tpu_torch.<op>.default._schema).
constexpr const char* kAttSchema =
    "asv_subtools_tpu_torch::fused_attentive_stats_pool(Tensor x, Tensor wx, Tensor wm, Tensor ws, "
    "Tensor b1, Tensor bn_scale, Tensor bn_shift, Tensor w2, Tensor b2, Tensor? mask=None) -> Tensor";
constexpr const char* kRes2Schema =
    "asv_subtools_tpu_torch::fused_res2_chain(Tensor x, Tensor w, Tensor b, Tensor bn_scale, "
    "Tensor bn_shift, SymInt dilation) -> Tensor";
constexpr const char* kStatsSchema =
    "asv_subtools_tpu_torch::fused_stats_pooling(Tensor x, Tensor? mask=None, float eps=1e-10) -> Tensor";

#ifdef ASV_WITH_CUDA

constexpr int64_t kSmemLimit = 232448;  // kernels/_build.py SMEM_LIMIT

int64_t Cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

void Check(int code, const char* what) {
  TORCH_CHECK(code == 0, what, ": CUDA error ", code, " (", asv_error_string(code), ")");
}

void* Stream(const at::Tensor& x) { return at::cuda::getCurrentCUDAStream(x.device().index()).stream(); }

const void* Ptr(const at::Tensor& t) { return t.defined() ? t.data_ptr() : nullptr; }

// ---- K2: nn/fused_att_pooling.py _launch_kernel -------------------------

constexpr int64_t kAttTTile = 64, kAttMaxK = 256, kAttCA = 64, kAttCB = 128;

at::Tensor AttentiveStatsPool(const at::Tensor& x, const at::Tensor& wx, const at::Tensor& wm,
                              const at::Tensor& ws, const at::Tensor& b1, const at::Tensor& bn_scale,
                              const at::Tensor& bn_shift, const at::Tensor& w2, const at::Tensor& b2,
                              const std::optional<at::Tensor>& mask) {
  TORCH_CHECK(x.dim() == 3, "x must be [B, T, C], got ", x.sizes());
  const int64_t b = x.size(0), t = x.size(1), c = x.size(2), k = wx.size(1);
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "x must be float32 or bfloat16, got ", x.scalar_type());
  for (const at::Tensor* w : {&wx, &wm, &ws, &w2})
    TORCH_CHECK(w->scalar_type() == x.scalar_type(), "weights must have x's type ", x.scalar_type());
  TORCH_CHECK(wx.sizes() == at::IntArrayRef({c, k}) && wm.sizes() == at::IntArrayRef({c, k}) &&
                  ws.sizes() == at::IntArrayRef({c, k}) && w2.sizes() == at::IntArrayRef({k, c}),
              "weights must be wx, wm, ws [C, K] and w2 [K, C]");
  TORCH_CHECK(k <= kAttMaxK, "bottleneck ", k, " above the kernel's limit ", kAttMaxK);
  const at::Device dev = x.device();
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor xt = x.transpose(1, 2).contiguous();
  at::Tensor m;
  if (mask.has_value() && mask->defined()) {
    m = mask->scalar_type() == at::kBool ? mask->to(dev).contiguous().view(at::kByte)
                                         : mask->to(dev, at::kByte).contiguous();
  }
  auto f32 = [&](const at::Tensor& v) { return v.to(dev, at::kFloat).contiguous(); };
  at::Tensor vb1 = f32(b1), vbs = f32(bn_scale), vbt = f32(bn_shift), vb2 = f32(b2);
  const bool tensor = x.scalar_type() == at::kBFloat16;
  at::Tensor w_x = wx.contiguous(), w_m = wm.contiguous(), w_s = ws.contiguous(), w_2 = w2.contiguous();
  if (tensor) {  // tensor_core_weights: transposed and zero-padded to whole chunks
    const int64_t kp = k <= 128 ? 128 : 256;
    w_x = wx.new_zeros({kp, Cdiv(c, kAttCA) * kAttCA});
    w_x.slice(0, 0, k).slice(1, 0, c).copy_(wx.t());
    w_2 = w2.new_zeros({Cdiv(c, kAttCB) * kAttCB, kp});
    w_2.slice(0, 0, c).slice(1, 0, k).copy_(w2.t());
  }
  const bool even = t % 2 == 0 && reinterpret_cast<uintptr_t>(xt.data_ptr()) % 4 == 0;
  const int64_t n_tiles = Cdiv(t, kAttTTile);
  auto opt = x.options().dtype(at::kFloat);
  at::Tensor stats = at::empty({b, 2, c}, opt), glob = at::empty({4, b, k}, opt);
  at::Tensor part = at::empty({b, n_tiles, 4, c}, opt), out = at::empty({b, 2 * c}, opt);
  int code = asv_att_pool_launch(xt.data_ptr(), Ptr(m), w_x.data_ptr(), w_m.data_ptr(), w_s.data_ptr(),
                                 vb1.data_ptr(), vbs.data_ptr(), vbt.data_ptr(), w_2.data_ptr(), vb2.data_ptr(),
                                 stats.data_ptr(), glob.data_ptr(), part.data_ptr(), out.data_ptr(), int(b),
                                 int(c), int(t), int(k), int(tensor), int(even), Stream(x));
  Check(code, "attentive pooling kernel");
  asvtorch::CountOpLaunch("fused_attentive_stats_pool");
  return out;
}

// ---- K3: nn/fused_res2.py _launch_kernel --------------------------------

constexpr int64_t kRes2Rows = 192, kRes2KC = 32, kRes2MaxH = 128, kRes2Slots = 2;

struct TilePlan {
  int64_t tt, tiles, rp;
};

TilePlan Res2TilePlan(int64_t t, int64_t n, int64_t d) {
  const int64_t max_tt = kRes2Rows - 2 * (n - 1) * d;
  TORCH_CHECK(max_tt >= 16, "dilation ", d, " with ", n, " stages leaves no room for a tile in the kernel's ",
              kRes2Rows, " rows");
  const int64_t tiles = Cdiv(t, max_tt);
  int64_t tt = Cdiv(t, tiles);
  tt += tt % 2;
  return {tt, tiles, ((n + 1) * d + kRes2Rows) | 1};
}

at::Tensor Res2Chain(const at::Tensor& x, const at::Tensor& w, const at::Tensor& bias, const at::Tensor& bn_scale,
                     const at::Tensor& bn_shift, int64_t dilation) {
  TORCH_CHECK(x.dim() == 3, "x must be [B, T, C], got ", x.sizes());
  TORCH_CHECK(w.dim() == 4, "w must be [n_stages, 3, h, h], got ", w.sizes());
  const int64_t n = w.size(0), h = w.size(2);
  TORCH_CHECK(w.size(1) == 3 && w.size(3) == h && (n + 1) * h == x.size(2), "unsupported res2 geometry: x ",
              x.sizes(), ", w ", w.sizes());
  for (const at::Tensor* v : {&bias, &bn_scale, &bn_shift})
    TORCH_CHECK(v->sizes() == at::IntArrayRef({n, h}), "bias and BN vectors must be [", n, ", ", h, "]");
  TORCH_CHECK(dilation >= 1, "dilation must be >= 1, got ", dilation);
  TORCH_CHECK(x.scalar_type() == at::kFloat || x.scalar_type() == at::kBFloat16,
              "x must be float32 or bfloat16, got ", x.scalar_type());
  TORCH_CHECK(w.scalar_type() == x.scalar_type(), "w must have x's type ", x.scalar_type());
  TORCH_CHECK(h <= kRes2MaxH, "hidden width ", h, " above the kernel's limit ", kRes2MaxH);
  const int64_t bsz = x.size(0), t = x.size(1);
  TORCH_CHECK(bsz <= 65535, "batch ", bsz, " above the kernel's limit 65535");
  const bool bf16 = x.scalar_type() == at::kBFloat16;
  bool tensor = bf16 && (h == 16 || h == 32 || h == 64 || h == 128);
  const int64_t d = dilation;
  int64_t tt = 0, tiles = 0, rp = 0, sp = 0, smem = 0;
  if (tensor) {  // tensor_core_plan
    TilePlan p = Res2TilePlan(t, n, d);
    tt = p.tt;
    tiles = p.tiles;
    rp = (n + 1) * d + kRes2Rows;
    const int64_t need = tt + 2 * n * d + 2;
    sp = need + (((8 - need) % 64) + 64) % 64;
    const int64_t ring = Cdiv(2 * rp * (h + 8), 128) * 128;
    const int64_t part = ring + kRes2Slots * 2 * h * (h + 8);
    const int64_t bars = Cdiv(part + 2 * h * sp, 8) * 8;
    smem = bars + 8 * 2 * kRes2Slots;
    tensor = smem <= kSmemLimit;
  }
  at::Tensor wc;
  if (tensor) {  // [n, 3, h out, h in + 8]
    wc = at::constant_pad_nd(w.permute({0, 1, 3, 2}), {0, 8}, 0).contiguous();
  } else {
    TilePlan p = Res2TilePlan(t, n, d);
    tt = p.tt;
    tiles = p.tiles;
    rp = p.rp;
    sp = 0;
    smem = 4 * (h * rp + kRes2KC * h);
    wc = w.contiguous();
  }
  TORCH_CHECK(smem <= kSmemLimit, "hidden width ", h, " at dilation ", d, " needs ", smem,
              " bytes of shared memory");
  const at::Device dev = x.device();
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor xt = x.transpose(1, 2).contiguous();
  at::Tensor out = at::empty_like(xt);
  const bool even = t % 2 == 0 && reinterpret_cast<uintptr_t>(xt.data_ptr()) % 4 == 0;
  auto f32 = [&](const at::Tensor& v) { return v.to(dev, at::kFloat).contiguous(); };
  at::Tensor vb = f32(bias), vbs = f32(bn_scale), vbt = f32(bn_shift);
  int code = asv_res2_chain_launch(xt.data_ptr(), wc.data_ptr(), vb.data_ptr(), vbs.data_ptr(), vbt.data_ptr(),
                                   out.data_ptr(), int(bsz), int(t), int(h), int(n), int(d), int(tt), int(tiles),
                                   int(rp), int(sp), int(smem), int(bf16), int(tensor), int(even), Stream(x));
  Check(code, "res2 chain kernel");
  asvtorch::CountOpLaunch("fused_res2_chain");
  return out.transpose(1, 2);
}

// ---- K4: nn/fused_stats_pooling.py _launch_kernel -----------------------

constexpr int64_t kStatsTargetBlocks = 1056, kStatsRingRows = 32, kStatsRingBlocksPerSm = 2,
                  kStatsRingItemsPerBlock = 4;

at::Tensor StatsPooling(const at::Tensor& x_in, const std::optional<at::Tensor>& mask, double eps) {
  TORCH_CHECK(x_in.dim() == 3 && x_in.size(1) > 0, "x must be [B, T, D] with T > 0, got ", x_in.sizes());
  TORCH_CHECK(x_in.scalar_type() == at::kFloat || x_in.scalar_type() == at::kBFloat16,
              "x must be float32 or bfloat16, got ", x_in.scalar_type());
  const bool has_mask = mask.has_value() && mask->defined();
  if (has_mask)
    TORCH_CHECK(mask->sizes() == x_in.sizes().slice(0, 2), "mask must be [B, T] = ", x_in.sizes().slice(0, 2),
                ", got ", mask->sizes());
  const int64_t b = x_in.size(0), t = x_in.size(1), d = x_in.size(2);
  const at::Device dev = x_in.device();
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor x = x_in.stride(2) != 1 ? x_in.contiguous() : x_in;
  const int64_t full = 16 / x.element_size();  // elements in one 16-byte load
  const bool aligned = d % full == 0 && x.stride(0) % full == 0 && x.stride(1) % full == 0 &&
                       reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0;
  const bool ring = aligned;
  const int64_t vec = aligned ? full : 1;
  at::Tensor m;
  if (has_mask) {  // _mask_bytes: one byte a frame, contiguous, on x's device
    if (mask->device() == dev && mask->is_contiguous() && mask->scalar_type() == at::kBool)
      m = mask->view(at::kByte);
    else if (mask->device() == dev && mask->is_contiguous() && mask->scalar_type() == at::kByte)
      m = *mask;
    else
      m = mask->to(dev, at::kBool).contiguous().view(at::kByte);
  }
  const int64_t blocks = kStatsRingBlocksPerSm * at::cuda::getDeviceProperties(dev.index())->multiProcessorCount;
  int64_t splits, span_rows;
  if (ring) {  // _ring_plan
    const int64_t pairs = b * Cdiv(d, 32 * vec);
    const int64_t stages = Cdiv(t, kStatsRingRows);
    const int64_t want = Cdiv(kStatsRingItemsPerBlock * blocks, pairs);
    span_rows = Cdiv(stages, std::max<int64_t>(1, std::min(want, stages))) * kStatsRingRows;
  } else {  // _direct_plan
    const int64_t d_tiles = Cdiv(d, 32 * vec);
    const int64_t want = Cdiv(kStatsTargetBlocks, b * d_tiles);
    span_rows = Cdiv(t, std::max<int64_t>(1, std::min(want, t / 32)));
  }
  splits = Cdiv(t, span_rows);
  auto opt = x.options().dtype(at::kFloat);
  at::Tensor out = at::empty({b, 2 * d}, opt);
  at::Tensor part = splits > 1 ? at::empty({b * splits * (3 * d + 1)}, opt) : at::Tensor();
  int code = asv_stats_pool_launch(x.data_ptr(), Ptr(m), part.defined() ? part.data_ptr() : nullptr,
                                   out.data_ptr(), x.stride(0), x.stride(1), int(b), int(t), int(d), int(splits),
                                   int(span_rows), int(vec), int(x.scalar_type() == at::kBFloat16), int(ring),
                                   int(blocks), float(eps), Stream(x));
  Check(code, "statistics pooling kernel");
  asvtorch::CountOpLaunch("fused_stats_pooling");
  return out;
}

#endif  // ASV_WITH_CUDA

struct RegisterCounts {
  RegisterCounts() {
    for (const char* op : {"fused_attentive_stats_pool", "fused_res2_chain", "fused_stats_pooling"})
      asvtorch::CountOpLaunch(op, 0);
  }
} register_counts;

}  // namespace

TORCH_LIBRARY(asv_subtools_tpu_torch, m) {
  m.def(kAttSchema);
  m.def(kRes2Schema);
  m.def(kStatsSchema);
}

#ifdef ASV_WITH_CUDA
TORCH_LIBRARY_IMPL(asv_subtools_tpu_torch, CUDA, m) {
  m.impl("fused_attentive_stats_pool", &AttentiveStatsPool);
  m.impl("fused_res2_chain", &Res2Chain);
  m.impl("fused_stats_pooling", &StatsPooling);
}
#endif
