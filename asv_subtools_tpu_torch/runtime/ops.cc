// C++ registrations of the kernels' custom ops for the native binaries.
//
// An AOTInductor package keeps K2, K3 and K4 as extern calls of
// asv_subtools_tpu_torch::fused_* (defined in nn/fused_att_pooling.py,
// nn/fused_res2.py and nn/fused_stats_pooling.py), which its proxy executor
// finds by name and schema in the dispatcher. In a Python process
// torch.library defines them; the C++ binaries link this file instead, and
// no Python process ever loads it. The schemas are the Python ops', string
// for string. Each CUDA implementation does what its Python `_launch_kernel`
// does: it checks the call, turns the mask into bytes, allocates the output
// and the workspace the launcher asks for, calls the same C launcher of
// build/lib<name>.so (declared in csrc/launch_plan.h, which also holds the
// launch plans) on the current stream, raises on the returned code, and
// counts its launches (CountOpLaunch). There is no CPU implementation: a CPU
// package never holds these ops (the wrappers run the plain versions on CPU
// tensors), and nothing here stands in for a kernel whose launch fails.
#include <torch/library.h>

#include "cuda_executor.h"

#ifdef ASV_WITH_CUDA
#include <ATen/ATen.h>
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include <optional>

#include "launch_plan.h"
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

void Check(int code, const char* what) {
  TORCH_CHECK(code == 0, what, ": CUDA error ", code, " (", asv_error_string(code), ")");
}

void* Stream(const at::Tensor& x) { return at::cuda::getCurrentCUDAStream(x.device().index()).stream(); }

const void* Ptr(const at::Tensor& t) { return t.defined() ? t.data_ptr() : nullptr; }

// The workspace of `bytes` that a launcher's plan asks for (`code`: its
// *_workspace_bytes), or the refusal where no plan takes the call.
at::Tensor Workspace(const at::Tensor& x, int code, long long bytes, const char* what) {
  TORCH_CHECK(code == 0, "no plan of the ", what, " takes this call (csrc/launch_plan.h)");
  return at::empty({static_cast<int64_t>(bytes)}, x.options().dtype(at::kByte));
}

// ---- K2: nn/fused_att_pooling.py _launch_kernel -------------------------

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
  const int bf16 = x.scalar_type() == at::kBFloat16;
  long long bytes = 0;
  const int planned = asv_att_pool_workspace_bytes(int(b), int(c), int(t), int(k), bf16, &bytes);
  at::Tensor work = Workspace(x, planned, bytes, "attentive pooling kernel");
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
  at::Tensor w_x = wx.contiguous(), w_m = wm.contiguous(), w_s = ws.contiguous(), w_2 = w2.contiguous();
  at::Tensor out = at::empty({b, 2 * c}, x.options().dtype(at::kFloat));
  int code = asv_att_pool_launch(xt.data_ptr(), Ptr(m), w_x.data_ptr(), w_m.data_ptr(), w_s.data_ptr(),
                                 vb1.data_ptr(), vbs.data_ptr(), vbt.data_ptr(), w_2.data_ptr(), vb2.data_ptr(),
                                 out.data_ptr(), work.data_ptr(), int(b), int(c), int(t), int(k), bf16, nullptr,
                                 Stream(x));
  Check(code, "attentive pooling kernel");
  asvtorch::CountOpLaunch("fused_attentive_stats_pool");
  return out;
}

// ---- K3: nn/fused_res2.py _launch_kernel --------------------------------

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
  const int64_t bsz = x.size(0), t = x.size(1);
  const int bf16 = x.scalar_type() == at::kBFloat16;
  long long bytes = 0;
  const int planned = asv_res2_chain_workspace_bytes(int(bsz), int(t), int(h), int(n), int(dilation), bf16, &bytes);
  at::Tensor work = Workspace(x, planned, bytes, "res2 chain kernel");
  const at::Device dev = x.device();
  c10::cuda::CUDAGuard guard(dev);
  at::Tensor xt = x.transpose(1, 2).contiguous();
  at::Tensor wc = w.contiguous();
  auto f32 = [&](const at::Tensor& v) { return v.to(dev, at::kFloat).contiguous(); };
  at::Tensor vb = f32(bias), vbs = f32(bn_scale), vbt = f32(bn_shift);
  at::Tensor out = at::empty_like(xt);
  int code = asv_res2_chain_launch(xt.data_ptr(), wc.data_ptr(), vb.data_ptr(), vbs.data_ptr(), vbt.data_ptr(),
                                   out.data_ptr(), work.data_ptr(), int(bsz), int(t), int(h), int(n),
                                   int(dilation), bf16, nullptr, Stream(x));
  Check(code, "res2 chain kernel");
  asvtorch::CountOpLaunch("fused_res2_chain");
  return out.transpose(1, 2);
}

// ---- K4: nn/fused_stats_pooling.py _launch_kernel -----------------------

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
  const int bf16 = x.scalar_type() == at::kBFloat16;
  long long bytes = 0;
  const int planned = asv_stats_pool_workspace_bytes(x.data_ptr(), x.stride(0), x.stride(1), int(b), int(t), int(d),
                                                     bf16, -1, &bytes);
  at::Tensor work = Workspace(x, planned, bytes, "statistics pooling kernel");
  at::Tensor m;
  if (has_mask) {  // _mask_bytes: one byte a frame, contiguous, on x's device
    if (mask->device() == dev && mask->is_contiguous() && mask->scalar_type() == at::kBool)
      m = mask->view(at::kByte);
    else if (mask->device() == dev && mask->is_contiguous() && mask->scalar_type() == at::kByte)
      m = *mask;
    else
      m = mask->to(dev, at::kBool).contiguous().view(at::kByte);
  }
  at::Tensor out = at::empty({b, 2 * d}, x.options().dtype(at::kFloat));
  int code = asv_stats_pool_launch(Ptr(m), out.data_ptr(), work.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1),
                                   int(b), int(t), int(d), bf16, -1, float(eps), nullptr, Stream(x));
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
