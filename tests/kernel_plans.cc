// The launch plans of asv_subtools_tpu_torch/csrc/launch_plan.h as a host
// library with a plain C interface, for the CPU tests (kernel_plans.py
// builds it with kernels._build.build_host: c++, no CUDA). The kernels'
// launchers call the same inline functions.
#include "launch_plan.h"

using namespace asv_plan;

namespace {

int put(bool ok, const Res2Plan& p, long long* out) {
  const long long v[] = {p.tensor, p.tt, p.tiles, p.rp, p.sp, p.smem, (long long)p.bytes};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return ok;
}

}  // namespace

extern "C" {

int asv_plan_smem_limit() { return kSmemLimit; }

// out: tensor, tiles, kp, wxt_cols, w2t_rows, then the workspace's offsets
// stats, glob, part, wxt, w2t and its bytes. Returns 0 where no plan takes
// the call.
int asv_plan_att(int B, int C, int T, int K, int bf16, long long* out) {
  AttPlan p{};
  const bool ok = att_plan(B, C, T, K, bf16, &p);
  const long long v[] = {p.tensor, p.tiles, p.kp, p.wxt_cols, p.w2t_rows, (long long)p.stats,
                         (long long)p.glob, (long long)p.part, (long long)p.wxt, (long long)p.w2t,
                         (long long)p.bytes};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return ok;
}

// out: tensor, tt, tiles, rp, sp, smem, workspace bytes. Returns whether
// the plan fits; tiles is 0 where the halo leaves no room for a tile.
int asv_plan_res2_cuda_core(int T, int h, int n, int d, long long* out) {
  Res2Plan p;
  const bool ok = res2_cuda_core_plan(T, h, n, d, &p);
  return put(ok, p, out);
}

int asv_plan_res2_tensor_core(int T, int h, int n, int d, long long* out) {
  Res2Plan p;
  const bool ok = res2_tensor_core_plan(T, h, n, d, &p);
  return put(ok, p, out);
}

int asv_plan_res2(int B, int T, int h, int n, int d, int bf16, long long* out) {
  Res2Plan p{};
  const bool ok = res2_plan(B, T, h, n, d, bf16, &p);
  return put(ok, p, out);
}

int asv_plan_stats_t_splits(int B, int T, int D, int vec) { return stats_t_splits(B, T, D, vec); }

// out: splits, span_rows of the ring kernel (ring != 0) or the direct one.
void asv_plan_stats_spans(int ring, int B, int T, int D, int vec, int blocks, long long* out) {
  StatsPlan p{};
  stats_spans(ring, B, T, D, vec, blocks, &p);
  out[0] = p.splits;
  out[1] = p.span_rows;
}

// out: ring, vec, blocks, splits, span_rows, workspace bytes. Returns 0
// where the route does not take x.
int asv_plan_stats(unsigned long long x, int elem_bytes, long long sb, long long st, int B, int T, int D,
                   int route, int sms, long long* out) {
  StatsPlan p{};
  const bool ok = stats_plan(x, elem_bytes, sb, st, B, T, D, route, sms, &p);
  const long long v[] = {p.ring, p.vec, p.blocks, p.splits, p.span_rows, (long long)p.bytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return ok;
}

}  // extern "C"
