// bundle_runner: execute a native-runtime bundle on the CUDA card (or the
// CPU) with no Python in the process. Counterpart of
// runtime/bin/pjrt_runner_main.cc.
//
//   bundle_runner --bundle=DIR [--device=cuda|cuda:N|cpu]
//       [--feed=ARGIDX:FILE]... [--iters=N] [--warmup=N] [--dump=PREFIX]
//
// The bundle (asv_subtools_tpu_torch/export.py export_pjrt_bundle) is:
//   manifest.txt  line-based argument specs
//   model.pt2     the AOTInductor package, compiled for the device
//   params.bin    the baked arguments (the `params` line may share one)
//
// Baked arguments are uploaded once and stay resident; runtime arguments
// come from --feed files (raw bytes in the manifest's dtype and shape) or
// are zero-filled. The device defaults to the card; without one, or in a
// build without CUDA, the runner exits non-zero and names the cause.
// runtime/ops.cc's launch counters are printed twice: `ops per call:`
// averages the timed calls, `ops total:` sums every call of the process.
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <string>
#include <vector>

#include "../bundle.h"
#include "../cuda_executor.h"

using asvtorch::ArgSpec;
using asvtorch::Bundle;
using asvtorch::CudaExecutor;
using asvtorch::DtypeBytes;
using asvtorch::HostArray;

namespace {

float Bf16ToF32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float out;
  std::memcpy(&out, &bits, 4);
  return out;
}

void Summarize(const HostArray& a, int idx) {
  double sum = 0, sumsq = 0;
  size_t n = a.num_elements();
  for (size_t i = 0; i < n; ++i) {
    double v = 0;
    if (a.dtype == "f32") {
      v = reinterpret_cast<const float*>(a.data.data())[i];
    } else if (a.dtype == "bf16") {
      v = Bf16ToF32(reinterpret_cast<const uint16_t*>(a.data.data())[i]);
    }
    sum += v;
    sumsq += v * v;
  }
  std::printf("output[%d] dtype=%s dims=[", idx, a.dtype.c_str());
  for (size_t i = 0; i < a.dims.size(); ++i) std::printf("%s%lld", i ? "," : "", (long long)a.dims[i]);
  std::printf("] mean=%.6g rms=%.6g\n", n ? sum / n : 0.0, n ? std::sqrt(sumsq / n) : 0.0);
}

double Ms(std::chrono::steady_clock::time_point a, std::chrono::steady_clock::time_point b) {
  return std::chrono::duration<double, std::milli>(b - a).count();
}

}  // namespace

int main(int argc, char** argv) {
  std::string bundle_dir, dump_prefix, device = "cuda";
  std::map<int, std::string> feeds;
  int iters = 1, warmup = 0;
  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    auto val = [&](const char* prefix) { return arg.substr(std::strlen(prefix)); };
    if (arg.rfind("--bundle=", 0) == 0) {
      bundle_dir = val("--bundle=");
    } else if (arg.rfind("--device=", 0) == 0) {
      device = val("--device=");
    } else if (arg.rfind("--iters=", 0) == 0) {
      iters = std::atoi(val("--iters=").c_str());
    } else if (arg.rfind("--warmup=", 0) == 0) {
      warmup = std::atoi(val("--warmup=").c_str());
    } else if (arg.rfind("--dump=", 0) == 0) {
      dump_prefix = val("--dump=");
    } else if (arg.rfind("--feed=", 0) == 0) {
      std::string kv = val("--feed=");
      size_t colon = kv.find(':');
      if (colon == std::string::npos) {
        std::fprintf(stderr, "bad feed %s (IDX:FILE)\n", arg.c_str());
        return 2;
      }
      feeds[std::atoi(kv.substr(0, colon).c_str())] = kv.substr(colon + 1);
    } else {
      std::fprintf(stderr, "unknown arg %s\n", arg.c_str());
      return 2;
    }
  }
  if (bundle_dir.empty() || iters < 1 || warmup < 0) {
    std::fprintf(stderr,
                 "usage: bundle_runner --bundle=DIR [--device=cuda|cuda:N|cpu] [--feed=IDX:FILE]... "
                 "[--iters=N] [--warmup=N] [--dump=PREFIX]\n");
    return 2;
  }

  Bundle bundle;
  std::string error;
  if (!asvtorch::LoadBundle(bundle_dir, &bundle, &error)) {
    std::fprintf(stderr, "bundle: %s\n", error.c_str());
    return 1;
  }
  std::printf("bundle: %zu args, package %s, params %zu bytes\n", bundle.args.size(), bundle.package.c_str(),
              bundle.params.size());

  auto t0 = std::chrono::steady_clock::now();
  auto ex = CudaExecutor::Create(device, &error);
  if (!ex) {
    std::fprintf(stderr, "device: %s\n", error.c_str());
    return 1;
  }
  auto t1 = std::chrono::steady_clock::now();
  std::printf("device: %s (%.1f ms)\n", ex->device_name().c_str(), Ms(t0, t1));
  int handle = ex->LoadModule(bundle, &error);
  if (handle < 0) {
    std::fprintf(stderr, "load: %s\n", error.c_str());
    return 1;
  }
  auto t2 = std::chrono::steady_clock::now();
  std::printf("loaded: package and params resident (%.1f ms)\n", Ms(t1, t2));

  std::vector<HostArray> inputs;
  if (!asvtorch::MaterializeInputs(bundle, &inputs, &error)) {
    std::fprintf(stderr, "inputs: %s\n", error.c_str());
    return 1;
  }
  for (const auto& [idx, path] : feeds) {
    if (idx < 0 || static_cast<size_t>(idx) >= inputs.size() || bundle.args[idx].baked) {
      std::fprintf(stderr, "feed %d: no runtime argument with that index\n", idx);
      return 1;
    }
    bool ok = false;
    std::string raw = asvtorch::ReadFileToString(path, &ok);
    if (!ok || raw.size() != inputs[idx].data.size()) {
      std::fprintf(stderr, "arg %d: feed size %zu != %zu\n", idx, raw.size(), inputs[idx].data.size());
      return 1;
    }
    inputs[idx].data.assign(raw.begin(), raw.end());
  }

  // Baked (weight) arguments stay resident, as in serving.
  std::vector<bool> persistent(bundle.args.size(), false);
  for (size_t i = 0; i < bundle.args.size(); ++i) persistent[i] = bundle.args[i].baked;
  std::vector<HostArray> outputs;
  for (int i = 0; i < warmup; ++i) {
    if (!ex->ExecuteModule(handle, inputs, &outputs, &error, &persistent)) {
      std::fprintf(stderr, "execute(warmup): %s\n", error.c_str());
      return 1;
    }
  }
  auto before = asvtorch::OpLaunchCounts();
  double enqueue_s = 0, execute_s = 0, download_s = 0;
  auto t3 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    if (!ex->ExecuteModule(handle, inputs, &outputs, &error, &persistent)) {
      std::fprintf(stderr, "execute: %s\n", error.c_str());
      return 1;
    }
    enqueue_s += ex->last_stats().enqueue_s;
    execute_s += ex->last_stats().execute_s;
    download_s += ex->last_stats().download_s;
  }
  auto t4 = std::chrono::steady_clock::now();
  std::printf("execute: %.3f ms/iter (%d iters; enqueue %.3f, execute %.3f, download %.3f ms/iter)\n",
              Ms(t3, t4) / iters, iters, enqueue_s * 1e3 / iters, execute_s * 1e3 / iters,
              download_s * 1e3 / iters);
  for (size_t i = 0; i < outputs.size(); ++i) Summarize(outputs[i], static_cast<int>(i));
  auto after = asvtorch::OpLaunchCounts();
  std::printf("ops per call:");
  for (size_t i = 0; i < after.size(); ++i) {
    long long was = i < before.size() ? before[i].second : 0;
    std::printf(" %s=%g", after[i].first.c_str(), double(after[i].second - was) / iters);
  }
  std::printf("%s\n", after.empty() ? " (no kernel ops registered)" : "");
  std::printf("ops total:");  // every launch since the process started, warm-up included
  for (const auto& [op, n] : after) std::printf(" %s=%lld", op.c_str(), n);
  std::printf("\n");

  if (!dump_prefix.empty()) {
    for (size_t i = 0; i < outputs.size(); ++i) {
      std::string path = dump_prefix + std::to_string(i) + ".bin";
      std::ofstream f(path, std::ios::binary);
      f.write(reinterpret_cast<const char*>(outputs[i].data.data()), outputs[i].data.size());
      if (!f) {
        std::fprintf(stderr, "cannot write %s\n", path.c_str());
        return 1;
      }
      std::printf("wrote %s (%zu bytes)\n", path.c_str(), outputs[i].data.size());
    }
  }
  return 0;
}
