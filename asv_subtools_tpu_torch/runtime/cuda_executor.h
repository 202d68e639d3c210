// Native executor of AOTInductor packages on the CUDA card (or the CPU):
// load one package per bucket, keep the baked arguments resident on the
// device, execute with host buffers. No Python in the process.
//
// Counterpart of runtime/pjrt/pjrt_executor.h: JAX compiles StableHLO
// through a PJRT plugin at load time; here the program was compiled ahead
// of time by asv_subtools_tpu_torch/export.py export_pjrt_bundle and is
// loaded by libtorch's AOTIModelPackageLoader. The header holds no torch
// type, so the binaries' own translation units build without libtorch's
// headers.
#ifndef ASVTORCH_RUNTIME_CUDA_EXECUTOR_H_
#define ASVTORCH_RUNTIME_CUDA_EXECUTOR_H_

#include <cstddef>
#include <memory>
#include <string>
#include <utility>
#include <vector>

#include "bundle.h"

namespace asvtorch {

// Per-execute stage timing (filled by ExecuteModule; read via last_stats()).
struct ExecStats {
  double enqueue_s = 0;       // staging copies and the H2D enqueue
  double execute_s = 0;       // the package's run until the stream is idle (H2D included)
  double download_s = 0;      // D2H of the outputs and the wait for it
  size_t upload_bytes = 0;    // runtime (non-resident) arguments this call
  size_t download_bytes = 0;  // outputs copied back
};

class CudaExecutor {
 public:
  ~CudaExecutor();

  // device: "cuda", "cuda:N" or "cpu". Fails (nullptr + error) when the
  // build has no CUDA or no card is visible: there is no CPU fallback. On
  // the card it turns TF32 off for the process: f32 is computed in f32.
  static std::unique_ptr<CudaExecutor> Create(const std::string& device, std::string* error);

  // Load the bundle's package on the executor's device and upload its
  // params blob once (one device buffer per distinct blob, shared by every
  // bundle that names it). Returns a module handle (>= 0), or -1.
  int LoadModule(const Bundle& bundle, std::string* error);

  // Execute module `handle` on host inputs (every argument, in order):
  // arguments go through pinned staging, copied asynchronously on the
  // executor's stream; outputs come back as contiguous host arrays.
  // `persistent` (optional, per argument) marks the baked arguments to
  // read from the resident params blob instead of uploading them (the
  // model weights in a serving loop). Not thread-safe: callers serialize.
  bool ExecuteModule(int handle, const std::vector<HostArray>& inputs, std::vector<HostArray>* outputs,
                     std::string* error, const std::vector<bool>* persistent = nullptr);

  const ExecStats& last_stats() const { return last_stats_; }
  // e.g. "cuda:0 NVIDIA H100 80GB HBM3" or "cpu"
  const std::string& device_name() const { return device_name_; }

 private:
  CudaExecutor();
  struct Impl;
  std::unique_ptr<Impl> impl_;
  ExecStats last_stats_;
  std::string device_name_;
};

// Launch counts of the kernels' C++ registrations (runtime/ops.cc), by op
// name; empty in a binary built without ops.cc.
std::vector<std::pair<std::string, long long>> OpLaunchCounts();
void CountOpLaunch(const char* op, long long n = 1);  // n = 0 registers the name

}  // namespace asvtorch

#endif  // ASVTORCH_RUNTIME_CUDA_EXECUTOR_H_
