#include "cuda_executor.h"

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <chrono>
#include <cstring>
#include <map>
#include <mutex>
#include <optional>

#ifdef ASV_WITH_CUDA
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

namespace asvtorch {

namespace {

using Clock = std::chrono::steady_clock;

double Seconds(Clock::time_point a, Clock::time_point b) {
  return std::chrono::duration<double>(b - a).count();
}

const std::map<std::string, at::ScalarType>& Types() {
  static const std::map<std::string, at::ScalarType> kTypes = {
      {"f32", at::kFloat}, {"bf16", at::kBFloat16}, {"f16", at::kHalf}, {"f64", at::kDouble},
      {"s32", at::kInt},   {"s64", at::kLong},      {"u8", at::kByte},  {"u32", at::kUInt32},
      {"s8", at::kChar},   {"pred", at::kBool}};
  return kTypes;
}

std::string TagOf(at::ScalarType t) {
  for (const auto& [tag, type] : Types())
    if (type == t) return tag;
  return "";
}

std::mutex& CountsMutex() {
  static std::mutex mu;
  return mu;
}

std::map<std::string, long long>& Counts() {
  static std::map<std::string, long long> counts;
  return counts;
}

}  // namespace

void CountOpLaunch(const char* op, long long n) {
  std::lock_guard<std::mutex> lk(CountsMutex());
  Counts()[op] += n;
}

std::vector<std::pair<std::string, long long>> OpLaunchCounts() {
  std::lock_guard<std::mutex> lk(CountsMutex());
  return {Counts().begin(), Counts().end()};
}

struct CudaExecutor::Impl {
  at::Device device{at::kCPU};
#ifdef ASV_WITH_CUDA
  std::optional<c10::cuda::CUDAStream> stream;
#endif
  struct Module {
    std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
    std::vector<ArgSpec> args;
    std::vector<at::Tensor> resident;   // per baked argument: its view of the resident blob
    std::vector<at::Tensor> staging;    // per argument: pinned host staging
    std::vector<at::Tensor> device_in;  // per argument: its device buffer
    std::vector<at::Tensor> host_out;  // per output: pinned host buffer
  };
  std::vector<Module> modules;
  std::map<std::string, at::Tensor> blobs;  // params path -> the blob on the device
};

CudaExecutor::CudaExecutor() : impl_(new Impl()) {}
CudaExecutor::~CudaExecutor() = default;

std::unique_ptr<CudaExecutor> CudaExecutor::Create(const std::string& device, std::string* error) {
  std::unique_ptr<CudaExecutor> ex(new CudaExecutor());
  if (device == "cpu") {
    ex->device_name_ = "cpu";
    return ex;
  }
  if (device != "cuda" && device.rfind("cuda:", 0) != 0) {
    *error = "unknown device '" + device + "' (cuda, cuda:N or cpu)";
    return nullptr;
  }
#ifndef ASV_WITH_CUDA
  *error = "device " + device +
           " requested, but this runtime was built without CUDA (no CUDA torch or no nvcc when it "
           "was built); pass --device=cpu to run on the CPU";
  return nullptr;
#else
  try {
    int count = c10::cuda::device_count();
    if (count == 0) {
      *error = "device " + device + " requested, but no CUDA device is visible";
      return nullptr;
    }
    int index = device == "cuda" ? 0 : std::stoi(device.substr(5));
    if (index < 0 || index >= count) {
      *error = "device " + device + " requested, but " + std::to_string(count) + " CUDA device(s) are visible";
      return nullptr;
    }
    // An f32 bundle computes in f32: libtorch would run its cuDNN
    // convolutions in TF32 by default.
    at::globalContext().setAllowTF32CuDNN(false);
    at::globalContext().setAllowTF32CuBLAS(false);
    c10::cuda::CUDAGuard guard(static_cast<c10::DeviceIndex>(index));
    ex->impl_->device = at::Device(at::kCUDA, static_cast<c10::DeviceIndex>(index));
    ex->impl_->stream = c10::cuda::getStreamFromPool(false, static_cast<c10::DeviceIndex>(index));
    ex->device_name_ = "cuda:" + std::to_string(index) + " " + at::cuda::getDeviceProperties(index)->name;
  } catch (const std::exception& e) {
    *error = e.what();
    return nullptr;
  }
  return ex;
#endif
}

int CudaExecutor::LoadModule(const Bundle& bundle, std::string* error) {
  Impl& im = *impl_;
  try {
    c10::DeviceIndex index = im.device.is_cuda() ? im.device.index() : -1;
#ifdef ASV_WITH_CUDA
    std::optional<c10::cuda::CUDAGuard> guard;
    if (im.device.is_cuda()) guard.emplace(index);
#endif
    Impl::Module m;
    m.loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(bundle.package, "model", false, 1, index);
    auto meta = m.loader->get_metadata();
    std::string compiled_for = meta.count("AOTI_DEVICE_KEY") ? meta["AOTI_DEVICE_KEY"] : "";
    std::string runs_on = im.device.is_cuda() ? "cuda" : "cpu";
    if (compiled_for != runs_on) {
      *error = bundle.package + " was compiled for '" + compiled_for + "'; this executor runs on " + runs_on;
      return -1;
    }
    size_t n = bundle.args.size();
    m.args = bundle.args;
    m.resident.resize(n);
    m.staging.resize(n);
    m.device_in.resize(n);
    for (size_t i = 0; i < n; ++i) {
      const ArgSpec& spec = bundle.args[i];
      if (!spec.baked) continue;
      auto blob = im.blobs.find(bundle.params_path);
      if (blob == im.blobs.end()) {  // one upload per distinct params file
        at::Tensor host = at::empty({static_cast<int64_t>(bundle.params.size())}, at::kByte);
        std::memcpy(host.data_ptr(), bundle.params.data(), bundle.params.size());
        blob = im.blobs.emplace(bundle.params_path, host.to(im.device)).first;
      }
      at::Tensor bytes = blob->second.slice(0, spec.offset, spec.offset + spec.nbytes);
      if (spec.offset % 16 != 0) bytes = bytes.clone();  // the package may assume aligned arguments
      m.resident[i] = bytes.view(Types().at(spec.dtype)).view(spec.dims);
    }
    im.modules.push_back(std::move(m));
    return static_cast<int>(im.modules.size()) - 1;
  } catch (const std::exception& e) {
    *error = bundle.package + ": " + e.what();
    return -1;
  }
}

bool CudaExecutor::ExecuteModule(int handle, const std::vector<HostArray>& inputs,
                                 std::vector<HostArray>* outputs, std::string* error,
                                 const std::vector<bool>* persistent) {
  Impl& im = *impl_;
  last_stats_ = ExecStats();
  if (handle < 0 || static_cast<size_t>(handle) >= im.modules.size()) {
    *error = "no module " + std::to_string(handle);
    return false;
  }
  Impl::Module& m = im.modules[handle];
  if (inputs.size() != m.args.size()) {
    *error = "module takes " + std::to_string(m.args.size()) + " arguments, got " + std::to_string(inputs.size());
    return false;
  }
  const bool cuda = im.device.is_cuda();
  try {
#ifdef ASV_WITH_CUDA
    std::optional<c10::cuda::CUDAStreamGuard> stream_guard;
    if (cuda) stream_guard.emplace(*im.stream);  // the kernels' ops launch on the current stream
#endif
    auto t0 = Clock::now();
    std::vector<at::Tensor> args(inputs.size());
    for (size_t i = 0; i < inputs.size(); ++i) {
      const HostArray& in = inputs[i];
      const ArgSpec& spec = m.args[i];
      if (persistent != nullptr && i < persistent->size() && (*persistent)[i] && m.resident[i].defined()) {
        args[i] = m.resident[i];
        continue;
      }
      size_t nbytes = in.num_elements() * DtypeBytes(spec.dtype);
      if (in.dtype != spec.dtype || in.dims != spec.dims || in.data.size() != nbytes) {
        *error = "arg " + std::to_string(i) + ": expected " + spec.dtype + " of " + std::to_string(nbytes) +
                 " bytes in the manifest's shape";
        return false;
      }
      auto options = at::TensorOptions().dtype(Types().at(spec.dtype));
      last_stats_.upload_bytes += nbytes;
      if (!cuda) {
        args[i] = at::from_blob(const_cast<uint8_t*>(in.data.data()), spec.dims, options);
        continue;
      }
      if (!m.staging[i].defined()) {
        m.staging[i] = at::empty(spec.dims, options.pinned_memory(true));
        m.device_in[i] = at::empty(spec.dims, options.device(im.device));
      }
      std::memcpy(m.staging[i].data_ptr(), in.data.data(), nbytes);
      m.device_in[i].copy_(m.staging[i], /*non_blocking=*/true);
      args[i] = m.device_in[i];
    }
    auto t1 = Clock::now();
#ifdef ASV_WITH_CUDA
    void* stream_handle = cuda ? static_cast<void*>(im.stream->stream()) : nullptr;
#else
    void* stream_handle = nullptr;
#endif
    std::vector<at::Tensor> outs = m.loader->run(args, stream_handle);
#ifdef ASV_WITH_CUDA
    if (cuda) im.stream->synchronize();
#endif
    auto t2 = Clock::now();
    std::vector<at::Tensor> host(outs.size());
    if (m.host_out.size() < outs.size()) m.host_out.resize(outs.size());
    for (size_t j = 0; j < outs.size(); ++j) {
      at::Tensor o = outs[j].contiguous();
      if (!cuda) {
        host[j] = o;
        continue;
      }
      at::Tensor& buf = m.host_out[j];
      if (!buf.defined() || buf.sizes() != o.sizes() || buf.scalar_type() != o.scalar_type())
        buf = at::empty(o.sizes(), at::TensorOptions().dtype(o.scalar_type()).pinned_memory(true));
      buf.copy_(o, /*non_blocking=*/true);
      host[j] = buf;
    }
#ifdef ASV_WITH_CUDA
    if (cuda) im.stream->synchronize();
#endif
    outputs->resize(outs.size());
    for (size_t j = 0; j < outs.size(); ++j) {
      HostArray& out = (*outputs)[j];
      out.dtype = TagOf(host[j].scalar_type());
      out.dims.assign(host[j].sizes().begin(), host[j].sizes().end());
      size_t nbytes = host[j].numel() * host[j].element_size();
      out.data.resize(nbytes);
      std::memcpy(out.data.data(), host[j].data_ptr(), nbytes);
      last_stats_.download_bytes += nbytes;
    }
    auto t3 = Clock::now();
    last_stats_.enqueue_s = Seconds(t0, t1);
    last_stats_.execute_s = Seconds(t1, t2);
    last_stats_.download_s = Seconds(t2, t3);
  } catch (const std::exception& e) {
    *error = e.what();
    return false;
  }
  return true;
}

}  // namespace asvtorch
