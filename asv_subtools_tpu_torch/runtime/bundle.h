// Native-runtime bundle loader shared by bundle_runner and the port's
// extractor (counterpart: runtime/pjrt/bundle.h). The format is written by
// asv_subtools_tpu_torch/export.py export_pjrt_bundle: JAX's manifest
// grammar for the arguments and the params blob, with a `package` line
// naming the AOTInductor package in place of `mlir` and `compile_options`.
#ifndef ASVTORCH_RUNTIME_BUNDLE_H_
#define ASVTORCH_RUNTIME_BUNDLE_H_

#include <cstdint>
#include <string>
#include <vector>

namespace asvtorch {

// Host-side array: dense row-major buffer + shape + dtype tag.
struct HostArray {
  std::string dtype;  // "f32" | "bf16" | "f16" | "f64" | "s32" | "s64" | "u8" | "u32" | "s8" | "pred"
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;

  size_t num_elements() const {
    size_t n = 1;
    for (int64_t d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

// Bytes of one element of a dtype tag; 0 for an unknown tag.
size_t DtypeBytes(const std::string& dtype);

struct ArgSpec {
  std::string dtype;
  bool baked = false;  // true: slice of the params blob; false: fed at run time
  uint64_t offset = 0;
  uint64_t nbytes = 0;
  std::vector<int64_t> dims;
};

struct Bundle {
  std::string package;      // path of the AOTInductor package (model.pt2)
  std::string params_path;  // canonical path of the params blob (shared across bundles)
  std::string params;       // the blob (empty when no argument is baked)
  std::vector<ArgSpec> args;
};

std::string ReadFileToString(const std::string& path, bool* ok);

// Load manifest.txt and the params blob from `dir`. Returns false + error.
bool LoadBundle(const std::string& dir, Bundle* b, std::string* error);

// Materialize the arguments of `b` into `inputs` (resized to all args):
// baked ones from the params blob, runtime ones zero-filled with their
// dims and dtype set.
bool MaterializeInputs(const Bundle& b, std::vector<HostArray>* inputs, std::string* error);

}  // namespace asvtorch

#endif  // ASVTORCH_RUNTIME_BUNDLE_H_
