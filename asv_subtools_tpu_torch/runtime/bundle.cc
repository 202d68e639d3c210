#include "bundle.h"

#include <climits>
#include <cstdlib>
#include <fstream>
#include <map>
#include <sstream>

namespace asvtorch {

size_t DtypeBytes(const std::string& dtype) {
  static const std::map<std::string, size_t> kBytes = {
      {"f32", 4}, {"bf16", 2}, {"f16", 2}, {"f64", 8}, {"s32", 4},
      {"s64", 8}, {"u8", 1},   {"u32", 4}, {"s8", 1},  {"pred", 1}};
  auto it = kBytes.find(dtype);
  return it == kBytes.end() ? 0 : it->second;
}

std::string ReadFileToString(const std::string& path, bool* ok) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    *ok = false;
    return "";
  }
  std::ostringstream ss;
  ss << f.rdbuf();
  *ok = true;
  return ss.str();
}

static std::string Canonical(const std::string& path) {
  char buf[PATH_MAX];
  return ::realpath(path.c_str(), buf) != nullptr ? std::string(buf) : path;
}

bool LoadBundle(const std::string& dir, Bundle* b, std::string* error) {
  bool ok = false;
  std::string manifest = ReadFileToString(dir + "/manifest.txt", &ok);
  if (!ok) {
    *error = "cannot read " + dir + "/manifest.txt";
    return false;
  }
  std::string package_file, params_file = "params.bin";
  std::istringstream lines(manifest);
  std::string line;
  while (std::getline(lines, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ls(line);
    std::string kind;
    ls >> kind;
    if (kind == "package") {
      ls >> package_file;
    } else if (kind == "params") {
      ls >> params_file;
    } else if (kind == "arg") {
      int idx = -1;
      ArgSpec spec;
      std::string source;
      size_t ndim = 0;
      ls >> idx >> spec.dtype >> source >> spec.offset >> spec.nbytes >> ndim;
      spec.baked = (source == "param");
      spec.dims.resize(ndim);
      for (size_t i = 0; i < ndim; ++i) ls >> spec.dims[i];
      if (!ls || static_cast<size_t>(idx) != b->args.size()) {
        *error = dir + ": bad or out-of-order arg line: " + line;
        return false;
      }
      if (DtypeBytes(spec.dtype) == 0) {
        *error = dir + ": unknown dtype " + spec.dtype;
        return false;
      }
      b->args.push_back(spec);
    } else if (kind == "mlir" || kind == "compile_options") {
      *error = dir + ": a PJRT (StableHLO) bundle; this runtime serves AOTInductor packages";
      return false;
    }
  }
  if (package_file.empty()) {
    *error = dir + ": manifest names no package";
    return false;
  }
  b->package = dir + "/" + package_file;
  std::ifstream probe(b->package, std::ios::binary);
  if (!probe) {
    *error = "cannot read " + b->package;
    return false;
  }
  b->params_path = Canonical(dir + "/" + params_file);
  bool any_baked = false;
  for (const auto& a : b->args) any_baked |= a.baked;
  if (any_baked) {
    b->params = ReadFileToString(b->params_path, &ok);
    if (!ok) {
      *error = "cannot read " + b->params_path;
      return false;
    }
  }
  return true;
}

bool MaterializeInputs(const Bundle& b, std::vector<HostArray>* inputs, std::string* error) {
  inputs->clear();
  inputs->resize(b.args.size());
  for (size_t i = 0; i < b.args.size(); ++i) {
    const ArgSpec& spec = b.args[i];
    HostArray& in = (*inputs)[i];
    in.dtype = spec.dtype;
    in.dims = spec.dims;
    size_t want = in.num_elements() * DtypeBytes(spec.dtype);
    if (spec.baked) {
      if (spec.offset + spec.nbytes > b.params.size() || spec.nbytes != want) {
        *error = "arg " + std::to_string(i) + ": bad params range";
        return false;
      }
      in.data.assign(b.params.begin() + spec.offset, b.params.begin() + spec.offset + spec.nbytes);
    } else {
      in.data.assign(want, 0);
    }
  }
  return true;
}

}  // namespace asvtorch
