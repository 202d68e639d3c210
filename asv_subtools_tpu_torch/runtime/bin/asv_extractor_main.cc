// The port's native extractor: wav.scp -> fbank (C++, runtime/frontend) ->
// energy VAD -> submean over voiced frames -> embedding on the CUDA card
// (or the CPU) by the CudaExecutor over per-bucket bundles exported by
// asv_subtools_tpu_torch/export.py export_pjrt_embed_bundles -> text
// embeddings + RTF accounting. No Python in the process.
//
// Counterpart of the in-process path of runtime/bin/asv_extractor_main.cc
// (PjrtEmbedder, streaming and --streams, the batched pipelined mode), with
// the PJRT plugin replaced by the CudaExecutor. The socket mode (--port)
// stays with runtime/'s binary, which talks to the port's EmbeddingServer
// as it is.
//
//   asv_extractor_main --wav_scp SCP --bundles DIR [--device cuda|cuda:N|cpu]
//       [--output emb.txt] [--num_bins N] [--no_vad] [--no_submean]
//       [--warmup] [--threads N] [--streaming [--block_ms N] [--streams N]]
//
// DIR holds t<N>/ bundle directories (one per bucket, one shared params
// blob). The smallest bucket at or above an utterance's voiced frames is
// chosen, else the utterance is cut to the last one. The wire format is
// the dtype of the bundle's x argument: f32 as is, bf16 rounded to nearest
// even, s8 quantized per row and channel (scale = max|x[:, d]| / 127,
// rounding half away from zero) with the scales in the bundle's f32
// argument. Bundles with batch > 1 select the batched pipelined mode.
#include <dirent.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <memory>
#include <mutex>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

#include "../bundle.h"
#include "../cuda_executor.h"
#include "frontend/feature.h"
#include "frontend/feature_pipeline.h"
#include "frontend/wav.h"
#include "utils/blocking_queue.h"

using asvtpu::BlockingQueue;
using asvtpu::ComputeVadEnergy;
using asvtpu::FbankComputer;
using asvtpu::FbankOptions;
using asvtpu::FeaturePipeline;
using asvtpu::VadOptions;
using asvtpu::WavReader;
using asvtorch::HostArray;
using Clock = std::chrono::steady_clock;

// In-process embedding over per-bucket bundles: one executor (one card),
// one loaded package per bucket length, all reading one resident params
// blob. Per utterance the smallest bucket >= T is chosen and the features
// zero-padded with a matching boolean mask.
class CudaEmbedder {
 public:
  struct Bucket {
    int t = 0, dim = 0, batch = 1, handle = -1, x_slot = -1, mask_slot = -1;
    int scale_slot = -1;  // int8-wire bundles: per-row per-channel scales
    std::vector<HostArray> inputs;  // baked params + runtime slots
    std::vector<bool> persistent;   // baked args: resident on the device
  };

  static std::unique_ptr<CudaEmbedder> Create(const std::string& device, const std::string& bundles_dir,
                                              std::string* error) {
    std::unique_ptr<CudaEmbedder> e(new CudaEmbedder());
    DIR* d = ::opendir(bundles_dir.c_str());
    if (d == nullptr) {
      *error = "cannot open " + bundles_dir;
      return nullptr;
    }
    std::vector<std::pair<int, std::string>> dirs;
    while (dirent* ent = ::readdir(d)) {
      std::string name = ent->d_name;
      if (name.size() > 1 && name[0] == 't' && name.find_first_not_of("0123456789", 1) == std::string::npos)
        dirs.emplace_back(std::stoi(name.substr(1)), bundles_dir + "/" + name);
    }
    ::closedir(d);
    std::sort(dirs.begin(), dirs.end());
    if (dirs.empty()) {
      *error = "no t<N> bucket dirs in " + bundles_dir;
      return nullptr;
    }
    e->ex_ = asvtorch::CudaExecutor::Create(device, error);
    if (!e->ex_) return nullptr;
    for (auto& [t, dir] : dirs) {
      Bucket b;
      b.t = t;
      asvtorch::Bundle bundle;
      if (!asvtorch::LoadBundle(dir, &bundle, error)) return nullptr;
      b.handle = e->ex_->LoadModule(bundle, error);
      if (b.handle < 0) return nullptr;
      if (!asvtorch::MaterializeInputs(bundle, &b.inputs, error)) return nullptr;
      b.persistent.resize(bundle.args.size());
      for (size_t i = 0; i < bundle.args.size(); ++i) b.persistent[i] = bundle.args[i].baked;
      // x is the non-baked rank-3 arg; rank-2 pred is the mask; rank-2
      // f32 (int8-wire bundles) is the dequantization scale
      for (size_t i = 0; i < bundle.args.size(); ++i) {
        const auto& a = bundle.args[i];
        if (a.baked) continue;
        if (a.dims.size() == 3) b.x_slot = int(i);
        if (a.dims.size() == 2) (a.dtype == "pred" ? b.mask_slot : b.scale_slot) = int(i);
      }
      if (b.x_slot < 0 || b.mask_slot < 0) {
        *error = dir + ": no runtime feats/mask args";
        return nullptr;
      }
      b.dim = int(bundle.args[b.x_slot].dims[2]);
      b.batch = int(bundle.args[b.x_slot].dims[0]);
      e->buckets_.push_back(std::move(b));
    }
    return e;
  }

  Bucket* BucketFor(int t) {
    for (auto& cand : buckets_)
      if (cand.t >= t) return &cand;
    return &buckets_.back();  // cut to the largest bucket
  }
  // The frames of a T-frame utterance that the model embeds.
  int FramesEmbedded(int t) { return std::min(t, BucketFor(t)->t); }
  int batch_capacity() const { return buckets_.empty() ? 1 : buckets_[0].batch; }

  // One utterance per bucket row. items: (feats [t*dim], t). Returns one
  // embedding per item (an empty vector overall on error).
  std::vector<std::vector<float>> EmbedBatch(Bucket* b,
                                             const std::vector<std::pair<const std::vector<float>*, int>>& items,
                                             int dim, std::string* error) {
    if (dim != b->dim) {
      *error = "feat dim " + std::to_string(dim) + " != the bundle's " + std::to_string(b->dim);
      return {};
    }
    if (int(items.size()) > b->batch) {
      *error = "batch overflow";
      return {};
    }
    HostArray& x = b->inputs[b->x_slot];
    HostArray& m = b->inputs[b->mask_slot];
    std::fill(x.data.begin(), x.data.end(), 0);
    std::fill(m.data.begin(), m.data.end(), 0);
    size_t row_elems = size_t(b->t) * dim;
    const bool x_bf16 = (x.dtype == "bf16");
    const bool x_s8 = (x.dtype == "s8");
    if (!x_bf16 && !x_s8 && x.dtype != "f32") {
      *error = "unsupported feature wire " + x.dtype;
      return {};
    }
    float* scales = nullptr;
    if (x_s8) {
      if (b->scale_slot < 0) {
        *error = "s8 bundle without scale arg";
        return {};
      }
      HostArray& s = b->inputs[b->scale_slot];
      std::fill(s.data.begin(), s.data.end(), 0);
      scales = reinterpret_cast<float*>(s.data.data());
    }
    for (size_t r = 0; r < items.size(); ++r) {
      int use_t = std::min(items[r].second, b->t);
      const float* src = items[r].first->data();
      size_t n = size_t(use_t) * dim;
      if (x_s8) {
        float* row_scale = scales + r * dim;
        for (int t = 0; t < use_t; ++t) {
          const float* fr = src + size_t(t) * dim;
          for (int c = 0; c < dim; ++c) row_scale[c] = std::max(row_scale[c], std::fabs(fr[c]));
        }
        std::vector<float> inv(dim);
        for (int c = 0; c < dim; ++c) {
          row_scale[c] = std::max(row_scale[c], 1e-12f) / 127.0f;
          inv[c] = 1.0f / row_scale[c];
        }
        int8_t* dst = reinterpret_cast<int8_t*>(x.data.data()) + r * row_elems;
        for (int t = 0; t < use_t; ++t) {
          const float* fr = src + size_t(t) * dim;
          int8_t* dr = dst + size_t(t) * dim;
          for (int c = 0; c < dim; ++c) {
            float v = fr[c] * inv[c];
            dr[c] = int8_t(v >= 0 ? v + 0.5f : v - 0.5f);  // half away from zero
          }
        }
      } else if (x_bf16) {
        uint16_t* dst = reinterpret_cast<uint16_t*>(x.data.data()) + r * row_elems;
        for (size_t k = 0; k < n; ++k) {
          uint32_t bits;
          std::memcpy(&bits, &src[k], 4);
          bits += 0x7FFFu + ((bits >> 16) & 1u);  // round to nearest even
          dst[k] = uint16_t(bits >> 16);
        }
      } else {
        std::memcpy(x.data.data() + r * row_elems * 4, src, n * 4);
      }
      std::fill(m.data.begin() + r * b->t, m.data.begin() + r * b->t + use_t, 1);
    }
    std::vector<HostArray> outputs;
    if (!ex_->ExecuteModule(b->handle, b->inputs, &outputs, error, &b->persistent)) return {};
    if (outputs.empty() || outputs[0].dtype != "f32") {
      *error = "unexpected output";
      return {};
    }
    const float* p = reinterpret_cast<const float*>(outputs[0].data.data());
    size_t e_dim = outputs[0].num_elements() / size_t(b->batch);
    std::vector<std::vector<float>> out(items.size());
    for (size_t r = 0; r < items.size(); ++r) out[r].assign(p + r * e_dim, p + (r + 1) * e_dim);
    return out;
  }

  // feats: [t, dim] row-major; returns the embedding or empty on error.
  std::vector<float> Embed(const std::vector<float>& feats, int t, int dim, std::string* error) {
    auto out = EmbedBatch(BucketFor(t), {{&feats, t}}, dim, error);
    return out.empty() ? std::vector<float>() : std::move(out[0]);
  }

  // One execute per bucket, so that the first utterance does not pay the
  // package's first-run set-up.
  bool Warmup(std::string* error) {
    for (auto& b : buckets_) {
      std::vector<float> zeros(size_t(b.t) * b.dim, 0.0f);
      if (EmbedBatch(&b, {{&zeros, b.t}}, b.dim, error).empty()) return false;
    }
    return true;
  }

  const std::string& device() const { return ex_->device_name(); }
  size_t num_buckets() const { return buckets_.size(); }
  const asvtorch::ExecStats& stats() const { return ex_->last_stats(); }

 private:
  CudaEmbedder() = default;
  std::unique_ptr<asvtorch::CudaExecutor> ex_;
  std::vector<Bucket> buckets_;  // ascending t
};

// [T, 1+bins] features (energy in column 0) -> VAD-selected, submeaned
// [kept, dim-1]. Shared by the batch front end and the streaming path.
static void SelectAndNormalize(const std::vector<float>& feats, int dim, const VadOptions& vad_opts, bool do_vad,
                               bool do_submean, std::vector<float>* selected, int* kept_out, int* total_out) {
  int t_frames = int(feats.size()) / dim;
  std::vector<float> log_e(t_frames);
  for (int t = 0; t < t_frames; ++t) log_e[t] = feats[size_t(t) * dim];
  std::vector<uint8_t> voiced = do_vad ? ComputeVadEnergy(vad_opts, log_e) : std::vector<uint8_t>(t_frames, 1);
  int kept = 0;
  selected->clear();
  selected->reserve(feats.size());
  for (int t = 0; t < t_frames; ++t) {
    if (!voiced[t]) continue;
    for (int dd = 1; dd < dim; ++dd) selected->push_back(feats[size_t(t) * dim + dd]);
    ++kept;
  }
  int fdim = dim - 1;
  if (kept == 0) {  // fall back to all frames
    for (int t = 0; t < t_frames; ++t)
      for (int dd = 1; dd < dim; ++dd) selected->push_back(feats[size_t(t) * dim + dd]);
    kept = t_frames;
  }
  if (do_submean && kept > 0) {
    for (int dd = 0; dd < fdim; ++dd) {
      double mean = 0;
      for (int t = 0; t < kept; ++t) mean += (*selected)[size_t(t) * fdim + dd];
      mean /= kept;
      for (int t = 0; t < kept; ++t) (*selected)[size_t(t) * fdim + dd] -= float(mean);
    }
  }
  *kept_out = kept;
  *total_out = t_frames;
}

// wav path -> VAD-selected, submeaned features [kept, dim-1].
static bool ComputeSelectedFeats(const std::string& path, const FbankComputer& computer, const VadOptions& vad_opts,
                                 bool do_vad, bool do_submean, std::vector<float>* selected, int* kept_out,
                                 int* total_out, double* wav_s_out) {
  try {
    WavReader reader(path);
    std::vector<float> wav = reader.Channel(0);
    *wav_s_out = double(wav.size()) / reader.sample_rate();
    std::vector<float> feats = computer.Compute(wav);  // [T, 1+bins]
    SelectAndNormalize(feats, computer.Dim(), vad_opts, do_vad, do_submean, selected, kept_out, total_out);
  } catch (const std::exception& e) {
    std::cerr << path << ": " << e.what() << "\n";
    return false;
  }
  return true;
}

static std::vector<std::pair<std::string, std::string>> ReadScp(std::istream& scp) {
  std::vector<std::pair<std::string, std::string>> entries;
  std::string line;
  while (std::getline(scp, line)) {
    std::istringstream iss(line);
    std::string key, path;
    if (iss >> key >> path) entries.emplace_back(key, path);
  }
  return entries;
}

// The run's TOTAL line. wav_s counts the audio read; embedded_s counts
// the audio the model embedded (the voiced frames, cut to the largest
// bucket), and cut the utterances whose voiced frames were cut.
struct Totals {
  int utts = 0, failures = 0, cut = 0;
  double wav_s = 0, elapsed_s = 0;
  long long embedded_frames = 0;

  void Add(CudaEmbedder& embedder, int kept, double utt_wav_s) {
    int used = embedder.FramesEmbedded(kept);
    embedded_frames += used;
    cut += used < kept;
    wav_s += utt_wav_s;
  }
  void Print(double frame_shift_ms) const {
    std::cout << "TOTAL utts=" << utts << " failures=" << failures << " wav_s=" << wav_s
              << " embedded_s=" << double(embedded_frames) * frame_shift_ms * 1e-3 << " cut=" << cut
              << " elapsed_s=" << elapsed_s << " RTF=" << (wav_s > 0 ? elapsed_s / wav_s : 0) << "\n";
  }
};

// The kernels' launches through runtime/ops.cc over the whole run.
static void PrintOps() {
  std::cout << "OPS";
  for (const auto& [op, n] : asvtorch::OpLaunchCounts()) std::cout << " " << op << "=" << n;
  std::cout << "\n";
}

static void WriteEmbedding(std::ostream& out, const std::string& key, const std::vector<float>& emb) {
  out << key;
  for (float v : emb) out << " " << v;
  out << "\n";
}

int main(int argc, char** argv) {
  std::string wav_scp, out_path, bundles, device = "cuda";
  int num_bins = 80, frontend_threads = 8, block_ms = 200, streams = 1;
  bool do_vad = true, do_submean = true, warmup = false, streaming = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() {
      if (i + 1 >= argc) throw std::runtime_error(a + " takes a value");
      return std::string(argv[++i]);
    };
    try {
      if (a == "--wav_scp") wav_scp = next();
      else if (a == "--output") out_path = next();
      else if (a == "--bundles") bundles = next();
      else if (a == "--device") device = next();
      else if (a == "--num_bins") num_bins = std::stoi(next());
      else if (a == "--no_vad") do_vad = false;
      else if (a == "--no_submean") do_submean = false;
      else if (a == "--warmup") warmup = true;
      else if (a == "--streaming") streaming = true;
      else if (a == "--block_ms") block_ms = std::stoi(next());
      else if (a == "--streams") streams = std::stoi(next());
      else if (a == "--threads") frontend_threads = std::stoi(next());
      else if (a == "--port" || a == "--host") {
        std::cerr << "the socket mode is runtime/bin/asv_extractor_main's (it talks to the port's "
                     "EmbeddingServer); this binary embeds in-process\n";
        return 1;
      } else {
        std::cerr << "usage: asv_extractor_main --wav_scp SCP --bundles DIR [--device cuda|cuda:N|cpu]"
                  << " [--output emb.txt] [--num_bins N] [--no_vad] [--no_submean] [--warmup]"
                  << " [--threads N] [--streaming [--block_ms N] [--streams N]]\n";
        return 1;
      }
    } catch (const std::exception& e) {
      std::cerr << "bad argument " << a << ": " << e.what() << "\n";
      return 1;
    }
  }
  if (wav_scp.empty() || bundles.empty()) {
    std::cerr << "--wav_scp and --bundles are required\n";
    return 1;
  }

  std::string error;
  std::unique_ptr<CudaEmbedder> embedder = CudaEmbedder::Create(device, bundles, &error);
  if (!embedder) {
    std::cerr << "runtime: " << error << "\n";
    return 1;
  }
  std::cerr << "runtime: device=" << embedder->device() << " buckets=" << embedder->num_buckets()
            << " batch=" << embedder->batch_capacity() << "\n";
  if (warmup) {
    auto tw = Clock::now();
    if (!embedder->Warmup(&error)) {
      std::cerr << "warmup: " << error << "\n";
      return 1;
    }
    std::cerr << "runtime: warmup done (" << std::chrono::duration<double>(Clock::now() - tw).count() << " s)\n";
  }

  // fbank with energy in column 0 so that the VAD can use raw energies
  FbankOptions opts;
  opts.mel_opts.num_bins = num_bins;
  opts.use_energy = true;
  FbankComputer computer(opts);
  VadOptions vad_opts;
  const int dim = computer.Dim(), fdim = dim - 1;

  std::ifstream scp(wav_scp);
  if (!scp) {
    std::cerr << "cannot read " << wav_scp << "\n";
    return 1;
  }
  std::ofstream out;
  if (!out_path.empty()) out.open(out_path);
  const auto entries = ReadScp(scp);

  if (streaming) {
    // Per-utterance streaming serve: audio arrives in blocks, a
    // FeaturePipeline computes frames while a drain thread consumes them;
    // on the last block the VAD/submean selection and one execute produce
    // the embedding. The finalize latency (last block -> embedding) is
    // this mode's metric. --streams N runs N streams at once, the one
    // executor (one card) serialized by a mutex.
    std::atomic<size_t> next_utt{0};
    std::atomic<int> failures{0};
    std::mutex embed_mu, agg_mu;
    Totals totals;
    double stream_s = 0;
    std::vector<double> finalize_ms;
    auto t_all = Clock::now();
    auto stream_worker = [&]() {
      while (true) {
        size_t i = next_utt.fetch_add(1);
        if (i >= entries.size()) break;
        const std::string& key = entries[i].first;
        std::vector<float> wav;
        int rate = 0;
        try {
          WavReader reader(entries[i].second);
          wav = reader.Channel(0);
          rate = reader.sample_rate();
        } catch (const std::exception& e) {
          std::cerr << key << " FAILED " << e.what() << "\n";
          failures.fetch_add(1);
          continue;
        }
        double wav_s = double(wav.size()) / rate;
        int block = std::max(1, rate * block_ms / 1000);
        FeaturePipeline pipe(opts);
        std::vector<float> feats;  // [T, 1+bins], drained as it grows
        int t_frames = 0;
        std::thread drain([&]() {
          std::vector<float> fr;
          while (pipe.ReadOne(&fr)) {
            feats.insert(feats.end(), fr.begin(), fr.end());
            ++t_frames;
          }
        });
        auto t0 = Clock::now();
        for (size_t off = 0; off < wav.size(); off += size_t(block)) {
          size_t end = std::min(wav.size(), off + size_t(block));
          pipe.AcceptWaveform(std::vector<float>(wav.begin() + off, wav.begin() + end));
        }
        auto t_final0 = Clock::now();
        pipe.InputFinished();
        drain.join();
        std::vector<float> selected;
        int kept = 0, total = 0;
        SelectAndNormalize(feats, dim, vad_opts, do_vad, do_submean, &selected, &kept, &total);
        std::string err;
        std::vector<float> emb;
        {
          std::lock_guard<std::mutex> lk(embed_mu);
          emb = embedder->Embed(selected, kept, fdim, &err);
        }
        auto t_done = Clock::now();
        double s_s = std::chrono::duration<double>(t_final0 - t0).count();
        double f_s = std::chrono::duration<double>(t_done - t_final0).count();
        if (emb.empty()) {
          std::cerr << key << " FAILED " << err << "\n";
          failures.fetch_add(1);
          continue;
        }
        std::lock_guard<std::mutex> lk(agg_mu);
        stream_s += s_s;
        finalize_ms.push_back(f_s * 1e3);
        totals.Add(*embedder, kept, wav_s);
        if (streams == 1)
          std::cout << key << " frames=" << kept << "/" << t_frames << " stream_s=" << s_s
                    << " finalize_ms=" << f_s * 1e3 << "\n";
        if (out.is_open()) WriteEmbedding(out, key, emb);
        ++totals.utts;
      }
    };
    {
      std::vector<std::thread> workers;
      for (int i = 0; i < std::max(1, streams); ++i) workers.emplace_back(stream_worker);
      for (auto& w : workers) w.join();
    }
    double dt = std::chrono::duration<double>(Clock::now() - t_all).count();
    std::sort(finalize_ms.begin(), finalize_ms.end());
    auto pct = [&](double p) {
      return finalize_ms.empty() ? 0.0 : finalize_ms[size_t(p * double(finalize_ms.size() - 1))];
    };
    double fin_sum = 0;
    for (double v : finalize_ms) fin_sum += v;
    totals.failures = failures.load();
    totals.elapsed_s = dt;
    totals.Print(opts.frame_opts.frame_shift_ms);
    std::cout << "STREAMING streams=" << streams << " block_ms=" << block_ms
              << " agg_audio_s_per_s=" << (dt > 0 ? totals.wav_s / dt : 0)
              << " mean_finalize_ms=" << (totals.utts ? fin_sum / totals.utts : 0) << " p50_finalize_ms=" << pct(0.50)
              << " p95_finalize_ms=" << pct(0.95) << " frontend_stream_s=" << stream_s << "\n";
    PrintOps();
    return failures.load() == 0 ? 0 : 2;
  }

  if (embedder->batch_capacity() > 1) {
    // Batched pipelined mode (bundles exported with batch > 1): N front-end
    // threads (wav decode + fbank + VAD + submean) feed a bounded queue; the
    // consumer runs an execute whenever a bucket fills, so host feature work
    // overlaps the card's.
    auto t_all = Clock::now();
    struct Item {
      std::string key;
      std::vector<float> feats;
      int kept = 0, total = 0;
      double wav_s = 0;
    };
    std::atomic<size_t> next_entry{0};
    std::atomic<int> fe_failures{0};
    std::atomic<long> fe_nanos{0};  // summed front-end thread time
    BlockingQueue<Item> queue(size_t(std::max(1, frontend_threads)) * 8);
    auto worker = [&]() {
      FbankComputer wcomputer(opts);  // each worker owns a computer
      while (true) {
        size_t i = next_entry.fetch_add(1);
        if (i >= entries.size()) break;
        auto t0 = Clock::now();
        Item it;
        it.key = entries[i].first;
        if (!ComputeSelectedFeats(entries[i].second, wcomputer, vad_opts, do_vad, do_submean, &it.feats, &it.kept,
                                  &it.total, &it.wav_s)) {
          std::cerr << it.key << " FAILED frontend\n";
          fe_failures.fetch_add(1);
          continue;
        }
        fe_nanos.fetch_add(std::chrono::duration_cast<std::chrono::nanoseconds>(Clock::now() - t0).count());
        queue.Push(std::move(it));
      }
    };
    std::vector<std::thread> workers;
    for (int i = 0; i < std::max(1, frontend_threads); ++i) workers.emplace_back(worker);
    std::thread closer([&]() {
      for (auto& w : workers) w.join();
      queue.Finish();
    });

    std::map<int, std::vector<Item>> pending;  // bucket t -> items
    Totals totals;
    double pack_execute_s = 0, enqueue_s = 0, device_s = 0, download_s = 0;
    size_t upload_bytes = 0;
    int n_exec = 0, rows = 0;
    auto flush = [&](int bucket_t, std::vector<Item>& items_vec) {
      if (items_vec.empty()) return;
      auto* bucket = embedder->BucketFor(bucket_t);
      std::vector<std::pair<const std::vector<float>*, int>> batch_items;
      for (auto& it : items_vec) batch_items.push_back({&it.feats, it.kept});
      std::string err;
      auto tf0 = Clock::now();
      auto embs = embedder->EmbedBatch(bucket, batch_items, fdim, &err);
      pack_execute_s += std::chrono::duration<double>(Clock::now() - tf0).count();
      const auto& st = embedder->stats();
      enqueue_s += st.enqueue_s;
      device_s += st.execute_s;
      download_s += st.download_s;
      upload_bytes += st.upload_bytes;
      ++n_exec;
      rows += int(items_vec.size());
      if (embs.empty()) {
        std::cerr << "batch FAILED " << err << "\n";
        totals.failures += int(items_vec.size());
      } else {
        for (size_t j = 0; j < items_vec.size(); ++j) {
          if (out.is_open()) WriteEmbedding(out, items_vec[j].key, embs[j]);
          ++totals.utts;
        }
      }
      items_vec.clear();
    };
    while (auto item = queue.Pop()) {
      totals.Add(*embedder, item->kept, item->wav_s);
      int bt = embedder->BucketFor(item->kept)->t;
      auto& vec = pending[bt];
      vec.push_back(std::move(*item));
      if (int(vec.size()) >= embedder->BucketFor(bt)->batch) flush(bt, vec);
    }
    for (auto& [bt, vec] : pending) flush(bt, vec);
    closer.join();
    totals.failures += fe_failures.load();
    double dt = std::chrono::duration<double>(Clock::now() - t_all).count();
    double fe_s = double(fe_nanos.load()) * 1e-9;
    totals.elapsed_s = dt;
    totals.Print(opts.frame_opts.frame_shift_ms);
    std::cout << "BREAKDOWN threads=" << std::max(1, frontend_threads) << " frontend_cpu_s=" << fe_s
              << " pack_execute_s=" << pack_execute_s << " (enqueue_s=" << enqueue_s << " device_s=" << device_s
              << " download_s=" << download_s << ")"
              << " n_exec=" << n_exec << " rows=" << rows << " upload_mb=" << double(upload_bytes) / 1e6
              << " audio_s_per_s=" << (dt > 0 ? totals.wav_s / dt : 0) << "\n";
    PrintOps();
    return totals.failures == 0 ? 0 : 2;
  }

  // Per utterance.
  Totals totals;
  for (const auto& [key, path] : entries) {
    auto t0 = Clock::now();
    std::vector<float> selected;
    int kept = 0, t_frames = 0;
    double wav_s = 0;
    std::string embed_error = "frontend";
    std::vector<float> emb;
    if (ComputeSelectedFeats(path, computer, vad_opts, do_vad, do_submean, &selected, &kept, &t_frames, &wav_s))
      emb = embedder->Embed(selected, kept, fdim, &embed_error);
    double dt = std::chrono::duration<double>(Clock::now() - t0).count();
    totals.elapsed_s += dt;
    if (emb.empty()) {
      std::cerr << key << " FAILED " << embed_error << "\n";
      totals.wav_s += wav_s;
      ++totals.failures;
      continue;
    }
    totals.Add(*embedder, kept, wav_s);
    std::cout << key << " frames=" << kept << "/" << t_frames << " rtf=" << dt / wav_s << "\n";
    if (out.is_open()) WriteEmbedding(out, key, emb);
    ++totals.utts;
  }
  totals.Print(opts.frame_opts.frame_shift_ms);
  PrintOps();
  return totals.failures == 0 ? 0 : 2;
}
