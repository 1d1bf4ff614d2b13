// libsevenn_exec: the C API of a deployed artifact (scripts/deploy.py)
// over libtorch's AOTInductor loader, for hosts without Python (the LAMMPS
// pair style lammps_pair/pair_sevennet_torch.cpp, or any C/C++/Fortran
// code). Counterpart of the JAX package's runtime/sevenn_exec.cpp (same
// functions, same arguments) and, built with -DSEVENN_EXEC_MAIN, of its
// file-protocol host runtime/pjrt_cpu_host.cpp.
//
// API (every function returns 0 on success, another code on failure):
//   sevenn_exec_init(artifact_dir)     load <dir>/model.pt2 on the device
//                                      meta.yaml names
//   sevenn_exec_capacity(&n_node, &n_edge)
//   sevenn_exec_run(z, edge_idx, edge_vec, edge_mask, node_mask,
//                   cell_volume, energy_out, forces_out, stress_out)
//   sevenn_exec_free()
//
// Input contract = signature.yaml: arrays padded to the deployed
// capacities; edge_idx int32 (2, n_edge) with row 0 the message
// destination; edge_vec float32 (n_edge, 3) = pos[src] - pos[dst] with the
// periodic shift; masks 1 on real entries. Padding edge_vec rows must be
// nonzero (use (1, 0, 0)): r = 0 puts a NaN through the radial basis that
// the mask does not remove. Padding atoms have Z = 0; their force rows come
// back zero. batch is all zeros and num_atoms n_node, as the JAX host fills
// them.
//
// On the card, init first makes sure the ops of the edge pair
// (sevenn_torch::conv_edge_fwd / _bwd, csrc/torch_ops.cpp) are in the
// dispatcher: when no library of the process has registered them, it opens
// <dir>/libsevenn_torch_ops.so, which opens the kernel libraries beside
// it. Nothing falls back to the CPU: a failure to load or to run returns
// its code (and prints the reason to stderr).
//
// Build (sevennet_exp_tpu_torch/native_build.py): g++ -shared against the
// installed PyTorch (headers, -ltorch -ltorch_cpu -lc10 [-ltorch_cuda]).
//
// With -DSEVENN_EXEC_MAIN it is a program:
//   sevenn_exec_host <artifact_dir>
//     reads  <dir>/inputs.manifest   lines: <bin> <dtype> <ndim> <dims...>
//                                    (dtype f32 or s32; row-major raw),
//                                    the program's inputs in signature order
//     writes <dir>/out_<i>.bin       one per program output
//     prints the ops' launches (fwd, bwd) when the shim is loaded

#include <ATen/ATen.h>
#include <ATen/core/dispatch/Dispatcher.h>
#include <dlfcn.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct State {
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  c10::Device device = c10::Device(c10::kCPU);
  int n_node = 0;
  int n_edge = 0;
};

State* g_state = nullptr;
void* g_ops = nullptr;   // the artifact's ops library, when init opened it

bool read_file(const std::string& path, std::string* out) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return false;
  std::ostringstream ss;
  ss << f.rdbuf();
  *out = ss.str();
  return true;
}

// minimal flat-yaml lookup: "<key>: <value>" at the start of a line
std::string yaml_value(const std::string& yaml, const std::string& key) {
  size_t pos = 0;
  while ((pos = yaml.find(key + ":", pos)) != std::string::npos) {
    if (pos == 0 || yaml[pos - 1] == '\n') {
      size_t a = pos + key.size() + 1;
      while (a < yaml.size() && yaml[a] == ' ') ++a;
      size_t b = yaml.find('\n', a);
      return yaml.substr(a, b == std::string::npos ? b : b - a);
    }
    pos += key.size();
  }
  return "";
}

bool ops_registered() {
  return c10::Dispatcher::singleton()
      .findSchema({"sevenn_torch::conv_edge_fwd", ""})
      .has_value();
}

}  // namespace

extern "C" {

int sevenn_exec_init(const char* artifact_dir) {
  if (g_state) return 1;
  const std::string dir(artifact_dir);
  std::string sig, meta;
  if (!read_file(dir + "/signature.yaml", &sig) ||
      !read_file(dir + "/meta.yaml", &meta)) {
    std::fprintf(stderr, "sevenn_exec: no signature.yaml / meta.yaml in %s\n",
                 dir.c_str());
    return 2;
  }
  auto st = std::make_unique<State>();
  st->n_node = std::atoi(yaml_value(sig, "n_node").c_str());
  st->n_edge = std::atoi(yaml_value(sig, "n_edge").c_str());
  if (st->n_node <= 0 || st->n_edge <= 0) return 3;
  const std::string device = yaml_value(meta, "device");
  if (device == "cuda") {
    if (!ops_registered()) {
      const std::string ops = dir + "/libsevenn_torch_ops.so";
      g_ops = dlopen(ops.c_str(), RTLD_NOW | RTLD_GLOBAL);
      if (g_ops == nullptr || !ops_registered()) {
        std::fprintf(stderr, "sevenn_exec: cannot load %s: %s\n",
                     ops.c_str(), g_ops ? "no ops registered" : dlerror());
        return 4;
      }
    }
    st->device = c10::Device(c10::kCUDA, 0);
  } else if (device != "cpu") {
    std::fprintf(stderr, "sevenn_exec: meta.yaml names device '%s'\n",
                 device.c_str());
    return 5;
  }
  try {
    st->loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        dir + "/model.pt2", "model", false, 1,
        st->device.is_cuda() ? 0 : -1);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "sevenn_exec: cannot load model.pt2: %s\n",
                 e.what());
    return 6;
  }
  g_state = st.release();
  return 0;
}

int sevenn_exec_capacity(int* n_node, int* n_edge) {
  if (!g_state) return 1;
  *n_node = g_state->n_node;
  *n_edge = g_state->n_edge;
  return 0;
}

int sevenn_exec_run(const int32_t* atomic_numbers,  // (n_node)
                    const int32_t* edge_idx,        // (2, n_edge)
                    const float* edge_vec,          // (n_edge, 3)
                    const float* edge_mask,         // (n_edge)
                    const float* node_mask,         // (n_node)
                    float cell_volume,
                    float* energy_out,              // (1)
                    float* forces_out,              // (n_node, 3)
                    float* stress_out) {            // (6)
  if (!g_state) return 1;
  State& st = *g_state;
  const int64_t nn = st.n_node, ne = st.n_edge;
  std::vector<int32_t> batch(nn, 0);
  float vol = cell_volume;
  int32_t natoms = static_cast<int32_t>(nn);
  const auto i32 = at::TensorOptions().dtype(at::kInt);
  const auto f32 = at::TensorOptions().dtype(at::kFloat);
  auto blob = [](const void* p, at::IntArrayRef dims,
                 const at::TensorOptions& o) {
    return at::from_blob(const_cast<void*>(p), dims, o);
  };
  try {
    // sorted-name order (signature.yaml): atomic_numbers, batch,
    // cell_volume, edge_index, edge_mask, edge_vec, node_mask, num_atoms
    std::vector<at::Tensor> inputs = {
        blob(atomic_numbers, {nn}, i32), blob(batch.data(), {nn}, i32),
        blob(&vol, {1}, f32),            blob(edge_idx, {2, ne}, i32),
        blob(edge_mask, {ne}, f32),      blob(edge_vec, {ne, 3}, f32),
        blob(node_mask, {nn}, f32),      blob(&natoms, {1}, i32)};
    for (auto& t : inputs) t = t.to(st.device);
    std::vector<at::Tensor> out = st.loader->run(inputs);
    if (out.size() != 3) return 7;
    float* dst[] = {energy_out, forces_out, stress_out};
    const int64_t numel[] = {1, 3 * nn, 6};
    for (int i = 0; i < 3; ++i) {
      at::Tensor h = out[i].to(at::kCPU).to(at::kFloat).contiguous();
      if (h.numel() != numel[i]) return 8;
      std::memcpy(dst[i], h.data_ptr<float>(), numel[i] * sizeof(float));
    }
  } catch (const std::exception& e) {
    std::fprintf(stderr, "sevenn_exec: run failed: %s\n", e.what());
    return 9;
  }
  return 0;
}

int sevenn_exec_free() {
  delete g_state;
  g_state = nullptr;
  return 0;
}

}  // extern "C"

#ifdef SEVENN_EXEC_MAIN

namespace {

struct InputSpec {
  std::string file;
  at::ScalarType type;
  std::vector<int64_t> dims;
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: sevenn_exec_host <artifact_dir>\n");
    return 2;
  }
  const std::string dir = argv[1];
  int err = sevenn_exec_init(dir.c_str());
  if (err != 0) {
    std::fprintf(stderr, "init failed (%d)\n", err);
    return 10 + err;
  }
  std::ifstream manifest(dir + "/inputs.manifest");
  if (!manifest) {
    std::fprintf(stderr, "cannot open %s/inputs.manifest\n", dir.c_str());
    return 1;
  }
  std::vector<InputSpec> specs;
  std::string line;
  while (std::getline(manifest, line)) {
    if (line.empty()) continue;
    std::istringstream ls(line);
    InputSpec s;
    std::string dtype;
    int ndim = 0;
    ls >> s.file >> dtype >> ndim;
    for (int i = 0; i < ndim; ++i) {
      int64_t d;
      ls >> d;
      s.dims.push_back(d);
    }
    if (dtype == "f32") {
      s.type = at::kFloat;
    } else if (dtype == "s32" || dtype == "i32") {
      s.type = at::kInt;
    } else {
      std::fprintf(stderr, "unsupported dtype %s\n", dtype.c_str());
      return 1;
    }
    specs.push_back(std::move(s));
  }
  std::vector<std::string> host(specs.size());
  std::vector<at::Tensor> inputs;
  for (size_t i = 0; i < specs.size(); ++i) {
    if (!read_file(dir + "/" + specs[i].file, &host[i])) {
      std::fprintf(stderr, "cannot open %s\n", specs[i].file.c_str());
      return 1;
    }
    at::Tensor t = at::from_blob(host[i].data(), specs[i].dims,
                                 at::TensorOptions().dtype(specs[i].type));
    if (static_cast<size_t>(t.nbytes()) != host[i].size()) {
      std::fprintf(stderr, "%s: %zu bytes, the manifest says %zu\n",
                   specs[i].file.c_str(), host[i].size(),
                   static_cast<size_t>(t.nbytes()));
      return 1;
    }
    inputs.push_back(t.to(g_state->device));
  }
  std::vector<at::Tensor> out;
  try {
    out = g_state->loader->run(inputs);
  } catch (const std::exception& e) {
    std::fprintf(stderr, "run failed: %s\n", e.what());
    return 1;
  }
  for (size_t i = 0; i < out.size(); ++i) {
    at::Tensor h = out[i].to(at::kCPU).contiguous();
    std::ofstream f(dir + "/out_" + std::to_string(i) + ".bin",
                    std::ios::binary);
    f.write(static_cast<const char*>(h.data_ptr()),
            static_cast<std::streamsize>(h.nbytes()));
    std::printf("out_%zu bytes=%zu\n", i, static_cast<size_t>(h.nbytes()));
  }
  auto launches = reinterpret_cast<void (*)(int64_t*)>(
      dlsym(RTLD_DEFAULT, "sevenn_torch_ops_launches"));
  if (launches != nullptr) {
    int64_t n[2] = {0, 0};
    launches(n);
    std::printf("launches fwd=%lld bwd=%lld\n",
                static_cast<long long>(n[0]), static_cast<long long>(n[1]));
  }
  sevenn_exec_free();
  std::printf("ok\n");
  return 0;
}

#endif  // SEVENN_EXEC_MAIN
