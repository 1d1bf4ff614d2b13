// The edge-row pair of csrc/fused_conv_geom.cu (kernels 1-2 at agg_d = 0,
// C entries fused_conv_edge_fwd / fused_conv_edge_bwd) as PyTorch
// dispatcher ops, so that a traced graph, an AOTInductor artifact and a
// C++ host without Python launch the same kernels as the calculator:
//
//   sevenn_torch::conv_edge_fwd(xg, sh, emb, ms, w0, w1, w1t, w2, w2t,
//                               si2, si2t, <9 tables>, int[] dims) -> y
//   sevenn_torch::conv_edge_bwd(g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t,
//                               si2, si2t, <9 tables>, int[] dims)
//       -> (dxg, dsh, demb)
//
// The weights are FusedConv._pack's layouts, the tables FusedConv's
// kernel tables (ins, col_ins, col_w, nz_idx, nz_coef, grp, grp_alpha,
// xent, xins), and dims FusedConv._dims (14 ints, then the 4 floats
// act_cst, s0, s1, s2 as their float32 bit patterns). Only a CUDA
// implementation is registered here; the shapes (register_fake) are
// registered by ops/torch_ops.py. The ops carry no gradient: the port
// calls them inside fused_conv._FusedConvFn, whose backward launches
// conv_edge_bwd, and a traced graph records both.
//
// The source includes no CUDA header, so that it compiles against a
// CPU-only PyTorch too (the schemas then load, and a CUDA tensor cannot
// occur). The stream is the current one of the tensors' device, taken
// through c10::Stream::native_handle(). The kernel libraries are opened
// at the first launch, each by dlopen(RTLD_LOCAL): the default build
// (silu, tanh) and the shifted-softplus build export the same names. Their
// paths are set by sevenn_torch_ops_set_library; unset, they are
// libfused_conv_geom.so and libfused_conv_geom_ssp.so beside this library
// (the layout of a deployed artifact's directory).

#include <ATen/ATen.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <dlfcn.h>
#include <torch/library.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace {

constexpr int N_INT = 14;    // n_atoms, D, d1, f, nb, wn, d_out, n_ins,
                             // n_active, n_grp, n_xent, agg_dim, n_nz, act
constexpr int N_DIMS = N_INT + 4;
constexpr int ACT_SSP = 2;   // fused_conv._ACT_CODE['ssp']

using P = const void*;
using FwdFn = int (*)(P, P, P, P, P, P, P, P,                 // xg .. si2
                      P, P, P, P, P, P, P, P, P,              // tables
                      int, int, int, int, int, int, int, int, int, int, int,
                      int, int, int, float, float, float, float, void*,
                      void*);
using BwdFn = int (*)(P, P, P, P, P, P, P, P, P, P, P,        // g .. si2t
                      P, P, P, P, P, P, P, P, P,              // tables
                      int, int, int, int, int, int, int, int, int, int, int,
                      int, int, int, float, float, float, float, void*,
                      void*, void*, void*);

struct Kernels {
  void* handle = nullptr;
  FwdFn fwd = nullptr;
  BwdFn bwd = nullptr;
};

std::mutex g_mutex;
std::string g_paths[2];
Kernels g_kernels[2];
std::atomic<int64_t> g_launches[2];   // fwd, bwd

std::string default_path(int which) {
  Dl_info info;
  std::string dir = ".";
  if (dladdr(reinterpret_cast<void*>(&default_path), &info) != 0 &&
      info.dli_fname != nullptr) {
    dir = info.dli_fname;
    const auto slash = dir.rfind('/');
    dir = slash == std::string::npos ? "." : dir.substr(0, slash);
  }
  return dir + (which ? "/libfused_conv_geom_ssp.so"
                      : "/libfused_conv_geom.so");
}

Kernels kernels(int act) {
  const int which = act == ACT_SSP ? 1 : 0;
  std::lock_guard<std::mutex> lock(g_mutex);
  Kernels& k = g_kernels[which];
  if (k.handle == nullptr) {
    const std::string path =
        g_paths[which].empty() ? default_path(which) : g_paths[which];
    void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    TORCH_CHECK(h != nullptr, "sevenn_torch: cannot open the kernel library ",
                path, ": ", dlerror());
    auto fwd = reinterpret_cast<FwdFn>(dlsym(h, "fused_conv_edge_fwd"));
    auto bwd = reinterpret_cast<BwdFn>(dlsym(h, "fused_conv_edge_bwd"));
    TORCH_CHECK(fwd != nullptr && bwd != nullptr, "sevenn_torch: ", path,
                " lacks fused_conv_edge_fwd / fused_conv_edge_bwd");
    k.handle = h;
    k.fwd = fwd;
    k.bwd = bwd;
  }
  return k;
}

struct Dims {
  int i[N_INT];
  float f[4];
};

Dims read_dims(at::IntArrayRef dims, const at::Tensor& xg) {
  TORCH_CHECK(static_cast<int>(dims.size()) == N_DIMS, "sevenn_torch: dims "
              "has ", dims.size(), " entries, not ", N_DIMS);
  Dims d;
  for (int k = 0; k < N_INT; ++k) d.i[k] = static_cast<int>(dims[k]);
  for (int k = 0; k < 4; ++k) {
    const auto bits = static_cast<uint32_t>(dims[N_INT + k]);
    std::memcpy(&d.f[k], &bits, sizeof(float));
  }
  TORCH_CHECK(d.i[1] == 1, "sevenn_torch: the edge pair takes D = 1");
  TORCH_CHECK(d.i[0] == xg.size(0), "sevenn_torch: dims names ", d.i[0],
              " rows, xg has ", xg.size(0));
  return d;
}

void check_rows(const at::Tensor& t, int64_t rows, int64_t width,
                const char* name) {
  TORCH_CHECK(t.dim() == 2 && t.size(0) == rows && t.size(1) == width,
              "sevenn_torch: ", name, " has shape ", t.sizes(), ", not (",
              rows, ", ", width, ")");
}

void check_tensors(const at::Tensor& first,
                   std::initializer_list<const at::Tensor*> rest) {
  for (const at::Tensor* t : rest) {
    TORCH_CHECK(t->device() == first.device(),
                "sevenn_torch: tensors on several devices");
    TORCH_CHECK(t->is_contiguous(), "sevenn_torch: a tensor is not "
                "contiguous");
  }
}

void* current_stream(const at::Tensor& t) {
  const auto* impl = c10::impl::getDeviceGuardImpl(t.device().type());
  return impl->getStream(t.device()).native_handle();
}

#define DIM_CALL(d)                                                         \
  d.i[0], d.i[1], d.i[2], d.i[3], d.i[4], d.i[5], d.i[6], d.i[7], d.i[8],  \
      d.i[9], d.i[10], d.i[11], d.i[12], d.i[13], d.f[0], d.f[1], d.f[2],  \
      d.f[3]
#define TABLE_CALL                                                        \
  ins.data_ptr(), col_ins.data_ptr(), col_w.data_ptr(), nz_idx.data_ptr(), \
      nz_coef.data_ptr(), grp.data_ptr(), grp_alpha.data_ptr(),            \
      xent.data_ptr(), xins.data_ptr()
#define TABLE_ARGS                                                         \
  const at::Tensor &ins, const at::Tensor &col_ins, const at::Tensor &col_w, \
      const at::Tensor &nz_idx, const at::Tensor &nz_coef,                  \
      const at::Tensor &grp, const at::Tensor &grp_alpha,                   \
      const at::Tensor &xent, const at::Tensor &xins
#define TABLE_LIST &ins, &col_ins, &col_w, &nz_idx, &nz_coef, &grp, \
      &grp_alpha, &xent, &xins

void check_inputs(const at::Tensor& xg, const at::Tensor& sh,
                  const at::Tensor& emb, const at::Tensor& ms,
                  const Dims& d) {
  const int64_t rows = xg.size(0);
  check_rows(xg, rows, d.i[2], "xg");
  check_rows(sh, rows, d.i[3], "sh");
  check_rows(emb, rows, d.i[4], "emb");
  check_rows(ms, rows, 1, "ms");
  for (const at::Tensor* t : {&xg, &sh, &emb, &ms})
    TORCH_CHECK(t->scalar_type() == at::kFloat,
                "sevenn_torch: the edge pair takes float32 rows");
}

at::Tensor conv_edge_fwd_cuda(
    const at::Tensor& xg, const at::Tensor& sh, const at::Tensor& emb,
    const at::Tensor& ms, const at::Tensor& w0, const at::Tensor& w1,
    const at::Tensor& w1t, const at::Tensor& w2, const at::Tensor& w2t,
    const at::Tensor& si2, const at::Tensor& si2t, TABLE_ARGS,
    at::IntArrayRef dims) {
  const Dims d = read_dims(dims, xg);
  check_inputs(xg, sh, emb, ms, d);
  check_tensors(xg, {&sh, &emb, &ms, &w0, &w1, &w1t, &w2, &w2t, &si2, &si2t,
                     TABLE_LIST});
  c10::DeviceGuard guard(xg.device());
  at::Tensor out = at::empty({xg.size(0), d.i[6]}, xg.options());
  const Kernels k = kernels(d.i[13]);
  const int err = k.fwd(xg.data_ptr(), sh.data_ptr(), emb.data_ptr(),
                        ms.data_ptr(), w0.data_ptr(), w1.data_ptr(),
                        w2.data_ptr(), si2.data_ptr(), TABLE_CALL,
                        DIM_CALL(d), out.data_ptr(), current_stream(xg));
  TORCH_CHECK(err == 0, "sevenn_torch::conv_edge_fwd: CUDA error ", err);
  g_launches[0] += 1;
  return out;
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> conv_edge_bwd_cuda(
    const at::Tensor& g, const at::Tensor& xg, const at::Tensor& sh,
    const at::Tensor& emb, const at::Tensor& ms, const at::Tensor& w0,
    const at::Tensor& w1, const at::Tensor& w1t, const at::Tensor& w2,
    const at::Tensor& w2t, const at::Tensor& si2, const at::Tensor& si2t,
    TABLE_ARGS, at::IntArrayRef dims) {
  const Dims d = read_dims(dims, xg);
  check_inputs(xg, sh, emb, ms, d);
  check_rows(g, xg.size(0), d.i[6], "g");
  TORCH_CHECK(g.scalar_type() == at::kFloat, "sevenn_torch: g is not "
              "float32");
  check_tensors(xg, {&g, &sh, &emb, &ms, &w0, &w1, &w1t, &w2, &w2t, &si2,
                     &si2t, TABLE_LIST});
  c10::DeviceGuard guard(xg.device());
  at::Tensor dxg = at::empty_like(xg);
  at::Tensor dsh = at::empty_like(sh);
  at::Tensor demb = at::empty_like(emb);
  const Kernels k = kernels(d.i[13]);
  const int err = k.bwd(g.data_ptr(), xg.data_ptr(), sh.data_ptr(),
                        emb.data_ptr(), ms.data_ptr(), w0.data_ptr(),
                        w1.data_ptr(), w1t.data_ptr(), w2.data_ptr(),
                        w2t.data_ptr(), si2t.data_ptr(), TABLE_CALL,
                        DIM_CALL(d), dxg.data_ptr(), dsh.data_ptr(),
                        demb.data_ptr(), current_stream(xg));
  TORCH_CHECK(err == 0, "sevenn_torch::conv_edge_bwd: CUDA error ", err);
  g_launches[1] += 1;
  return {dxg, dsh, demb};
}

#define TABLE_SCHEMA                                                     \
  "Tensor ins, Tensor col_ins, Tensor col_w, Tensor nz_idx, "            \
  "Tensor nz_coef, Tensor grp, Tensor grp_alpha, Tensor xent, "          \
  "Tensor xins, int[] dims"
#define WEIGHT_SCHEMA                                                    \
  "Tensor w0, Tensor w1, Tensor w1t, Tensor w2, Tensor w2t, Tensor si2, " \
  "Tensor si2t, "

}  // namespace

TORCH_LIBRARY(sevenn_torch, m) {
  m.def("conv_edge_fwd(Tensor xg, Tensor sh, Tensor emb, Tensor ms, "
        WEIGHT_SCHEMA TABLE_SCHEMA ") -> Tensor");
  m.def("conv_edge_bwd(Tensor g, Tensor xg, Tensor sh, Tensor emb, "
        "Tensor ms, " WEIGHT_SCHEMA TABLE_SCHEMA
        ") -> (Tensor, Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(sevenn_torch, CUDA, m) {
  m.impl("conv_edge_fwd", &conv_edge_fwd_cuda);
  m.impl("conv_edge_bwd", &conv_edge_bwd_cuda);
}

extern "C" {

// Path of a kernel library: which = 0 the default build
// (libfused_conv_geom), 1 the shifted-softplus build. The next launch opens
// it; a library opened before stays loaded (its launches may be in
// flight), so an A/B of two builds can switch between them.
int sevenn_torch_ops_set_library(int which, const char* path) {
  if (which < 0 || which > 1 || path == nullptr) return 2;
  std::lock_guard<std::mutex> lock(g_mutex);
  if (g_paths[which] != path) {
    g_paths[which] = path;
    g_kernels[which] = Kernels();
  }
  return 0;
}

// The ops' launches since the library was loaded: out[0] forward,
// out[1] backward.
void sevenn_torch_ops_launches(int64_t* out) {
  out[0] = g_launches[0].load();
  out[1] = g_launches[1].load();
}

}  // extern "C"
