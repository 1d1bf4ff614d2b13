// The plan of the conv kernels and the host and device helpers around it,
// shared by the builds of fused_conv_geom.cu: the instruction, si2-group
// and x-entry records (ops/fused_conv.py builds them), Plan and its
// PLAN_ARGS / PLAN_CALL arguments, the tables' shared words and their
// load, the run-time activation, and the per-device reservation of a
// kernel's dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;       // radial MLP hidden width
constexpr int NT = 256;     // threads per block
constexpr int MAXD = 8;     // offsets per key in an instruction record

// instruction record (int32), one per live instruction
enum {
  I_XOFF = 0, I_MUL, I_SHOFF, I_WOFF, I_DIM1, I_DIM2, I_DIM3, I_AGG, I_K,
  I_COL0, I_POFF, I_NOFF = I_POFF + MAXD, I_MOFF = I_NOFF + MAXD,
  I_STRIDE = I_MOFF + MAXD
};
// si2 group record: K rows, mo outputs, components, output offset,
// offset in the aggregate buffer, offset in the flat si2 weights
enum { G_K = 0, G_MO, G_DIM3, G_OUT, G_AGG, G_WOFF, G_STRIDE };
// x entry record: offset, mul, dim, number of live users, first user
enum { X_OFF = 0, X_MUL, X_DIM, X_NINS, X_INS0, X_STRIDE };

struct Plan {
  const int* ins;        // n_ins * I_STRIDE
  const int* col_ins;    // n_active: live column -> instruction
  const int* col_w;      // n_active: live column -> MLP output column
  const int* nz_idx;     // m | n << 8 | p << 16
  const float* nz_coef;  // CG coefficient (path normalisation folded in)
  const int* grp;        // n_grp * G_STRIDE
  const float* grp_alpha;
  const int* xent;       // n_xent * X_STRIDE
  const int* xins;       // live instructions per x entry
  int n_atoms, D, d1, f, nb, wn, d_out;
  long n_rows;           // n_atoms * D (the edge pair: the list's rows)
  int n_ins, n_active, n_grp, n_xent, agg_dim, n_nz;
  int act;               // 0 silu, 1 tanh
  float act_cst, s0, s1, s2;   // normalize2mom constant, 1/sqrt(fan-in)
};

// words of shared memory the instruction and CG tables take, rounded up so
// that what follows is aligned to 16 bytes
__host__ __device__ inline int table_words(const Plan& P) {
  return (P.n_ins * I_STRIDE + 2 * P.n_nz + 3) & ~3;
}

// copy the instruction and CG tables into shared memory (not synced)
__device__ __forceinline__ void load_tables(const Plan& P, int* ins_s,
                                            int* nzi_s, float* nzc_s) {
  for (int i = threadIdx.x; i < P.n_ins * I_STRIDE; i += NT)
    ins_s[i] = P.ins[i];
  for (int i = threadIdx.x; i < P.n_nz; i += NT) {
    nzi_s[i] = P.nz_idx[i];
    nzc_s[i] = P.nz_coef[i];
  }
}

__device__ __forceinline__ float act_f(float x, int act) {
  if (act == 0) return x / (1.f + expf(-x));
  return tanhf(x);
}

Plan make_plan(const int* ins, const int* col_ins, const int* col_w,
               const int* nz_idx, const float* nz_coef, const int* grp,
               const float* grp_alpha, const int* xent, const int* xins,
               int n_atoms, int D, int d1, int f, int nb, int wn, int d_out,
               int n_ins, int n_active, int n_grp, int n_xent, int agg_dim,
               int n_nz, int act, float act_cst, float s0, float s1,
               float s2) {
  Plan P;
  P.ins = ins; P.col_ins = col_ins; P.col_w = col_w; P.nz_idx = nz_idx;
  P.nz_coef = nz_coef; P.grp = grp; P.grp_alpha = grp_alpha;
  P.xent = xent; P.xins = xins;
  P.n_rows = (long)n_atoms * D;
  P.n_atoms = n_atoms; P.D = D; P.d1 = d1; P.f = f; P.nb = nb; P.wn = wn;
  P.d_out = d_out; P.n_ins = n_ins; P.n_active = n_active;
  P.n_grp = n_grp; P.n_xent = n_xent; P.agg_dim = agg_dim; P.n_nz = n_nz;
  P.act = act; P.act_cst = act_cst; P.s0 = s0; P.s1 = s1; P.s2 = s2;
  return P;
}

// raise a kernel's dynamic shared-memory limit on the current device
// only when a launch needs more than it was last given (reserved: one
// entry per device, kept by the caller per kernel)
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
static cudaError_t reserve_smem(Kernel kernel, size_t bytes,
                                size_t* reserved) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) reserved[dev] = bytes;
  return err;
}

}  // namespace

#define PLAN_ARGS                                                          \
  const int *ins, const int *col_ins, const int *col_w, const int *nz_idx, \
      const float *nz_coef, const int *grp, const float *grp_alpha,        \
      const int *xent, const int *xins, int n_atoms, int D, int d1, int f, \
      int nb, int wn, int d_out, int n_ins, int n_active, int n_grp,       \
      int n_xent, int agg_dim, int n_nz, int act, float act_cst, float s0, \
      float s1, float s2
#define PLAN_CALL                                                          \
  make_plan(ins, col_ins, col_w, nz_idx, nz_coef, grp, grp_alpha, xent,    \
            xins, n_atoms, D, d1, f, nb, wn, d_out, n_ins, n_active,       \
            n_grp, n_xent, agg_dim, n_nz, act, act_cst, s0, s1, s2)
