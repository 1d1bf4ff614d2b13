// CG contraction of one i1 class of the 7net-0 mid-layer uvu tensor product
// (every instruction that reads the same x entry), three formulations, on
// NVIDIA Hopper (sm_90a), fp32 CUDA cores (no TF32).
//
// Replaces the TPU kernels of tools/bench_cgmxu.py (run through
// pl.pallas_call): st_kernel, outer_kernel and dots_kernel. Feature-major
// layouts, as there: rows (k, p, u), columns are edges --
//   xT (d1 * mul, E), shT (f, E), wT (n_ins * mul, E) -> out (d3tot * mul, E)
// with out[(r, u), b] = w[(ins(r), u), b] * sum CG(r; m, n) x[(m, u), b]
// sh[n, b], r = row_k + p running over the class's (instruction, component).
//
//   cgmxu_st     the per-instruction CT tables: S[p][m] = sum_n CT[n][p][m]
//                sh[so + n] (the JAX St = CT^T sh, without its copy per
//                channel u), then per p the product with x and the sum
//                over m, then x the radial weight
//   cgmxu_outer  Z[(m, n), (u, b)] = x[(m, u), b] sh[n, b] built in shared
//                memory, then the one dense CG product C (d3tot, d1 f) @ Z,
//                then x w
//   cgmxu_dots   the product alone: Z at no build cost (x[0, b] in every
//                row and channel), C @ Z, and the JAX write pattern -- all
//                zeros but rows 0..d3tot-1 = out0(u = 0) + out0(u = mul-1)
//
// What bounds them: bytes. A row of i1 = 1 reads 585 floats and writes 1,280
// against 50 CG terms per channel (st) or 540 dense multiply-adds (outer);
// at E = 32,768 that is ~244 MB, ~0.07 ms at 3.35 TB/s. The design: a warp
// owns 32 consecutive edges of one channel u, so every load and store of a
// row is one 128-byte line; the 8 warps of a block take 8 channels of the
// same edges, so sh (and for st, the tables) is read once per block into L1
// or shared memory. A thread owns one (u, edge) column and keeps its
// d3tot sums in registers (outer, dots: a tile product 1 x d3tot per thread,
// C from shared memory as a broadcast). Tensor cores (3xTF32) are for the
// redesign; this is the fp32 baseline the JAX tool asked about.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int EB = 32;         // edges per block: one warp's lanes
constexpr int US = NT / EB;    // channels u per block: one per warp
constexpr int MAXR = 32;       // most (instruction, component) rows
constexpr int MAXF = 16;       // most filter components
// instruction record of st: sh offset, d2, d3, first row r, table offset
enum { R_SO = 0, R_D2, R_D3, R_ROW, R_TAB, R_STRIDE };

struct Cls {
  int mul, d1, f, n_ins, d3tot, tab_len;
  long E;
};

__global__ void __launch_bounds__(NT)
cgmxu_st_kernel(const float* __restrict__ xT, const float* __restrict__ shT,
                const float* __restrict__ wT, const int* __restrict__ ins,
                const float* __restrict__ tab, Cls C,
                float* __restrict__ out) {
  extern __shared__ float sm[];
  float* tab_s = sm;                                    // tab_len
  int* ins_s = reinterpret_cast<int*>(tab_s + C.tab_len);   // n_ins records
  float* x_s = reinterpret_cast<float*>(ins_s + C.n_ins * R_STRIDE);
  float* sh_s = x_s + C.d1 * NT;                        // this thread: [i * NT]
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b = (long)blockIdx.x * EB + lane;
  const int u = blockIdx.y * US + slot;
  for (int i = tid; i < C.tab_len; i += NT) tab_s[i] = tab[i];
  for (int i = tid; i < C.n_ins * R_STRIDE; i += NT) ins_s[i] = ins[i];
  for (int m = 0; m < C.d1; ++m)
    x_s[m * NT + tid] = xT[((long)m * C.mul + u) * C.E + b];
  for (int n = 0; n < C.f; ++n) sh_s[n * NT + tid] = shT[n * C.E + b];
  __syncthreads();
  for (int k = 0; k < C.n_ins; ++k) {
    const int* R = ins_s + k * R_STRIDE;
    const int so = R[R_SO], d2 = R[R_D2], d3 = R[R_D3], row = R[R_ROW];
    const float* T = tab_s + R[R_TAB];                  // [n][p][m]
    const float w = wT[((long)k * C.mul + u) * C.E + b];
    for (int p = 0; p < d3; ++p) {
      float acc = 0.f;
      for (int m = 0; m < C.d1; ++m) {
        float s = 0.f;
        for (int n = 0; n < d2; ++n)
          s = fmaf(T[(n * d3 + p) * C.d1 + m], sh_s[(so + n) * NT + tid], s);
        acc = fmaf(x_s[m * NT + tid], s, acc);
      }
      out[((long)(row + p) * C.mul + u) * C.E + b] = acc * w;
    }
  }
}

__global__ void __launch_bounds__(NT)
cgmxu_outer_kernel(const float* __restrict__ xT,
                   const float* __restrict__ shT,
                   const float* __restrict__ wT,
                   const int* __restrict__ row_ins,
                   const float* __restrict__ cg, Cls C,
                   float* __restrict__ out) {
  extern __shared__ float sm[];
  const int K = C.d1 * C.f;
  float* c_s = sm;                                       // d3tot * K
  int* ri_s = reinterpret_cast<int*>(c_s + C.d3tot * K);    // d3tot
  float* z_s = reinterpret_cast<float*>(ri_s + C.d3tot);    // K columns of NT
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b = (long)blockIdx.x * EB + lane;
  const int u = blockIdx.y * US + slot;
  for (int i = tid; i < C.d3tot * K; i += NT) c_s[i] = cg[i];
  for (int i = tid; i < C.d3tot; i += NT) ri_s[i] = row_ins[i];
  float sh[MAXF];
#pragma unroll
  for (int n = 0; n < MAXF; ++n)
    if (n < C.f) sh[n] = shT[n * C.E + b];
  for (int m = 0; m < C.d1; ++m) {
    const float x = xT[((long)m * C.mul + u) * C.E + b];
#pragma unroll
    for (int n = 0; n < MAXF; ++n)
      if (n < C.f) z_s[(m * C.f + n) * NT + tid] = x * sh[n];
  }
  __syncthreads();
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int j = 0; j < K; ++j) {
    const float z = z_s[j * NT + tid];
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < C.d3tot) acc[r] = fmaf(c_s[r * K + j], z, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < MAXR; ++r)
    if (r < C.d3tot)
      out[((long)r * C.mul + u) * C.E + b] =
          acc[r] * wT[((long)ri_s[r] * C.mul + u) * C.E + b];
}

// channels of a block: slots 0..US/2-1 take u = US/2 * blockIdx.y + i, the
// others mul - 1 - that, so that u = 0 and u = mul - 1 meet in block 0
__global__ void __launch_bounds__(NT)
cgmxu_dots_kernel(const float* __restrict__ xT, const float* __restrict__ cg,
                  Cls C, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int K = C.d1 * C.f;
  float* c_s = sm;                     // d3tot * K
  float* ex_s = c_s + C.d3tot * K;     // d3tot x EB: out0 of u = mul - 1
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b = (long)blockIdx.x * EB + lane;
  const int half = US / 2, base = half * blockIdx.y;
  const int u = slot < half ? base + slot : C.mul - 1 - (base + slot - half);
  for (int i = tid; i < C.d3tot * K; i += NT) c_s[i] = cg[i];
  __syncthreads();
  const float z = xT[b];
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;
  for (int j = 0; j < K; ++j) {
#pragma unroll
    for (int r = 0; r < MAXR; ++r)
      if (r < C.d3tot) acc[r] = fmaf(c_s[r * K + j], z, acc[r]);
  }
  if (blockIdx.y == 0) {
    if (u == C.mul - 1) {
#pragma unroll
      for (int r = 0; r < MAXR; ++r)
        if (r < C.d3tot) ex_s[r * EB + lane] = acc[r];
    }
    __syncthreads();
  }
  // rows 0..d3tot-1 (channel u < d3tot of row group 0) get the sums from
  // u = 0; every other row of the column is zero, written by its owner as
  // its own sum times 0 so that the product stays whole in every thread
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    if (r >= C.d3tot) continue;
    if (u == 0) out[(long)r * C.E + b] = acc[r] + ex_s[r * EB + lane];
    if (r > 0 || u >= C.d3tot)
      out[((long)r * C.mul + u) * C.E + b] = acc[r] * 0.f;
  }
}

constexpr int MAX_DEVICES = 64;
size_t reserved[3][MAX_DEVICES];

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* res) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= res[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) res[dev] = bytes;
  return err;
}

Cls make_cls(int mul, int d1, int f, int n_ins, int d3tot, int tab_len,
             long E) {
  Cls C;
  C.mul = mul; C.d1 = d1; C.f = f; C.n_ins = n_ins; C.d3tot = d3tot;
  C.tab_len = tab_len; C.E = E;
  return C;
}

bool valid(const Cls& C) {
  return C.E > 0 && C.E % EB == 0 && C.mul % US == 0 && C.d3tot <= MAXR &&
         C.d3tot <= C.mul && C.f <= MAXF;
}

}  // namespace

#define CLS_ARGS int mul, int d1, int f, int n_ins, int d3tot, long E
#define CLS_CALL(tab_len) make_cls(mul, d1, f, n_ins, d3tot, tab_len, E)

// E a multiple of 32, mul of 8, d3tot <= min(32, mul), f <= 16
extern "C" int cgmxu_st(const float* xT, const float* shT, const float* wT,
                        const int* ins, const float* tab, int tab_len,
                        CLS_ARGS, float* out, void* stream) {
  const Cls C = CLS_CALL(tab_len);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)tab_len + n_ins * R_STRIDE +
                                       (size_t)(d1 + f) * NT);
  const cudaError_t err = reserve_smem(cgmxu_st_kernel, smem, reserved[0]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(E / EB), mul / US);
  cgmxu_st_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(xT, shT, wT, ins,
                                                            tab, C, out);
  return (int)cudaGetLastError();
}

extern "C" int cgmxu_outer(const float* xT, const float* shT, const float* wT,
                           const int* row_ins, const float* cg, CLS_ARGS,
                           float* out, void* stream) {
  const Cls C = CLS_CALL(0);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)d3tot * (d1 * f + 1) +
                                       (size_t)d1 * f * NT);
  const cudaError_t err =
      reserve_smem(cgmxu_outer_kernel, smem, reserved[1]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(E / EB), mul / US);
  cgmxu_outer_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      xT, shT, wT, row_ins, cg, C, out);
  return (int)cudaGetLastError();
}

extern "C" int cgmxu_dots(const float* xT, const float* cg, CLS_ARGS,
                          float* out, void* stream) {
  const Cls C = CLS_CALL(0);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)d3tot * (d1 * f + EB));
  const cudaError_t err = reserve_smem(cgmxu_dots_kernel, smem, reserved[2]);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(E / EB), mul / US);
  cgmxu_dots_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(xT, cg, C, out);
  return (int)cudaGetLastError();
}
