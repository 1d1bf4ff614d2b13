// Three formulations of one CG instruction of the fused conv, the (2, 2, 2)
// uvu product at mul = 32, on NVIDIA Hopper (sm_90a), fp32 CUDA cores:
//   out[e, p * 32 + u] = sum_{m, n} w3j(m, n, p) x[e, m * 32 + u] y[e, n]
// x (E, 160), y (E, 5) -> out (E, 160).
//
// Replaces the TPU kernels of tools/bench_cg.py (kern_a, kern_b, kern_c,
// run through pl.pallas_call):
//
//   cg_a  per term: the nonzero terms (m, n, c), sorted by p, as kernel
//         parameters (constant memory, a broadcast per warp); one thread per
//         (row, channel u) sums them from the row's x and y in shared memory
//   cg_b  S = y @ C per row (C (5, 25), S[m * 5 + p]) into shared memory,
//         then out[p][u] = sum_m x[m][u] S[m][p]: a 5 x 5 product per channel
//   cg_c  S as in b, then St = S @ T, the tiled S row (T (25, 800) of ones,
//         St[p * 160 + m * 32 + u] = S[m][p]), in shared memory, then the
//         full-width product x * St per p and the sum over m
//
// What bounds them: bytes, 1,300 per row against 25 terms per channel (c:
// plus 20,000 multiply-adds per row for St, which the dense tiling product
// of the JAX formulation does on purpose). A warp owns one row (its 32
// lanes are the 32 channels), so every x and out access is a 128-byte line,
// y and S are broadcasts; 8 rows per block.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;
constexpr int ROWS = NT / 32;    // rows per block: one per warp
constexpr int MUL = 32, D = 5;   // channels, dim of l = 2
constexpr int W = MUL * D;       // x and out columns
constexpr int MAXT = 125;        // most terms: D^3

struct Terms {                   // kernel parameters: constant memory
  int off[D + 1];                // terms of component p: [off[p], off[p+1])
  int mn[MAXT];                  // m | n << 8
  float c[MAXT];
};

__global__ void __launch_bounds__(NT)
cg_a_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const Terms T, long E, float* __restrict__ out) {
  __shared__ float x_s[ROWS][W];
  __shared__ float y_s[ROWS][D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long e = (long)blockIdx.x * ROWS + warp;
  if (e >= E) return;            // whole warps: the block has no barrier
#pragma unroll
  for (int m = 0; m < D; ++m) x_s[warp][m * MUL + lane] = x[e * W + m * MUL + lane];
  if (lane < D) y_s[warp][lane] = y[e * D + lane];
  __syncwarp();
#pragma unroll
  for (int p = 0; p < D; ++p) {
    float s = 0.f;
    for (int t = T.off[p]; t < T.off[p + 1]; ++t) {
      const int mn = T.mn[t];
      s = fmaf(T.c[t] * x_s[warp][(mn & 0xff) * MUL + lane],
               y_s[warp][mn >> 8], s);
    }
    out[e * W + p * MUL + lane] = s;
  }
}

// S = y @ C for the warp's row, into s_row (25 floats); C from shared memory
__device__ __forceinline__ void s_row(const float* c_s, const float* y,
                                      long e, int lane, float* s_row) {
  if (lane < D * D) {
    float s = 0.f;
#pragma unroll
    for (int n = 0; n < D; ++n) s = fmaf(__ldg(y + e * D + n), c_s[n * D * D + lane], s);
    s_row[lane] = s;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NT)
cg_b_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ C, long E, float* __restrict__ out) {
  __shared__ float c_s[D * D * D];
  __shared__ float s_s[ROWS][D * D];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < D * D * D; i += NT) c_s[i] = C[i];
  __syncthreads();
  const long e = (long)blockIdx.x * ROWS + warp;
  if (e >= E) return;
  s_row(c_s, y, e, lane, s_s[warp]);
  float xv[D];
#pragma unroll
  for (int m = 0; m < D; ++m) xv[m] = x[e * W + m * MUL + lane];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    float acc = 0.f;
#pragma unroll
    for (int m = 0; m < D; ++m) acc = fmaf(xv[m], s_s[warp][m * D + p], acc);
    out[e * W + p * MUL + lane] = acc;
  }
}

__global__ void __launch_bounds__(NT)
cg_c_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ C, const float* __restrict__ Tt,
            long E, float* __restrict__ out) {
  __shared__ float c_s[D * D * D];
  __shared__ float s_s[ROWS][D * D];
  __shared__ float st_s[ROWS][D * W];        // the tiled S row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < D * D * D; i += NT) c_s[i] = C[i];
  __syncthreads();
  const long e = (long)blockIdx.x * ROWS + warp;
  if (e >= E) return;
  s_row(c_s, y, e, lane, s_s[warp]);
  // St = S @ T, the dense product the JAX formulation runs on its matrix
  // unit: T (25, 800) from L1 / L2, lanes on consecutive columns
  for (int col = lane; col < D * W; col += 32) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < D * D; ++k)
      s = fmaf(s_s[warp][k], __ldg(Tt + k * D * W + col), s);
    st_s[warp][col] = s;
  }
  __syncwarp();
  float xv[D];
#pragma unroll
  for (int m = 0; m < D; ++m) xv[m] = x[e * W + m * MUL + lane];
#pragma unroll
  for (int p = 0; p < D; ++p) {
    const float* st = st_s[warp] + p * W;
    float acc = xv[0] * st[lane];
#pragma unroll
    for (int m = 1; m < D; ++m) acc += xv[m] * st[m * MUL + lane];
    out[e * W + p * MUL + lane] = acc;
  }
}

bool valid(long E) { return E > 0 && (E + ROWS - 1) / ROWS < (1L << 31); }

unsigned blocks(long E) { return (unsigned)((E + ROWS - 1) / ROWS); }

}  // namespace

// n_terms <= 125 terms as (m | n << 8 | p << 16, c), sorted by p
extern "C" int cg_a(const float* x, const float* y, const int* idx,
                    const float* coef, int n_terms, long E, float* out,
                    void* stream) {
  if (!valid(E) || n_terms < 0 || n_terms > MAXT)
    return (int)cudaErrorInvalidValue;
  Terms T{};
  for (int t = 0; t < n_terms; ++t) {
    const int p = idx[t] >> 16;
    if (p < 0 || p >= D || (t > 0 && p < (idx[t - 1] >> 16)))
      return (int)cudaErrorInvalidValue;
    T.mn[t] = idx[t] & 0xffff;
    T.c[t] = coef[t];
  }
  for (int p = 0, t = 0; p <= D; ++p) {
    while (t < n_terms && (idx[t] >> 16) < p) ++t;
    T.off[p] = t;
  }
  cg_a_kernel<<<blocks(E), NT, 0, (cudaStream_t)stream>>>(x, y, T, E, out);
  return (int)cudaGetLastError();
}

// C (5, 25) row-major
extern "C" int cg_b(const float* x, const float* y, const float* C, long E,
                    float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  cg_b_kernel<<<blocks(E), NT, 0, (cudaStream_t)stream>>>(x, y, C, E, out);
  return (int)cudaGetLastError();
}

// C (5, 25), T (25, 800) row-major
extern "C" int cg_c(const float* x, const float* y, const float* C,
                    const float* T, long E, float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  cg_c_kernel<<<blocks(E), NT, 0, (cudaStream_t)stream>>>(x, y, C, T, E, out);
  return (int)cudaGetLastError();
}
