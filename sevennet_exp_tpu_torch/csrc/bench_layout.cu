// Three layouts of one elementwise sliced multiply-add on NVIDIA Hopper
// (sm_90a), fp32 CUDA cores: R = 24 passes over 16 slices of 32 channels,
//   out[e, u] = sum_{r < 24} sum_{s < 16} x[e, 32 s + u] y[e, 32 s + u]
// x, y (E, 512) -> out (E, 32), accumulated pass by pass, slice by slice,
// in that order, as the JAX kernels do.
//
// Replaces the TPU kernels of tools/bench_layout.py (rowmajor_kernel,
// colmajor_kernel, transpose_kernel, run through pl.pallas_call over 128
// blocks of 256 edge rows):
//
//   layout_rowmajor    edge-major: one thread per (e, u), a warp on the 32
//                      channels of one row, so each slice access is one
//                      128-byte line
//   layout_colmajor    the tool's feature-major inputs x_cm =
//                      x.T.reshape(G 512, 256): block i's 512 rows hold
//                      features 4i..4i+3 over all edges, 256 at a time, and
//                      out[32 i + u, b] = sum_r sum_s x_cm[512 i + 32 s + u,
//                      b] y_cm[...]; one thread per (output row, b), a warp
//                      along b
//   layout_transpose   edge-major inputs, one transpose in and one out
//                      through shared memory: a block stages 32 rows x 128
//                      columns of x and y at a time (rows padded by one
//                      float against bank conflicts), each thread then owns
//                      (u, e) with a warp along e, and the (32, 32) output
//                      tile goes back through shared memory so that it is
//                      written along u
//
// What bounds them: bytes (138 MB a launch: 2 x 32768 x 512 x 4 read, 32768
// x 32 x 4 written) against 402.7 M multiply-adds. Every x and y value is
// read once from device memory, coalesced; the 24 passes reuse registers.
// No fast math: the passes are not reassociated, so all 24 x 16 FFMAs of an
// output are issued (cuobjdump -sass counts them, tools/sass_compare.py).

#include <cuda_runtime.h>

namespace {

constexpr int MUL = 32, NSLICE = 16, R = 24;
constexpr int D = MUL * NSLICE;          // 512 columns
constexpr int B = 256;                   // col-major: edges per block row
constexpr int NT = 256;
constexpr int TR = 32;                   // transpose: edge rows per block
constexpr int PIECE = 4;                 // transpose: slices staged at once
constexpr int PW = PIECE * MUL;          // 128 columns per piece

__device__ __forceinline__ float passes(const float (&xv)[NSLICE],
                                        const float (&yv)[NSLICE]) {
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < NSLICE; ++s) acc = fmaf(xv[s], yv[s], acc);
  }
  return acc;
}

__global__ void __launch_bounds__(NT)
layout_rowmajor_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       long E, float* __restrict__ out) {
  const long e = (long)blockIdx.x * (NT / MUL) + threadIdx.x / MUL;
  const int u = threadIdx.x % MUL;
  if (e >= E) return;
  float xv[NSLICE], yv[NSLICE];
#pragma unroll
  for (int s = 0; s < NSLICE; ++s) {
    xv[s] = x[e * D + s * MUL + u];
    yv[s] = y[e * D + s * MUL + u];
  }
  out[e * MUL + u] = passes(xv, yv);
}

// x_cm, y_cm (G D, B); out (G MUL, B); one block per output row
__global__ void __launch_bounds__(B)
layout_colmajor_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       float* __restrict__ out) {
  const long orow = blockIdx.x;                 // 32 i + u
  const long i = orow / MUL, u = orow % MUL;
  const int b = threadIdx.x;
  float xv[NSLICE], yv[NSLICE];
#pragma unroll
  for (int s = 0; s < NSLICE; ++s) {
    const long row = i * D + s * MUL + u;
    xv[s] = x[row * B + b];
    yv[s] = y[row * B + b];
  }
  out[orow * B + b] = passes(xv, yv);
}

// E % 32 == 0; 1024 threads: warp w = channel u, lane = edge row in the tile
__global__ void __launch_bounds__(TR * MUL)
layout_transpose_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        float* __restrict__ out) {
  __shared__ float x_s[TR][PW + 1];
  __shared__ float y_s[TR][PW + 1];
  __shared__ float o_s[TR][MUL + 1];
  const int tid = threadIdx.x, lane = tid % 32, u = tid / 32;
  const long e0 = (long)blockIdx.x * TR;
  float xv[NSLICE], yv[NSLICE];
#pragma unroll
  for (int piece = 0; piece < NSLICE / PIECE; ++piece) {
    // in: the rows' columns [128 piece, 128 piece + 128), along the row
#pragma unroll
    for (int k = tid; k < TR * PW; k += TR * MUL) {
      const int row = k / PW, col = k % PW;
      x_s[row][col] = x[(e0 + row) * D + piece * PW + col];
      y_s[row][col] = y[(e0 + row) * D + piece * PW + col];
    }
    __syncthreads();
    // transposed read: lane = edge row, column 32 s + u
#pragma unroll
    for (int s = 0; s < PIECE; ++s) {
      xv[piece * PIECE + s] = x_s[lane][s * MUL + u];
      yv[piece * PIECE + s] = y_s[lane][s * MUL + u];
    }
    __syncthreads();
  }
  o_s[lane][u] = passes(xv, yv);
  __syncthreads();
  // out: warp u' writes row e0 + u' along its 32 channels
  out[(e0 + u) * MUL + lane] = o_s[u][lane];
}

}  // namespace

// x, y (E, 512) row-major -> out (E, 32)
extern "C" int layout_rowmajor(const float* x, const float* y, long E,
                               float* out, void* stream) {
  const long blocks = (E + NT / MUL - 1) / (NT / MUL);
  if (E <= 0 || blocks >= (1L << 31)) return (int)cudaErrorInvalidValue;
  layout_rowmajor_kernel<<<(unsigned)blocks, NT, 0, (cudaStream_t)stream>>>(
      x, y, E, out);
  return (int)cudaGetLastError();
}

// x_cm, y_cm (G 512, 256) -> out (G 32, 256)
extern "C" int layout_colmajor(const float* x, const float* y, long G,
                               float* out, void* stream) {
  if (G <= 0 || G * MUL >= (1L << 31)) return (int)cudaErrorInvalidValue;
  layout_colmajor_kernel<<<(unsigned)(G * MUL), B, 0, (cudaStream_t)stream>>>(
      x, y, out);
  return (int)cudaGetLastError();
}

// x, y (E, 512) row-major -> out (E, 32); E a multiple of 32
extern "C" int layout_transpose(const float* x, const float* y, long E,
                                float* out, void* stream) {
  if (E <= 0 || E % TR || E / TR >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  layout_transpose_kernel<<<(unsigned)(E / TR), TR * MUL, 0,
                            (cudaStream_t)stream>>>(x, y, out);
  return (int)cudaGetLastError();
}
