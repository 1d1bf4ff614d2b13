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
//                      through shared memory: each thread owns (edge row
//                      = lane, channel u) and reads its operands across
//                      the staged rows, as the JAX kernel's .T; the (32,
//                      32) output tile goes back through shared memory so
//                      that it is written along u, as whole 128-byte lines
//
// What bounds them: bytes (138 MB a launch: 2 x 32768 x 512 x 4 read, 32768
// x 32 x 4 written) against 402.7 M multiply-adds. Every x and y value is
// read once from device memory, coalesced; the 24 passes reuse registers.
// No fast math: the passes are not reassociated, so all 24 x 16 FFMAs of an
// output are issued (cuobjdump -sass counts them, tools/sass_compare.py),
// in the row-major kernel's order: transpose gives its output bit for bit.
//
// The transpose kernel's first form staged each block's 32 rows in 4
// pieces behind two barriers each, with no load in flight while it ran its
// passes or wrote its tile (1,024-thread blocks, 3.9 waves): 48.5 % of the
// byte bound. Now one persistent block an SM walks 32-row tiles (tile
// blockIdx.x, + gridDim.x, ...), and a 5-stage ring of pieces (32 rows x 128
// columns of x and of y, 32 KB) is filled by cp.async, the next 4 pieces (a
// whole tile) in flight while a tile's passes run: one barrier a piece, the
// ring being 160 KB of the SM's shared memory (6 stages measured no faster). Stage rows are unpadded (16-byte
// copies); a thread's channel is u = (warp + lane) mod 32, so the 32 lanes
// of a warp read 32 rows in 32 distinct banks, and write the output tile
// likewise. cp.async rather than TMA: a piece is 32 row segments of 512
// bytes 2 KB apart, one 16-byte copy per thread and tensor, and the
// threads that copy are the ones that wait, so no mbarrier is needed.
// Where x or y is not 16-byte aligned the same kernel copies single floats
// (4-byte cp.async), chosen per launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_util.cuh"

namespace {

constexpr int MUL = 32, NSLICE = 16, R = 24;
constexpr int D = MUL * NSLICE;          // 512 columns
constexpr int B = 256;                   // col-major: edges per block row
constexpr int NT = 256;
constexpr int TR = 32;                   // transpose: edge rows per tile
constexpr int PIECE = 4;                 // transpose: slices a piece holds
constexpr int PW = PIECE * MUL;          // 128 columns per piece
constexpr int NPIECE = NSLICE / PIECE;   // 4 pieces a tile
constexpr int STAGES = 5;                // ring stages (pieces)
constexpr int STAGE_F = 2 * TR * PW;     // floats a stage: x and y
constexpr int TT = TR * MUL;             // transpose: threads, one output each
constexpr size_t T_SMEM = sizeof(float) * (STAGES * STAGE_F + TT);

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(d),
               "l"(src));
}

// piece `piece` of tile `tile` into a ring stage: x then y, row-major
// (TR rows of PW floats), in copies of V floats (V = 4: one 16-byte copy
// per thread and tensor)
template <int V>
__device__ __forceinline__ void load_piece(float* st,
                                           const float* __restrict__ x,
                                           const float* __restrict__ y,
                                           long tile, int piece, int tid) {
#pragma unroll
  for (int c = tid; c < TR * PW / V; c += TT) {
    const int row = c / (PW / V), q = c % (PW / V);
    const long at = (tile * TR + row) * D + piece * PW + V * q;
    if constexpr (V == 4) {
      cp_async16(st + row * PW + V * q, x + at);
      cp_async16(st + TR * PW + row * PW + V * q, y + at);
    } else {
      cp_async4(st + row * PW + V * q, x + at);
      cp_async4(st + TR * PW + row * PW + V * q, y + at);
    }
  }
}

// n_tiles tiles of 32 rows; TT threads: lane = edge row in the tile,
// channel u = (warp + lane) mod 32; vec: x and y 16-byte aligned
__global__ void __launch_bounds__(TT, 1)
layout_transpose_kernel(const float* __restrict__ x,
                        const float* __restrict__ y, long n_tiles, bool vec,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];
  float* o_s = ring + STAGES * STAGE_F;
  const int tid = threadIdx.x, lane = tid % 32, u = (tid / 32 + lane) % MUL;
  const long my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const long n_pieces = my_tiles * NPIECE;
  auto issue = [&](long j) {     // piece j of this block, or an empty group
    if (j < n_pieces) {
      float* st = ring + (j % STAGES) * STAGE_F;
      const long tile = blockIdx.x + (j / NPIECE) * (long)gridDim.x;
      if (vec)
        load_piece<4>(st, x, y, tile, (int)(j % NPIECE), tid);
      else
        load_piece<1>(st, x, y, tile, (int)(j % NPIECE), tid);
    }
    asm volatile("cp.async.commit_group;");
  };
  for (int j = 0; j < STAGES - 1; ++j) issue(j);
  float xv[NSLICE], yv[NSLICE];
  for (long t = 0; t < my_tiles; ++t) {
#pragma unroll
    for (int piece = 0; piece < NPIECE; ++piece) {
      const long j = t * NPIECE + piece;
      // piece j has landed, and every thread is done with stage j - 1
      asm volatile("cp.async.wait_group %0;" :: "n"(STAGES - 2) : "memory");
      __syncthreads();
      issue(j + STAGES - 1);
      // transposed read: lane = edge row, column 32 s + u
      const float* st = ring + (j % STAGES) * STAGE_F;
#pragma unroll
      for (int s = 0; s < PIECE; ++s) {
        xv[piece * PIECE + s] = st[lane * PW + s * MUL + u];
        yv[piece * PIECE + s] = st[TR * PW + lane * PW + s * MUL + u];
      }
    }
    o_s[lane * MUL + u] = passes(xv, yv);
    __syncthreads();
    // out: the tile's 32 rows of 32 channels, contiguous, along u
    out[(blockIdx.x + t * gridDim.x) * (long)(TR * MUL) + tid] = o_s[tid];
  }
}

launch_util::Resident transpose_resident;

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
  const long tiles = E / TR;
  unsigned grid = 0;
  const cudaError_t err = launch_util::persistent_grid(
      layout_transpose_kernel, TT, T_SMEM, tiles, transpose_resident, &grid);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((uintptr_t)x | (uintptr_t)y) % 16 == 0;
  layout_transpose_kernel<<<grid, TT, T_SMEM, (cudaStream_t)stream>>>(
      x, y, tiles, vec, out);
  return (int)cudaGetLastError();
}
