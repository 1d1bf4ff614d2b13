// Four ways to form the lane tile of a packed CG inner loop on NVIDIA Hopper
// (sm_90a), fp32 CUDA cores. All four compute
//   out[e, u] = sum_{r < 8} sum_{m < 5} x[e, 32 m + u] (s[e, m] (1 + r))
// x (E, 160), s (E, 5) -> out (E, 32), pass by pass and slice by slice in
// the JAX kernels' order; they differ in how the tiled row
// st[32 m + u] = s[e, m] (1 + r) reaches the thread of channel u.
//
// Replaces the TPU kernels of tools/bench_tile.py (kern_d, kern_a, kern_b,
// kern_c, run through pl.pallas_call over E / 256 blocks):
//
//   tile_d  per slice (the baseline): each lane loads s[e, m] itself (one
//           address for the whole warp: a broadcast) and multiplies
//   tile_a  repeat: lane m < 5 holds s[e, m]; each pass scales it and
//           __shfl_sync hands it to the 32 lanes
//   tile_b  broadcast + concatenate: each pass writes the whole tiled row
//           s (1 + r), 160 columns, to shared memory (lane u writes columns
//           4 u .. 4 u + 3 and 128 + u), then each lane reads its 5 columns
//   tile_c  the tiled row as the dense product (s (1 + r)) @ T with the
//           (5, 160) ones-block T, read from device memory (not a constant:
//           the product is done, 25 FMAs per lane and pass), on CUDA cores
//           in fp32
//
// What bounds the function: bytes (x, s read and out written once: 788
// bytes a row) against 1,280 multiply-adds a row. A warp owns a row, lanes
// on channels: every x and out access is one 128-byte line, s a broadcast.
// No fast math: the 8 x 5 products of an output are all issued (cuobjdump
// -sass counts them, tools/sass_compare.py). d and a launch a warp a row.
//
// b and c are bound by their formulations. b moves 10,240 bytes a row
// through shared memory (8 passes x 160 floats written and read back), 80
// conflict-free wavefronts; c issues its tiling product, 25 multiply-adds a
// column and pass. Both walk the rows on a persistent grid (warp w of NW
// takes rows, or row pairs, w, w + NW, ...), the next row's x and s loads
// issued before a row's passes, so device memory streams under the passes:
//   b  a warp a row, 48 warps an SM (launch bounds 256 x 6), x by
//      evict-first loads, two staging rows a warp alternating by pass: one
//      __syncwarp a pass
//   c  a half-warp a row, each lane on two channels, so a lane forms each
//      s (1 + r) once for two columns; each lane's 50 entries of T read
//      into registers once, before the loop and behind the first row's
//      loads; 8 warps an SM (launch bounds 128 x 2, 184 registers): more
//      warps with fewer registers issued the product more slowly

#include <cuda_runtime.h>

#include "launch_util.cuh"

namespace {

constexpr int NT = 256;
constexpr int ROWS = NT / 32;         // rows per block: one per warp
constexpr int MUL = 32, D1 = 5, W = MUL * D1, REPS = 8;
constexpr unsigned FULL = 0xffffffffu;

// one pass: g = sum_m x[m] st[m], in the JAX group-sum order
__device__ __forceinline__ float group(const float (&xv)[D1],
                                       const float (&st)[D1]) {
  float g = xv[0] * st[0];
#pragma unroll
  for (int m = 1; m < D1; ++m) g = fmaf(xv[m], st[m], g);
  return g;
}

__device__ __forceinline__ void load_x(const float* __restrict__ x, long e,
                                       int u, float (&xv)[D1]) {
#pragma unroll
  for (int m = 0; m < D1; ++m) xv[m] = x[e * W + m * MUL + u];
}

__global__ void __launch_bounds__(NT)
tile_d_kernel(const float* __restrict__ x, const float* __restrict__ s,
              long E, float* __restrict__ out) {
  const int u = threadIdx.x & 31;
  const long e = (long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (e >= E) return;
  float xv[D1], sv[D1];
  load_x(x, e, u, xv);
#pragma unroll
  for (int m = 0; m < D1; ++m) sv[m] = s[e * D1 + m];
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    float st[D1];
#pragma unroll
    for (int m = 0; m < D1; ++m) st[m] = sv[m] * (1.f + r);
    const float g = group(xv, st);
    acc = r == 0 ? g : acc + g;
  }
  out[e * MUL + u] = acc;
}

__global__ void __launch_bounds__(NT)
tile_a_kernel(const float* __restrict__ x, const float* __restrict__ s,
              long E, float* __restrict__ out) {
  const int u = threadIdx.x & 31;
  const long e = (long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (e >= E) return;                 // whole warps leave: shuffles stay full
  float xv[D1];
  load_x(x, e, u, xv);
  const float mine = u < D1 ? s[e * D1 + u] : 0.f;
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const float scaled = mine * (1.f + r);
    float st[D1];
#pragma unroll
    for (int m = 0; m < D1; ++m) st[m] = __shfl_sync(FULL, scaled, m);
    const float g = group(xv, st);
    acc = r == 0 ? g : acc + g;
  }
  out[e * MUL + u] = acc;
}

// b's operands of row e in lane u's registers: x[e, 32 m + u], s[e, u / 8]
// and s[e, 4]
struct RowB {
  float x[D1], s0, s4;
};

// row e's loads (none past E), x by evict-first loads: it is read once
__device__ __forceinline__ void fetch(const float* __restrict__ x,
                                      const float* __restrict__ s, long e,
                                      long E, int u, RowB& q) {
  if (e >= E) return;
#pragma unroll
  for (int m = 0; m < D1; ++m) q.x[m] = __ldcs(x + e * W + m * MUL + u);
  q.s0 = s[e * D1 + (u >> 3)];
  q.s4 = s[e * D1 + D1 - 1];
}

__global__ void __launch_bounds__(NT, 6)
tile_b_kernel(const float* __restrict__ x, const float* __restrict__ s,
              long E, float* __restrict__ out) {
  // two staging rows a warp, alternating by pass: a pass writes one while
  // lanes may still read the other, so one __syncwarp a pass orders both
  // (pass r + 2 writes after every lane passed pass r + 1's)
  __shared__ __align__(16) float st_s[ROWS][2][W];
  const int u = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long nw = (long)gridDim.x * ROWS;
  long e = (long)blockIdx.x * ROWS + warp;
  if (e >= E) return;                 // the block has no barrier
  RowB next{};
  fetch(x, s, e, E, u, next);
  for (; e < E; e += nw) {
    const RowB cur = next;
    fetch(x, s, e + nw, E, u, next);
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      // the whole tiled row: lane u writes columns 4 u .. 4 u + 3 (slice
      // u / 8, one 16-byte store) and 128 + u (slice 4)
      const float a0 = cur.s0 * (1.f + r), a1 = cur.s4 * (1.f + r);
      float* row = st_s[warp][r & 1];
      reinterpret_cast<float4*>(row)[u] = make_float4(a0, a0, a0, a0);
      row[4 * MUL + u] = a1;
      __syncwarp();
      float st[D1];
#pragma unroll
      for (int m = 0; m < D1; ++m) st[m] = row[m * MUL + u];
      const float g = group(cur.x, st);
      acc = r == 0 ? g : acc + g;
    }
    out[e * MUL + u] = acc;
  }
}

// c: a half-warp a row, lane l of the warp of row pair p on row
// e = 2 p + l / 16 and channels v = l % 16 and v + 16
constexpr int NTC = 128, ROWS_C = NTC / 32;    // row pairs a block
constexpr int HALF = MUL / 2;

struct RowC {
  float x0[D1], x1[D1], s[D1];        // x[e, 32 m + v], x[e, 32 m + 16 + v]
};

// row e's loads (none past E)
__device__ __forceinline__ void fetch(const float* __restrict__ x,
                                      const float* __restrict__ s, long e,
                                      long E, int v, RowC& q) {
  if (e >= E) return;
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    q.x0[m] = x[e * W + m * MUL + v];
    q.x1[m] = x[e * W + m * MUL + HALF + v];
  }
#pragma unroll
  for (int m = 0; m < D1; ++m) q.s[m] = s[e * D1 + m];
}

__global__ void __launch_bounds__(NTC, 2)
tile_c_kernel(const float* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ T, long E, float* __restrict__ out) {
  const int l = threadIdx.x & 31, h = l / HALF, v = l % HALF;
  const long pairs = (E + 1) / 2;
  const long nw = (long)gridDim.x * ROWS_C;
  long p = (long)blockIdx.x * ROWS_C + (threadIdx.x >> 5);
  if (p >= pairs) return;
  RowC next{};
  fetch(x, s, 2 * p + h, E, v, next);  // the first row's loads before T's
  // this lane's 50 entries of T, read once: t0[k][m] = T[k][32 m + v],
  // t1[k][m] = T[k][32 m + 16 + v]
  float t0[D1][D1], t1[D1][D1];
#pragma unroll
  for (int k = 0; k < D1; ++k)
#pragma unroll
    for (int m = 0; m < D1; ++m) {
      t0[k][m] = T[k * W + m * MUL + v];
      t1[k][m] = T[k * W + m * MUL + HALF + v];
    }
  for (; p < pairs; p += nw) {
    const RowC cur = next;
    fetch(x, s, 2 * (p + nw) + h, E, v, next);
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int r = 0; r < REPS; ++r) {
      float sr[D1], st0[D1], st1[D1];
#pragma unroll
      for (int k = 0; k < D1; ++k) sr[k] = cur.s[k] * (1.f + r);
      // st0[m], st1[m] = (sr @ T)[32 m + v], [32 m + 16 + v]
#pragma unroll
      for (int m = 0; m < D1; ++m) {
        float a = sr[0] * t0[0][m], b = sr[0] * t1[0][m];
#pragma unroll
        for (int k = 1; k < D1; ++k) {
          a = fmaf(sr[k], t0[k][m], a);
          b = fmaf(sr[k], t1[k][m], b);
        }
        st0[m] = a;
        st1[m] = b;
      }
      const float g0 = group(cur.x0, st0), g1 = group(cur.x1, st1);
      acc0 = r == 0 ? g0 : acc0 + g0;
      acc1 = r == 0 ? g1 : acc1 + g1;
    }
    const long e = 2 * p + h;
    if (e < E) {
      out[e * MUL + v] = acc0;
      out[e * MUL + HALF + v] = acc1;
    }
  }
}

// the blocks an SM holds of b and c, per device
launch_util::Resident b_resident, c_resident;

bool valid(long E) { return E > 0 && (E + ROWS - 1) / ROWS < (1L << 31); }

unsigned blocks(long E) { return (unsigned)((E + ROWS - 1) / ROWS); }

}  // namespace

// x (E, 160), s (E, 5) row-major -> out (E, 32); variant 'd', 'a' or 'b'
extern "C" int tile_dab(char variant, const float* x, const float* s, long E,
                        float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (variant == 'd')
    tile_d_kernel<<<blocks(E), NT, 0, st>>>(x, s, E, out);
  else if (variant == 'a')
    tile_a_kernel<<<blocks(E), NT, 0, st>>>(x, s, E, out);
  else if (variant == 'b') {
    unsigned grid = 0;
    const cudaError_t err = launch_util::persistent_grid(
        tile_b_kernel, NT, 0, blocks(E), b_resident, &grid);
    if (err != cudaSuccess) return (int)err;
    tile_b_kernel<<<grid, NT, 0, st>>>(x, s, E, out);
  } else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// as tile_dab, with T (5, 160) row-major
extern "C" int tile_c(const float* x, const float* s, const float* T, long E,
                      float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const long pairs = (E + 1) / 2;
  const cudaError_t err = launch_util::persistent_grid(
      tile_c_kernel, NTC, 0, (pairs + ROWS_C - 1) / ROWS_C, c_resident,
      &grid);
  if (err != cudaSuccess) return (int)err;
  tile_c_kernel<<<grid, NTC, 0, (cudaStream_t)stream>>>(x, s, T, E, out);
  return (int)cudaGetLastError();
}
