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
//           s (1 + r), 160 columns, to shared memory (lane l writes columns
//           5 l .. 5 l + 4, so the writer of a column is another lane than
//           its reader), then each lane reads its 5 columns
//   tile_c  the tiled row as the dense product (s (1 + r)) @ T with the
//           (5, 160) ones-block T, read from device memory into shared
//           memory (not a constant: the product is done, 25 FMAs per lane
//           and pass), on CUDA cores in fp32
//
// What bounds them: bytes (x, s read and out written once: 788 bytes a row)
// against 1,280 multiply-adds a row (c: 6,400 more for its product). A warp
// owns one row, lanes on channels: every x and out access is one 128-byte
// line, s a broadcast. No fast math: the 8 x 5 products of an output are all
// issued (cuobjdump -sass counts them, tools/sass_compare.py).

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(NT)
tile_b_kernel(const float* __restrict__ x, const float* __restrict__ s,
              long E, float* __restrict__ out) {
  __shared__ float st_s[ROWS][W];
  const int u = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long e = (long)blockIdx.x * ROWS + warp;
  if (e >= E) return;                 // the block has no barrier
  float xv[D1];
  load_x(x, e, u, xv);
  // this lane writes columns 5 u .. 5 u + 4: slices m0 and (at most) m0 + 1
  const int m0 = (D1 * u) / MUL, m1 = (D1 * u + D1 - 1) / MUL;
  const float s0 = s[e * D1 + m0], s1 = s[e * D1 + m1];
  float* row = st_s[warp];
  float acc = 0.f;
#pragma unroll
  for (int r = 0; r < REPS; ++r) {
    const float a0 = s0 * (1.f + r), a1 = s1 * (1.f + r);
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const int c = D1 * u + j;
      row[c] = c / MUL == m0 ? a0 : a1;
    }
    __syncwarp();
    float st[D1];
#pragma unroll
    for (int m = 0; m < D1; ++m) st[m] = row[m * MUL + u];
    __syncwarp();                     // read before the next pass writes
    const float g = group(xv, st);
    acc = r == 0 ? g : acc + g;
  }
  out[e * MUL + u] = acc;
}

__global__ void __launch_bounds__(NT)
tile_c_kernel(const float* __restrict__ x, const float* __restrict__ s,
              const float* __restrict__ T, long E, float* __restrict__ out) {
  __shared__ float t_s[D1][W];
  for (int i = threadIdx.x; i < D1 * W; i += NT) t_s[i / W][i % W] = T[i];
  __syncthreads();
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
    float sr[D1], st[D1];
#pragma unroll
    for (int k = 0; k < D1; ++k) sr[k] = sv[k] * (1.f + r);
    // st[m] = (sr @ T)[32 m + u], over the 5 rows of T
#pragma unroll
    for (int m = 0; m < D1; ++m) {
      float v = sr[0] * t_s[0][m * MUL + u];
#pragma unroll
      for (int k = 1; k < D1; ++k) v = fmaf(sr[k], t_s[k][m * MUL + u], v);
      st[m] = v;
    }
    const float g = group(xv, st);
    acc = r == 0 ? g : acc + g;
  }
  out[e * MUL + u] = acc;
}

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
  else if (variant == 'b')
    tile_b_kernel<<<blocks(E), NT, 0, st>>>(x, s, E, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// as tile_dab, with T (5, 160) row-major
extern "C" int tile_c(const float* x, const float* s, const float* T, long E,
                      float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  tile_c_kernel<<<blocks(E), NT, 0, (cudaStream_t)stream>>>(x, s, T, E, out);
  return (int)cudaGetLastError();
}
