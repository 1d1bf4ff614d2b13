// Three formulations of one CG instruction of the fused conv, the (2, 2, 2)
// uvu product at mul = 32, on NVIDIA Hopper (sm_90a), fp32 CUDA cores (c:
// its tiling product on the tensor cores, in TF32 pieces that sum to fp32):
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
//         St[p * 160 + m * 32 + u] = S[m][p]), on the tensor cores, then
//         the full-width product x * St per p and the sum over m
//
// What bounds them: bytes, 1,300 per row against 25 terms per channel (c:
// plus 20,000 multiply-adds per row for St, which the dense tiling product
// of the JAX formulation does on purpose). a and b: a warp owns one row
// (its 32 lanes are the 32 channels), so every x and out access is a
// 128-byte line, y and S are broadcasts; 8 rows per block. c runs the
// tiling product on the tensor cores (below).

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

// c, redesigned for Hopper: the tiling product St = S @ T on the tensor
// cores, mma.sync with TF32 inputs and fp32 sums, T's zeros included (T
// stays an input, as in JAX).
//
// Precision: no silent TF32. S (fp32) is split into three TF32 pieces, hi
// the TF32 rounding of S, mid that of S - hi, lo that of S - hi - mid (each
// difference exact in fp32); 3 x 11 significant bits hold S's 24, so hi +
// mid + lo = S exactly. Each piece is multiplied by T in turn into the same
// fp32 accumulators. T holds exact 0/1 entries, so each product of a piece
// with T is exact, and each St entry is hi + mid + lo of one S entry (the
// other terms of its column are exact zeros): every partial sum is exact or
// S itself, so St equals S's fp32 value to within an ulp, and the products
// with x and the sums over m run in fp32 on the CUDA cores.
//
// Layout: a warp owns a tile of 16 rows (the mma's M); S is built in
// registers from y and C, and its pieces go straight into A fragments, a
// set per piece for S's columns 0..23 (three k8 steps each), and one k8
// step for column 24 whose K slots 0, 1, 2 hold its three pieces against
// three copies of T's row 24 (slots 3..7 zero). St never goes to memory: in
// the accumulator of n8 tile 20 p + 4 m + u / 8, a lane holds columns m 32
// + u of window p for its two rows, for all five m at the same lane, so the
// product with x and the sum over m stay in registers. T is staged once a
// block in shared memory by cp.async, row by row (rows of 808 floats: a B
// fragment's loads are conflict-free), each B fragment feeding the three
// pieces' mma. A tile's x rows (10 kB, contiguous) and y rows arrive by
// 16-byte cp.async into a per-warp buffer (rows padded to 168 floats:
// conflict-free 8-byte reads; a warp's first tile while T is staged); the
// lane's 80 x values go to registers at once, so the next tile's copy runs
// under the whole tile's mma. out leaves from the accumulators as whole
// 32-byte sectors (a row's 8 columns of a u octet from 4 lanes), window by
// window, so the four sectors of a 128-byte line go out back to back, as
// streaming stores. One block an SM (~170 kB of shared memory, up to 255
// registers a thread), persistent over the tiles.
//
// What bounds it: bytes (1,300 a row: 0.0127 ms at E = 32,768) against the
// mma.sync rate: 1,000 m16n8k8 a 16-row tile (the dense 16 x 24 x 800
// product three times and the 16 x 8 x 800 step of column 24).
constexpr int CT_WARPS = 8;               // warps (16-row tiles) a block
constexpr int CT_ROWS = 16;               // rows a tile: the mma's M
constexpr int CT_KS = 3;                  // k8 steps (S's columns 0..23)
constexpr int CT_XS = W + 8;              // tile row stride (floats)
constexpr int CT_TS = D * W + 8;          // T row stride (floats)
constexpr int CT_BF = D * D * CT_TS;      // T's 25 rows
constexpr int CT_CS = 128;                // C (125 floats) padded
constexpr int CT_WARP_F = CT_ROWS * CT_XS + CT_ROWS * D;  // a warp's buffer
constexpr size_t CT_SMEM = sizeof(float) * (CT_BF + CT_CS +
                                            CT_WARPS * CT_WARP_F);

__device__ __forceinline__ unsigned tf32_of(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;            // the TF32 value as an fp32 bit pattern
}

// s = hi + mid + lo, each a TF32 value
__device__ __forceinline__ void split3(float s, unsigned& hi, unsigned& mid,
                                       unsigned& lo) {
  hi = tf32_of(s);
  const float r1 = s - __uint_as_float(hi);
  mid = tf32_of(r1);
  lo = tf32_of(r1 - __uint_as_float(mid));
}

__device__ __forceinline__ void mma_k8(float (&d)[4], const unsigned (&a)[4],
                                       float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes));
}

// the tile's x rows (contiguous) and y rows by cp.async, zeros past E
__device__ __forceinline__ void load_tile(float* tile, float* ys,
                                          const float* __restrict__ x,
                                          const float* __restrict__ y,
                                          long r0, int nrow, int lane) {
  for (int c = lane; c < CT_ROWS * W / 4; c += 32) {
    const int row = c / (W / 4), q = c % (W / 4);
    cp_async16(tile + row * CT_XS + 4 * q,
               row < nrow ? x + r0 * W + 4 * c : x, row < nrow ? 16 : 0);
  }
  if (lane < CT_ROWS * D / 4) {
    const int left = nrow * D - 4 * lane;
    cp_async16(ys + 4 * lane, left > 0 ? y + r0 * D + 4 * lane : y,
               left >= 4 ? 16 : left > 0 ? 4 * left : 0);
  }
  asm volatile("cp.async.commit_group;");
}

__global__ void __launch_bounds__(CT_WARPS * 32, 1)
cg_c_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ C, const float* __restrict__ Tt,
            long E, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* t_s = sm;                                 // [k][CT_TS]
  float* c_s = t_s + CT_BF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* tile = c_s + CT_CS + warp * CT_WARP_F;    // [row][CT_XS]
  float* ys = tile + CT_ROWS * CT_XS;              // [row][D]
  const long tiles = (E + CT_ROWS - 1) / CT_ROWS;
  const long stride = (long)gridDim.x * CT_WARPS;
  long ti = (long)blockIdx.x * CT_WARPS + warp;
  auto rows_of = [&](long i) {
    return E - i * CT_ROWS < CT_ROWS ? (int)(E - i * CT_ROWS) : CT_ROWS;
  };
  if (ti < tiles) load_tile(tile, ys, x, y, ti * CT_ROWS, rows_of(ti), lane);
  // T (25, 800) row by row into rows of CT_TS floats
  for (int c = tid; c < D * D * D * W / 4; c += blockDim.x) {
    const int k = c / (D * W / 4), q = c % (D * W / 4);
    cp_async16(t_s + k * CT_TS + 4 * q, Tt + 4 * c, 16);
  }
  asm volatile("cp.async.commit_group;");
  for (int i = tid; i < CT_CS; i += blockDim.x)
    c_s[i] = i < D * D * D ? C[i] : 0.f;
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (; ti < tiles; ti += stride) {
    const long r0 = ti * CT_ROWS;
    const int nrow = rows_of(ti);
    // A fragments of the three pieces: a[.][ks] = S[g][k], S[g + 8][k],
    // S[g][k + 4], S[g + 8][k + 4], k = 8 ks + t; a24 = piece t of S[g][24]
    // and of S[g + 8][24] (zero at t = 3), then K slots 4..7 zero; S = y @ C
    unsigned a[3][CT_KS][4], a24[4] = {0u, 0u, 0u, 0u};
    {
      float y0[D], y1[D];
#pragma unroll
      for (int n = 0; n < D; ++n) {
        y0[n] = ys[g * D + n];
        y1[n] = ys[(g + 8) * D + n];
      }
#pragma unroll
      for (int ks = 0; ks <= CT_KS; ++ks)
#pragma unroll
        for (int h = 0; h < (ks < CT_KS ? 2 : 1); ++h) {
          // column 24 in every lane of the last step
          const int k = ks < CT_KS ? 8 * ks + t + 4 * h : 8 * CT_KS;
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int n = 0; n < D; ++n) {
            const float cv = c_s[n * D * D + k];
            s0 = fmaf(y0[n], cv, s0);
            s1 = fmaf(y1[n], cv, s1);
          }
          if (ks < CT_KS) {
            split3(s0, a[0][ks][2 * h], a[1][ks][2 * h], a[2][ks][2 * h]);
            split3(s1, a[0][ks][2 * h + 1], a[1][ks][2 * h + 1],
                   a[2][ks][2 * h + 1]);
          } else {
            unsigned p0[3], p1[3];
            split3(s0, p0[0], p0[1], p0[2]);
            split3(s1, p1[0], p1[1], p1[2]);
            a24[0] = t == 0 ? p0[0] : t == 1 ? p0[1] : t == 2 ? p0[2] : 0u;
            a24[1] = t == 0 ? p1[0] : t == 1 ? p1[1] : t == 2 ? p1[2] : 0u;
          }
        }
    }
    // the lane's x: rows g and g + 8, columns m 32 + 8 j + 2 t (+ 1)
    float2 xv[4][D][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int m = 0; m < D; ++m) {
        const int col = m * MUL + 8 * j + 2 * t;
        xv[j][m][0] = *reinterpret_cast<const float2*>(tile + g * CT_XS + col);
        xv[j][m][1] =
            *reinterpret_cast<const float2*>(tile + (g + 8) * CT_XS + col);
      }
    // the buffer is free: the next tile's copy runs under this tile's mma
    __syncwarp();
    const bool next = ti + stride < tiles;
    if (next)
      load_tile(tile, ys, x, y, (ti + stride) * CT_ROWS,
                rows_of(ti + stride), lane);
    float* o_g = out + (r0 + g) * W + 2 * t;
    float* o_g8 = o_g + 8 * W;
#pragma unroll 1
    for (int p = 0; p < D; ++p) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc[D][4];
#pragma unroll
        for (int m = 0; m < D; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
        // B of n8 tile 20 p + 4 m + j: T[8 ks + t (+ 4)][8 nt + g], and
        // for column 24's step T[24][8 nt + g] in K slots 0..2
        const float* tn = t_s + t * CT_TS + 8 * (20 * p + j) + g;
#pragma unroll
        for (int ks = 0; ks < CT_KS; ++ks) {
          float b0[D], b1[D];
#pragma unroll
          for (int m = 0; m < D; ++m) {
            b0[m] = tn[8 * ks * CT_TS + 32 * m];
            b1[m] = tn[(8 * ks + 4) * CT_TS + 32 * m];
          }
#pragma unroll
          for (int piece = 0; piece < 3; ++piece)
#pragma unroll
            for (int m = 0; m < D; ++m)
              mma_k8(acc[m], a[piece][ks], b0[m], b1[m]);
        }
        {
          const float* t24 = t_s + 24 * CT_TS + 8 * (20 * p + j) + g;
#pragma unroll
          for (int m = 0; m < D; ++m)
            mma_k8(acc[m], a24, t < 3 ? t24[32 * m] : 0.f, 0.f);
        }
        float o0 = acc[0][0] * xv[j][0][0].x, o1 = acc[0][1] * xv[j][0][0].y;
        float o2 = acc[0][2] * xv[j][0][1].x, o3 = acc[0][3] * xv[j][0][1].y;
#pragma unroll
        for (int m = 1; m < D; ++m) {
          o0 = fmaf(acc[m][0], xv[j][m][0].x, o0);
          o1 = fmaf(acc[m][1], xv[j][m][0].y, o1);
          o2 = fmaf(acc[m][2], xv[j][m][1].x, o2);
          o3 = fmaf(acc[m][3], xv[j][m][1].y, o3);
        }
        const int col = p * MUL + 8 * j;
        if (g < nrow)
          __stcs(reinterpret_cast<float2*>(o_g + col), make_float2(o0, o1));
        if (g + 8 < nrow)
          __stcs(reinterpret_cast<float2*>(o_g8 + col), make_float2(o2, o3));
      }
    }
    if (next) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncwarp();
    }
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

constexpr int MAX_DEVICES = 64;
int n_sms[MAX_DEVICES];              // 0: the device not seen yet

// C (5, 25), T (25, 800) row-major; x, y and out 16-byte aligned
extern "C" int cg_c(const float* x, const float* y, const float* C,
                    const float* T, long E, float* out, void* stream) {
  if (!valid(E)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidValue;
  if (!n_sms[dev]) {
    err = cudaFuncSetAttribute(cg_c_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)CT_SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      n_sms[dev] = 0;
      return (int)err;
    }
  }
  const long tiles = (E + CT_ROWS - 1) / CT_ROWS;
  const long want = (tiles + CT_WARPS - 1) / CT_WARPS;
  const unsigned grid = (unsigned)(want < n_sms[dev] ? want : n_sms[dev]);
  cg_c_kernel<<<grid, CT_WARPS * 32, CT_SMEM, (cudaStream_t)stream>>>(
      x, y, C, T, E, out);
  return (int)cudaGetLastError();
}
