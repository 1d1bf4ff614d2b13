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
//   cgmxu_outer  Z[(m, n), (u, b)] = x[(m, u), b] sh[n, b], then the one
//                dense CG product C (d3tot, d1 f) @ Z, then x w
//   cgmxu_dots   the product alone: Z at no build cost (x[0, b] in every
//                row and channel), C @ Z, and the JAX write pattern -- all
//                zeros but rows 0..d3tot-1 = out0(u = 0) + out0(u = mul-1)
//
// What bounds them: bytes. A row of i1 = 1 reads 585 floats and writes 1,280
// against 50 CG terms per channel (st: 270 multiply-adds of its dense
// tables and products; outer: 540 of the dense product); at E = 32,768 that
// is ~244 MB, ~0.07 ms at 3.35 TB/s. The design of all three: the class's
// shape at compile time, a thread owns 4 consecutive edges of one channel
// u (float4 loads and stores, 512 bytes a warp and row), the 8 warps of a
// block take 8 channels of the same 128 edges, so sh and the tables are
// read once per block into shared memory, and the coefficients are 16-byte
// broadcasts. dots is bound by the bytes it writes at i1 = 1 (168 MB, 0.050
// ms) and by its multiply-adds at i1 = 2 (0.031 ms at 67 TFLOP/s). All fp32
// on the CUDA cores (no TF32, no tensor cores).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int EB = 32;         // edges per block: one warp's lanes
constexpr int US = NT / EB;    // channels u per block: one per warp
constexpr int MAXR = 32;       // most (instruction, component) rows
constexpr int MAXF = 16;       // most filter components
constexpr int DE = 4;          // edges per thread (one float4)
constexpr int DEB = EB * DE;   // edges per block: 128
// instruction record of st: sh offset, d2, d3, first row r, table offset
enum { R_SO = 0, R_D2, R_D3, R_ROW, R_TAB, R_STRIDE };

struct Cls {
  int mul, d1, f, n_ins, d3tot, tab_len;
  long E;
};

// st, redesigned for Hopper (the outer kernel's layout, below): the class
// is a template parameter (D1, F, D3) and its instructions a compile-time
// list, ST_CLASS_<D1>_<F>_<D3> (sh offset so, d2, d3, first row, table
// offset; tools/bench_cgmxu.py::ST_CLASSES, which the C entry holds the
// records passed to it against), so every loop unrolls. A thread owns DE =
// 4 consecutive edges of one channel u (float4 loads of x, w and out, 128
// edges a warp, 8 channels a block); it keeps its D1 x rows and the F sh
// rows in registers, the sh rows staged once a block in shared memory for
// the 8 channels. The tables (each instruction's CT without its copy per
// channel, T[n][p][m], an input as in JAX) are staged once a block in the
// loop's order [p][m][n] and read as LDS.128 broadcasts, 4 coefficients a
// load, each feeding the 4 edges. Per instruction and p: S[m] = sum over n
// of T[p][m][n] sh[so + n] (the dense table, its zeros included, in
// registers), the sum over m of x[m] S[m], times the instruction's weight,
// one 512-byte streaming store a warp and row. A warp barrier between
// instructions keeps ptxas from hoisting a later instruction's table loads
// into an earlier one.
#define ST_CLASS_1_9_9(I) \
  I(0, 0, 1, 1, 0, 0) I(1, 1, 3, 3, 1, 1) I(2, 4, 5, 5, 4, 10)
#define ST_CLASS_3_9_20(I) \
  I(0, 1, 3, 1, 0, 0) I(1, 0, 1, 3, 1, 9) I(2, 1, 3, 3, 4, 18) \
  I(3, 4, 5, 3, 7, 45) I(4, 1, 3, 5, 10, 90) I(5, 4, 5, 5, 15, 135)
#define ST_CLASS_5_9_22(I) \
  I(0, 4, 5, 1, 0, 0) I(1, 1, 3, 3, 1, 25) I(2, 4, 5, 3, 4, 70) \
  I(3, 0, 1, 5, 7, 145) I(4, 1, 3, 5, 12, 170) I(5, 4, 5, 5, 17, 245)

template <int D1, int F, int D3> struct StClass;
#define ST_TAB_LEN(K, SO, D2, D3_, ROW, TAB) +D1 * (D2) * (D3_)
#define ST_N_INS(K, SO, D2, D3_, ROW, TAB) +1
#define ST_TRAITS(D1_, F_, D3T)                                           \
  template <> struct StClass<D1_, F_, D3T> {                              \
    static constexpr int D1 = D1_;                                        \
    static constexpr int tab_len = 0 ST_CLASS_##D1_##_##F_##_##D3T(ST_TAB_LEN); \
    static constexpr int n_ins = 0 ST_CLASS_##D1_##_##F_##_##D3T(ST_N_INS); \
  };
ST_TRAITS(1, 9, 9)
ST_TRAITS(3, 9, 20)
ST_TRAITS(5, 9, 22)

// the records of the compiled class, as tools/bench_cgmxu.py::st_tables
// writes them
#define ST_REC(K, SO, D2, D3_, ROW, TAB) SO, D2, D3_, ROW, TAB,

// one instruction's table from the record layout T[(n d3 + p) d1 + m]
// into the loop's order [p][m][n], at the same offset
template <int D1, int D2, int D3, int TAB>
__device__ __forceinline__ void st_stage(const float* __restrict__ tab,
                                         float* t_s, int tid) {
  for (int i = tid; i < D1 * D2 * D3; i += NT) {
    const int n = i / (D3 * D1), p = (i / D1) % D3, m = i % D1;
    t_s[TAB + (p * D1 + m) * D2 + n] = tab[TAB + i];
  }
}

template <int J>
__device__ __forceinline__ float st_coef(const float4* t4) {
  const float4 q = t4[J >> 2];
  return (J & 3) == 0 ? q.x : (J & 3) == 1 ? q.y : (J & 3) == 2 ? q.z : q.w;
}

// the coefficients of (p, m) for n = 0..D2-1 times the sh rows, summed
template <int D2, int SO, int J, int N = 0>
__device__ __forceinline__ void st_s(const float4* t4, const float4 (&sh)[MAXF],
                                     float (&s)[DE]) {
  if constexpr (N < D2) {
    const float t = st_coef<J + N>(t4);
    const float4 q = sh[SO + N];
    if constexpr (N == 0) {
      s[0] = t * q.x; s[1] = t * q.y; s[2] = t * q.z; s[3] = t * q.w;
    } else {
      s[0] = fmaf(t, q.x, s[0]); s[1] = fmaf(t, q.y, s[1]);
      s[2] = fmaf(t, q.z, s[2]); s[3] = fmaf(t, q.w, s[3]);
    }
    st_s<D2, SO, J, N + 1>(t4, sh, s);
  }
}

// sum over m of x[m] S[p][m] for one p
template <int D1, int D2, int SO, int J0, int M = 0>
__device__ __forceinline__ void st_p(const float4* t4, const float4 (&sh)[MAXF],
                                     const float4 (&x)[MAXF], float (&acc)[DE]) {
  if constexpr (M < D1) {
    float s[DE];
    st_s<D2, SO, J0 + M * D2>(t4, sh, s);
    const float4 xm = x[M];
    if constexpr (M == 0) {
      acc[0] = xm.x * s[0]; acc[1] = xm.y * s[1];
      acc[2] = xm.z * s[2]; acc[3] = xm.w * s[3];
    } else {
      acc[0] = fmaf(xm.x, s[0], acc[0]); acc[1] = fmaf(xm.y, s[1], acc[1]);
      acc[2] = fmaf(xm.z, s[2], acc[2]); acc[3] = fmaf(xm.w, s[3], acc[3]);
    }
    st_p<D1, D2, SO, J0, M + 1>(t4, sh, x, acc);
  }
}

// instruction K's rows ROW .. ROW + D3 - 1, p by p
template <int D1, int K, int SO, int D2, int D3, int ROW, int TAB, int P = 0>
__device__ __forceinline__ void st_ins(const float4* t4,
                                       const float4 (&sh)[MAXF],
                                       const float4 (&x)[MAXF], float4 w,
                                       float* __restrict__ out, int mul,
                                       long E, int u, long b) {
  if constexpr (P < D3) {
    float acc[DE];
    st_p<D1, D2, SO, TAB + P * D1 * D2>(t4, sh, x, acc);
    __stcs(reinterpret_cast<float4*>(out + ((long)(ROW + P) * mul + u) * E + b),
           make_float4(acc[0] * w.x, acc[1] * w.y, acc[2] * w.z,
                       acc[3] * w.w));
    st_ins<D1, K, SO, D2, D3, ROW, TAB, P + 1>(t4, sh, x, w, out, mul, E, u,
                                                b);
  }
}

template <int D1, int F, int D3>
__global__ void __launch_bounds__(NT, 2)
cgmxu_st_kernel(const float* __restrict__ xT, const float* __restrict__ shT,
                const float* __restrict__ wT, const float* __restrict__ tab,
                int mul, long E, float* __restrict__ out) {
  using C = StClass<D1, F, D3>;
  constexpr int TP = (C::tab_len + 3) / 4 * 4;
  __shared__ __align__(16) float t_s[TP];
  __shared__ float4 sh_s[F * EB];          // sh_s[n EB + l]: lane l's edges
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b0 = (long)blockIdx.x * DEB, b = b0 + DE * lane;
  const int u = blockIdx.y * US + slot;
#define ST_STAGE(K, SO, D2, D3_, ROW, TAB) \
  st_stage<D1, D2, D3_, TAB>(tab, t_s, tid);
  if constexpr (D1 == 1) { ST_CLASS_1_9_9(ST_STAGE) }
  if constexpr (D1 == 3) { ST_CLASS_3_9_20(ST_STAGE) }
  if constexpr (D1 == 5) { ST_CLASS_5_9_22(ST_STAGE) }
#undef ST_STAGE
  for (int i = C::tab_len + tid; i < TP; i += NT) t_s[i] = 0.f;
  for (int i = tid; i < F * EB; i += NT) {
    const long bb = b0 + DE * (i % EB);
    if (bb < E)
      sh_s[i] = *reinterpret_cast<const float4*>(shT + (i / EB) * E + bb);
  }
  __syncthreads();
  if (b >= E) return;     // a thread's four edges are all in or all out
  float4 sh[MAXF], x[MAXF];
#pragma unroll
  for (int n = 0; n < F; ++n) sh[n] = sh_s[n * EB + lane];
#pragma unroll
  for (int m = 0; m < D1; ++m)
    x[m] = *reinterpret_cast<const float4*>(xT + ((long)m * mul + u) * E + b);
  const float4* t4 = reinterpret_cast<const float4*>(t_s);
#define ST_INS(K, SO, D2, D3_, ROW, TAB)                                      \
  {                                                                          \
    if (K > 0) __syncwarp(__activemask());                                   \
    const float4 w = *reinterpret_cast<const float4*>(                       \
        wT + ((long)(K) * mul + u) * E + b);                                 \
    st_ins<D1, K, SO, D2, D3_, ROW, TAB>(t4, sh, x, w, out, mul, E, u, b);   \
  }
  if constexpr (D1 == 1) { ST_CLASS_1_9_9(ST_INS) }
  if constexpr (D1 == 3) { ST_CLASS_3_9_20(ST_INS) }
  if constexpr (D1 == 5) { ST_CLASS_5_9_22(ST_INS) }
#undef ST_INS
}

// dots, redesigned for Hopper: the class's shape is a template parameter,
// (K = d1 f, D3 = d3tot), so the r and j loops unroll completely. A thread
// owns DE = 4 consecutive edges b of one channel u: it reads z as one float4,
// keeps D3 x 4 sums in registers and reads C from shared memory as LDS.128
// broadcasts, 4 j at a time, each C value feeding the 4 columns (16 FFMA per
// shared load). A warp owns 128 edges of one channel, so each output row is
// one 512-byte float4 store per warp. Channels of a block: slots 0..US/2-1
// take u = US/2 * blockIdx.y + i, the others mul - 1 - that, so that u = 0
// and u = mul - 1 meet in block row 0. E a multiple of 32: a thread's four
// edges are all in or all out, and the last block may be ragged.
template <int K, int D3>
__global__ void __launch_bounds__(NT, 2)
cgmxu_dots_kernel(const float* __restrict__ xT, const float* __restrict__ cg,
                  int mul, long E, float* __restrict__ out) {
  constexpr int KP = (K + 3) / 4 * 4;   // C row stride: 16-byte rows
  __shared__ __align__(16) float c_s[D3 * KP];
  __shared__ __align__(16) float ex_s[D3 * DEB];  // out0 of u = mul - 1
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b = (long)blockIdx.x * DEB + DE * lane;
  const int half = US / 2, base = half * blockIdx.y;
  const int u = slot < half ? base + slot : mul - 1 - (base + slot - half);
  for (int i = tid; i < D3 * KP; i += NT) {
    const int r = i / KP, j = i % KP;
    c_s[i] = j < K ? cg[r * K + j] : 0.f;
  }
  __syncthreads();
  const bool live = b < E;
  float4 zv = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) zv = *reinterpret_cast<const float4*>(xT + b);
  const float z[DE] = {zv.x, zv.y, zv.z, zv.w};
  // each sum starts at z * 0 (+-0), not at a literal 0, so that nvcc keeps
  // the first product an FFMA: the SASS then shows all D3 K FFMAs a column
  float acc[D3][DE];
#pragma unroll
  for (int r = 0; r < D3; ++r)
#pragma unroll
    for (int c = 0; c < DE; ++c) acc[r][c] = z[c] * 0.f;
#pragma unroll
  for (int r = 0; r < D3; ++r)
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(&c_s[r * KP + j]);
      const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (j + jj < K)
#pragma unroll
          for (int c = 0; c < DE; ++c)
            acc[r][c] = fmaf(cj[jj], z[c], acc[r][c]);
    }
  float4* ex4 = reinterpret_cast<float4*>(ex_s);
  if (blockIdx.y == 0) {
    if (u == mul - 1) {
#pragma unroll
      for (int r = 0; r < D3; ++r)
        ex4[r * EB + lane] =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
    __syncthreads();
  }
  if (!live) return;
  // rows 0..D3-1 (channel u < D3 of row group 0) get the sums from u = 0
  // and u = mul - 1; every other row of the column is zero, written by its
  // owner as its own sum times 0 so that the product stays whole in every
  // thread. The output is written once and never read here: streaming
  // stores (evict first), which let the 168 MB of i1 = 1 drain beside the
  // FFMAs of the blocks still computing
#pragma unroll
  for (int r = 0; r < D3; ++r) {
    if (u == 0) {
      const float4 e = ex4[r * EB + lane];
      __stcs(reinterpret_cast<float4*>(out + (long)r * E + b),
             make_float4(acc[r][0] + e.x, acc[r][1] + e.y, acc[r][2] + e.z,
                         acc[r][3] + e.w));
    }
    if (r > 0 || u >= D3)
      __stcs(reinterpret_cast<float4*>(out + ((long)r * mul + u) * E + b),
             make_float4(acc[r][0] * 0.f, acc[r][1] * 0.f, acc[r][2] * 0.f,
                         acc[r][3] * 0.f));
  }
}

// outer, redesigned for Hopper: the dots kernel's layout (the class's shape
// (D1, F, D3) a template parameter, DE = 4 consecutive edges of one channel
// u a thread, 8 channels a block, 128 edges a warp) with Z built in
// registers: for each x row m (one float4) and sh row n, z = x[m] sh[n]
// feeds every row r of the product. The block's sh rows (the same for its 8
// channels) are staged in shared memory by float4 loads. C is staged
// transposed, c_s[(m F + n) D3P + r] = C[r][m F + n], so each LDS.128
// broadcast gives 4 rows' coefficients, each feeding the DE columns: every
// multiply-add of the dense D3 x D1 F product, C's zeros included. The
// rows go in passes of OUTER_ROWS, Z rebuilt in each, a warp barrier
// between passes: with all D3 x 4 sums live at once (88 at i1 = 2) ptxas
// spilled in every loop order tried, and unbarriered passes were
// interleaved and spilled more. Each pass's sums are multiplied by their
// instruction's radial weight (float4 loads, the repeats of an instruction
// from L1) and leave as one 512-byte float4 streaming store a warp and row.
constexpr int OUTER_ROWS = 8;

template <int D1, int F, int D3>
__global__ void __launch_bounds__(NT, 2)
cgmxu_outer_kernel(const float* __restrict__ xT,
                   const float* __restrict__ shT,
                   const float* __restrict__ wT,
                   const int* __restrict__ row_ins,
                   const float* __restrict__ cg, int mul, long E,
                   float* __restrict__ out) {
  constexpr int K = D1 * F, D3P = (D3 + 3) / 4 * 4;
  constexpr int RP = OUTER_ROWS < D3P ? OUTER_ROWS : D3P;
  __shared__ __align__(16) float c_s[K * D3P];
  __shared__ float4 sh_s[F * EB];          // sh_s[n EB + l]: lane l's edges
  __shared__ int ri_s[D3];
  const int tid = threadIdx.x, lane = tid & 31, slot = tid >> 5;
  const long b0 = (long)blockIdx.x * DEB, b = b0 + DE * lane;
  const int u = blockIdx.y * US + slot;
  for (int i = tid; i < K * D3P; i += NT) {
    const int j = i / D3P, r = i % D3P;
    c_s[i] = r < D3 ? cg[r * K + j] : 0.f;
  }
  for (int i = tid; i < D3; i += NT) ri_s[i] = row_ins[i];
  for (int i = tid; i < F * EB; i += NT) {
    const long bb = b0 + DE * (i % EB);
    if (bb < E)
      sh_s[i] = *reinterpret_cast<const float4*>(shT + (i / EB) * E + bb);
  }
  __syncthreads();
  if (b >= E) return;     // a thread's four edges are all in or all out
  const float* xu = xT + (long)u * E + b;  // row m at + m mul E
#pragma unroll
  for (int r0 = 0; r0 < D3; r0 += RP) {
    // the passes one after the other: no load of a later pass moves into
    // an earlier one
    if (r0 > 0) __syncwarp(__activemask());
    // each sum starts at x * 0 (+-0), so that nvcc keeps the first product
    // an FFMA: the SASS then shows all D3 K FFMAs a column
    float acc[RP][DE];
    {
      const float4 x0 = *reinterpret_cast<const float4*>(xu);
      const float xz[DE] = {x0.x * 0.f, x0.y * 0.f, x0.z * 0.f, x0.w * 0.f};
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < DE; ++c) acc[r][c] = xz[c];
    }
#pragma unroll
    for (int m = 0; m < D1; ++m) {
      const float4 xq =
          *reinterpret_cast<const float4*>(xu + (long)m * mul * E);
      const float x[DE] = {xq.x, xq.y, xq.z, xq.w};
#pragma unroll
      for (int n = 0; n < F; ++n) {
        const float4 sq = sh_s[n * EB + lane];
        const float z[DE] = {x[0] * sq.x, x[1] * sq.y, x[2] * sq.z,
                             x[3] * sq.w};
        const float* cj = c_s + (m * F + n) * D3P + r0;
#pragma unroll
        for (int r = 0; r < RP; r += 4) {
          if (r0 + r < D3) {
            const float4 cv = *reinterpret_cast<const float4*>(cj + r);
            const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
            for (int rr = 0; rr < 4; ++rr)
              if (r0 + r + rr < D3)
#pragma unroll
                for (int c = 0; c < DE; ++c)
                  acc[r + rr][c] = fmaf(cr[rr], z[c], acc[r + rr][c]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      if (r0 + r < D3) {
        const float4 w = *reinterpret_cast<const float4*>(
            wT + ((long)ri_s[r0 + r] * mul + u) * E + b);
        float* o = out + ((long)(r0 + r) * mul + u) * E + b;
        __stcs(reinterpret_cast<float4*>(o),
               make_float4(acc[r][0] * w.x, acc[r][1] * w.y, acc[r][2] * w.z,
                           acc[r][3] * w.w));
      }
    }
  }
}

template <int D1, int F, int D3>
cudaError_t launch_outer(const float* xT, const float* shT, const float* wT,
                         const int* row_ins, const float* cg, int mul, long E,
                         float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((E + DEB - 1) / DEB), mul / US);
  cgmxu_outer_kernel<D1, F, D3><<<grid, NT, 0, stream>>>(
      xT, shT, wT, row_ins, cg, mul, E, out);
  return cudaGetLastError();
}

template <int K, int D3>
cudaError_t launch_dots(const float* xT, const float* cg, int mul, long E,
                        float* out, cudaStream_t stream) {
  const dim3 grid((unsigned)((E + DEB - 1) / DEB), mul / US);
  cgmxu_dots_kernel<K, D3><<<grid, NT, 0, stream>>>(xT, cg, mul, E, out);
  return cudaGetLastError();
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

// the classes the st kernel is instantiated for, (d1, f, d3tot), with their
// instruction lists (tools/bench_cgmxu.py::ST_CLASSES): records ins (n_ins
// x [sh offset, d2, d3, first row, table offset]) and a table of tab_len
// floats that are not the compiled class's are refused; E a multiple of 32,
// mul of 8, d3tot <= mul
template <int D1, int F, int D3>
int launch_st(const float* xT, const float* shT, const float* wT,
              const int* ins, const float* tab, int tab_len, const Cls& C,
              float* out, cudaStream_t stream, const int* want) {
  using S = StClass<D1, F, D3>;
  if (C.n_ins != S::n_ins || tab_len != S::tab_len)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < S::n_ins * R_STRIDE; ++i)
    if (ins[i] != want[i]) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((C.E + DEB - 1) / DEB), C.mul / US);
  cgmxu_st_kernel<D1, F, D3><<<grid, NT, 0, stream>>>(xT, shT, wT, tab,
                                                       C.mul, C.E, out);
  return (int)cudaGetLastError();
}

// ins is a host array, as tools/bench_cgmxu.py passes it
extern "C" int cgmxu_st(const float* xT, const float* shT, const float* wT,
                        const int* ins, const float* tab, int tab_len,
                        CLS_ARGS, float* out, void* stream) {
  const Cls C = CLS_CALL(tab_len);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d1 == 1 && f == 9 && d3tot == 9) {
    static const int want[] = {ST_CLASS_1_9_9(ST_REC)};
    return launch_st<1, 9, 9>(xT, shT, wT, ins, tab, tab_len, C, out, s, want);
  }
  if (d1 == 3 && f == 9 && d3tot == 20) {
    static const int want[] = {ST_CLASS_3_9_20(ST_REC)};
    return launch_st<3, 9, 20>(xT, shT, wT, ins, tab, tab_len, C, out, s,
                               want);
  }
  if (d1 == 5 && f == 9 && d3tot == 22) {
    static const int want[] = {ST_CLASS_5_9_22(ST_REC)};
    return launch_st<5, 9, 22>(xT, shT, wT, ins, tab, tab_len, C, out, s,
                               want);
  }
  return (int)cudaErrorInvalidValue;
}

// the classes the outer kernel is instantiated for, (d1, f, d3tot): those
// of the dots kernel (tools/bench_cgmxu.py::OUTER_SHAPES)
extern "C" int cgmxu_outer(const float* xT, const float* shT, const float* wT,
                           const int* row_ins, const float* cg, CLS_ARGS,
                           float* out, void* stream) {
  const Cls C = CLS_CALL(0);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d1 == 1 && f == 9 && d3tot == 9)
    return (int)launch_outer<1, 9, 9>(xT, shT, wT, row_ins, cg, mul, E, out,
                                      s);
  if (d1 == 3 && f == 9 && d3tot == 20)
    return (int)launch_outer<3, 9, 20>(xT, shT, wT, row_ins, cg, mul, E, out,
                                       s);
  if (d1 == 5 && f == 9 && d3tot == 22)
    return (int)launch_outer<5, 9, 22>(xT, shT, wT, row_ins, cg, mul, E, out,
                                       s);
  return (int)cudaErrorInvalidValue;
}

// the classes the dots kernel is instantiated for, (d1 f, d3tot): i1 = 0,
// 1 and 2 of the 7net-0 mid layer (tools/bench_cgmxu.py::DOTS_SHAPES)
extern "C" int cgmxu_dots(const float* xT, const float* cg, CLS_ARGS,
                          float* out, void* stream) {
  const Cls C = CLS_CALL(0);
  if (!valid(C)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int K = d1 * f;
  if (K == 9 && d3tot == 9)
    return (int)launch_dots<9, 9>(xT, cg, mul, E, out, s);
  if (K == 27 && d3tot == 20)
    return (int)launch_dots<27, 20>(xT, cg, mul, E, out, s);
  if (K == 45 && d3tot == 22)
    return (int)launch_dots<45, 22>(xT, cg, mul, E, out, s);
  return (int)cudaErrorInvalidValue;
}
