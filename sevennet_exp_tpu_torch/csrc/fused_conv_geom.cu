// Geometry-fused convolution block on the dense neighbor grid, forward and
// force backward, for NVIDIA Hopper (sm_90a), fp32 on the CUDA cores.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_geom_fwd <- make_fused_conv(agg_d > 0, geom).fwd_kernel_geom
//                          (_geom_fm, _sh_rows_fm, _mlp_fm, _cm_fwd_core)
//   fused_conv_geom_bwd <- make_fused_conv(agg_d > 0, geom).bwd_kernel_geom
//                          (the same, _cm_bwd_core and the geometry VJP)
//
// Per grid row e of atom i (row i*D + k is atom i's k-th neighbor), from the
// raw edge vector v[e]:
//   r      = sqrt(|v|^2 + 1e-30)
//   emb_n  = (2/rc) sin(c_n r)/r * env(r)       env: polynomial or XPLOR
//   sh     = component-normalised real SH of v/r (or of v), l <= 3
//   w[e]   = MLP(emb[e]) * ms[e]                radial MLP nb -> 64 -> 64 -> wn
//   A_i    = sum_e w[e] (x) CG(xg[e], sh[e])    uvu tensor product
//   y[i]   = si2(A_i)                           self-interaction 2 per atom
// The backward takes g[i], forms gm = si2^T g[i] once per atom, recomputes
// the geometry and the MLP and returns dxg and dvec (the geometry VJP
// written out by hand:
//   dvec = (sum_n demb_n d emb_n/dr) v/r + (I - u u^T)(dsh . dY/du) / r).
// Rows with ms == 0 (grid pads) send no message and get exact-zero dxg and
// dvec rows.
//
// What bounds it on this card: the fp32 CUDA cores. A mid layer of the
// checkpoint (d1 = 480, 576 live MLP columns, 9 live instructions, 4,320
// CG terms) does ~41.5k multiply-adds of MLP per row forward and twice that
// backward, against ~2 kB read per row: far above the fp32 ridge (67
// TFLOP/s / 3.35 TB/s = 20 flop/byte).
//
// What held the first kernels of this pair (then a mode of
// fused_conv_body.cuh) at 5-8 % of that bound, measured on an H100 by
// stubbing one pass at a time (tools/geom_passes.py; PERF.md, "Inside
// kernels 5-6"): the CG, table-driven with four shared
// loads and a dependent chain per term, run three times in the backward
// (26 of 52 ns a row), the backward's dw @ w2^T with one shared load per
// FFMA (7.2), the hidden layers (4.0), and tiles of 8 rows. What this design
// does about each:
//  - The CG is unrolled at compile time for the instruction's shape
//    (l1, l2, l3): cg_patterns.cuh (generated from the port's own tables)
//    lists each shape's nonzero terms with their coefficients as immediates,
//    the operands sit in registers (x, sh and gm loaded once per row), and
//    the layer's path normalisation is one factor per instruction (its first
//    table coefficient over the pattern's), folded into w (forward) or gm
//    (backward). A switch on the shape picks the instance per column.
//  - The backward's three CG passes are one: a thread owns channel u of one
//    x entry (an "i1 class") on one row and runs every live instruction that
//    reads that entry. With G = C gm it forms T_m = sum G sh (-> dw = x . T,
//    dxg_m += w T_m: a plain sum in registers, no scan) and V_n = sum G x
//    (-> dsh_n += w V_n). dsh is summed over the warp's channels by a
//    transposing butterfly (16 shuffles for 16 values) and over the warps in
//    shared memory, in a fixed order. A thread covers mul/32 channels of its
//    class, so a warp is one row and every class costs about the same round.
//  - The MLP's inputs are row-minor in shared memory (h[k][e]): one 16-byte
//    load gives one k for four rows, so the output layer does 4 FFMA per
//    load with a quarter of the thread's w2 column in registers; the hidden
//    layers and pass E read the same way. Pass D holds 16 w2^T entries of
//    its columns in registers and reads the per-row dw as 16-byte
//    broadcasts (4 FFMA a load). Both kernels compute w = MLP * ms for a
//    tile in one pass into a per-row buffer, then run the CG from it: a
//    column of w2 and the CG operands in registers at once spilled.
//  - Tiles of 16 rows: the per-row w (and dw) rows of 576 columns are what
//    shared memory holds at two blocks per SM (backward) and three
//    (forward, which reads xg straight from global memory, once per
//    instruction, instead of staging it). The backward's w and dw share one
//    buffer: a thread reads w and writes dw of the same (row, column).
//  - Column work is (live column, row group): the host picks the number of
//    row groups per column (1, 2 or 4) that fills the 256 threads best at
//    the layer's column count (576, 256, 160 in the checkpoint). The forward
//    keeps one partial aggregate per row group and sums them in a fixed
//    order.
//  - Persistent blocks (the SMs times the blocks that fit per SM) walk over
//    the atoms, so the instruction and CG tables are loaded once per block.
//    Outputs written once (dxg, dvec, out) use streaming stores. The row
//    loads were under 3 % of either first kernel, so no copy ring is built.
//  - sin and cos: a three-part Cody-Waite reduction by pi/2 and minimax
//    polynomials (accurate to an ulp or two for |x| < 1e5; the Bessel
//    arguments c_n r stay under 8 pi). The library's slow path for huge
//    arguments kept a local-memory array in the first kernels.
//
// Resources (-Xptxas -v, which chip_smoke.py prints; PERF.md section 6): the
// forward is bound to three blocks of 256 threads per SM (80 registers,
// ~60 kB of shared memory at a mid layer), the backward to two (128
// registers, ~94 kB); no local memory, no tensor-core opcode. Latency
// decides both: the third block an SM made the forward faster; at three
// the backward spills.

#include "fused_conv_body.cuh"
#include "cg_patterns.cuh"

namespace {

constexpr int TF = 16;      // forward rows per tile (at most)
constexpr int TB = 16;      // backward rows per tile (at most)
constexpr int SHP = 16;     // sh row stride: (lmax + 1)^2 <= 16
constexpr int SLAB = 16;    // pass D: w2^T columns a thread holds
constexpr int QD = NT / H;  // pass D: column quarters
constexpr int NW = NT / 32; // warps per block
constexpr int MAX_XENT = 16;

// geometry of the geometry-fused kernels (see ops/fused_conv.py::GeomSpec)
struct Geom {
  const float* coeffs;    // nb Bessel frequencies c_n
  const int* sh_idx;      // per SH term: a | b << 4 | c << 8 | j << 12
  const float* sh_coef;   // per SH term: coefficient of ux^a uy^b uz^c in Y_j
  const int* sh_off;      // f + 1: term range of each SH component
  int n_terms;
  int env_kind;           // 0 polynomial, 1 XPLOR
  int normalize;          // SH of v/r (1) or of v (0)
  float cutoff, env_p, r_on;
};

// launch shape, chosen on the host (geom_shape below; mirrored by
// ops/fused_conv_geom.py, which the CPU tests hold)
struct Shape {
  int T;      // rows per tile, a multiple of 4
  int s;      // row groups per live column (T / s rows each)
  int nap;    // n_active rounded up to 4: row stride of w / dw
  int cq;     // pass D: columns per quarter, a multiple of 4
};

// act(x) and act'(x) from one exp (silu) or one tanh
__device__ __forceinline__ void act_both(float x, int act, float* f,
                                         float* df) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-x));
    *f = x * s;
    *df = s + x * s * (1.f - s);
  } else {
    const float t = tanhf(x);
    *f = t;
    *df = 1.f - t * t;
  }
}

__device__ __forceinline__ float ipow(float x, int k) {   // k <= 3
  float r = 1.f;
  for (int i = 0; i < k; ++i) r *= x;
  return r;
}

// sin and cos of x for |x| < 1e5: x = j pi/2 + r, |r| <= pi/4, by three
// fmaf steps (pi/2 split in three floats), then minimax polynomials in r^2
// (within 6.2e-8 of the double-precision values on |x| <= 30,
// tests/test_torch_geom_plan.py)
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  const float j = rintf(x * 0.636619772f);
  float r = fmaf(j, -1.57079601e+00f, x);
  r = fmaf(j, -3.13916473e-07f, r);
  r = fmaf(j, -5.39030253e-15f, r);
  const float r2 = r * r;
  float ps = 2.86567956e-06f;
  ps = fmaf(ps, r2, -1.98559923e-04f);
  ps = fmaf(ps, r2, 8.33338592e-03f);
  ps = fmaf(ps, r2, -1.66666672e-01f);
  const float sr = fmaf(ps * r2, r, r);
  float pc = 2.44677067e-05f;
  pc = fmaf(pc, r2, -1.38877297e-03f);
  pc = fmaf(pc, r2, 4.16666567e-02f);
  pc = fmaf(pc, r2, -5.00000000e-01f);
  const float cr = fmaf(pc, r2, 1.f);
  const int q = (int)j & 3;
  const float sv = (q & 1) ? cr : sr, cv = (q & 1) ? sr : cr;
  *s = (q & 2) ? -sv : sv;
  *c = ((q + 1) & 2) ? -cv : cv;
}

// r, 1/r, the envelope and its derivative in r of one edge vector
struct Radial { float r, inv_r, env, denv; };

__device__ __forceinline__ Radial radial_of(const Geom& G, float x, float y,
                                            float z) {
  Radial R;
  const float r2 = x * x + y * y + z * z;
  R.r = sqrtf(r2 + 1e-30f);
  R.inv_r = 1.f / R.r;
  if (G.env_kind == 0) {
    const float p = G.env_p;
    const float c0 = (p + 1.f) * (p + 2.f) * 0.5f, c1 = p * (p + 2.f),
                c2 = p * (p + 1.f) * 0.5f;
    const float rr = R.r * (1.f / G.cutoff);
    const float rp = powf(rr, p), rp1 = powf(rr, p - 1.f);
    R.env = 1.f - c0 * rp + c1 * rp * rr - c2 * rp * rr * rr;
    R.denv = (-c0 * p * rp1 + c1 * (p + 1.f) * rp
              - c2 * (p + 2.f) * rp * rr) / G.cutoff;
  } else {
    const float rc2 = G.cutoff * G.cutoff, ron2 = G.r_on * G.r_on;
    const float d = rc2 - ron2, inv_den = 1.f / (d * d * d);
    const float a = rc2 - r2;
    const bool inside = R.r < G.r_on;
    // the smooth branch is not zero beyond the cutoff: only ms removes
    // those rows
    R.env = inside ? 1.f : a * a * (rc2 + 2.f * r2 - 3.f * ron2) * inv_den;
    R.denv = inside ? 0.f : 12.f * a * (ron2 - r2) * inv_den * R.r;
  }
  return R;
}

// emb (row-minor: basis n of row e at n * T + e) and sh (row e at e * SHP,
// zeros past f) of a tile's rows, one thread per (row, basis function or SH
// component). Not synced.
__device__ void geom_rows(const Plan& P, const Geom& G, int T, int rows,
                          const float* vec_s, float* embT_s, float* sh_s) {
  const int per = P.nb + SHP;
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
    if (k < P.nb) {
      const Radial R = radial_of(G, x, y, z);
      float s, c;
      sin_cos(__ldg(G.coeffs + k) * R.r, &s, &c);
      embT_s[k * T + e] = s * ((2.f / G.cutoff) * R.inv_r * R.env);
    } else {
      const int j = k - P.nb;
      float v = 0.f;
      if (j < P.f) {
        float ux = x, uy = y, uz = z;
        if (G.normalize) {
          const float inv_r = 1.f / sqrtf(x * x + y * y + z * z + 1e-30f);
          ux *= inv_r; uy *= inv_r; uz *= inv_r;
        }
        const int t1 = __ldg(G.sh_off + j + 1);
        for (int t = __ldg(G.sh_off + j); t < t1; ++t) {
          const int id = __ldg(G.sh_idx + t);
          v = fmaf(__ldg(G.sh_coef + t),
                   ipow(ux, id & 15) * ipow(uy, (id >> 4) & 15)
                       * ipow(uz, (id >> 8) & 15), v);
        }
      }
      sh_s[e * SHP + j] = v;
    }
  }
}

// geometry VJP of a tile: (demb row-minor, dsh at e * SHP) -> dvec rows in
// global memory, four rows a warp, eight lanes a row over the basis
// functions and the SH terms. Rows with ms == 0 get zeros.
__device__ void geom_vjp(const Plan& P, const Geom& G, int T, int rows,
                         long row0, const float* vec_s, const float* ms_s,
                         const float* dembT_s, const float* dsh_s,
                         float* __restrict__ dvec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane & 7;
  for (int e0 = 4 * warp; e0 < rows; e0 += 4 * NW) {
    const int e = e0 + (lane >> 3);
    const bool ok = e < rows;
    const int ee = ok ? e : e0;
    const float x = vec_s[3 * ee], y = vec_s[3 * ee + 1],
                z = vec_s[3 * ee + 2];
    const Radial R = radial_of(G, x, y, z);
    float ux = x, uy = y, uz = z;
    if (G.normalize) { ux *= R.inv_r; uy *= R.inv_r; uz *= R.inv_r; }
    float gr = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    if (ok && ms_s[ee] != 0.f) {
      // d emb_n / dr = (2/rc) [(c cos(cr)/r - sin(cr)/r^2) env
      //                        + sin(cr)/r env']
      for (int n = sl; n < P.nb; n += 8) {
        const float c = __ldg(G.coeffs + n);
        float s, co;
        sin_cos(c * R.r, &s, &co);
        const float d = (2.f / G.cutoff)
                        * ((c * co - s * R.inv_r) * R.inv_r * R.env
                           + s * R.inv_r * R.denv);
        gr = fmaf(dembT_s[n * T + ee], d, gr);
      }
      // gu = sum_j dsh_j dY_j/du, term by term
      for (int t = sl; t < G.n_terms; t += 8) {
        const int id = __ldg(G.sh_idx + t);
        const int a = id & 15, b = (id >> 4) & 15, c = (id >> 8) & 15;
        const float gj = dsh_s[ee * SHP + (id >> 12)] * __ldg(G.sh_coef + t);
        if (a) gx = fmaf(gj, a * ipow(ux, a - 1) * ipow(uy, b) * ipow(uz, c),
                         gx);
        if (b) gy = fmaf(gj, b * ipow(ux, a) * ipow(uy, b - 1) * ipow(uz, c),
                         gy);
        if (c) gz = fmaf(gj, c * ipow(ux, a) * ipow(uy, b) * ipow(uz, c - 1),
                         gz);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      gr += __shfl_xor_sync(0xffffffffu, gr, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
      gy += __shfl_xor_sync(0xffffffffu, gy, o);
      gz += __shfl_xor_sync(0xffffffffu, gz, o);
    }
    if (ok && sl == 0) {
      float dx = gx, dy = gy, dz = gz;
      if (G.normalize) {     // u = v/r: du/dv = (I - u u^T)/r
        const float dot = ux * gx + uy * gy + uz * gz;
        dx = (gx - ux * dot) * R.inv_r;
        dy = (gy - uy * dot) * R.inv_r;
        dz = (gz - uz * dot) * R.inv_r;
      }
      // dr/dv = v/r
      float* o = dvec + (row0 + e) * 3;
      __stcs(o, fmaf(gr, x * R.inv_r, dx));
      __stcs(o + 1, fmaf(gr, y * R.inv_r, dy));
      __stcs(o + 2, fmaf(gr, z * R.inv_r, dz));
    }
  }
}

// the hidden layers for a tile, row-minor (entry k of row e at k * T + e):
// h0 = act(s0 emb w0) cst, h1 = act(s1 h0 w1) cst, and with da0/da1 the
// activations' derivatives times cst. Layer 1: a thread owns one output j
// and four rows, one 16-byte load of h0 per 4 FFMA. Ends synchronised.
__device__ void hidden_rm(const Plan& P, int T, const float* embT_s,
                          const float* __restrict__ w0,
                          const float* __restrict__ w1, float* h0T_s,
                          float* h1T_s, float* da0T_s, float* da1T_s) {
  for (int i = threadIdx.x; i < T * H; i += NT) {
    const int j = i / T, e = i - j * T;
    float s = 0.f;
    for (int b = 0; b < P.nb; ++b)
      s = fmaf(embT_s[b * T + e], __ldg(w0 + b * H + j), s);
    s *= P.s0;
    if (da0T_s) {
      float f, df;
      act_both(s, P.act, &f, &df);
      h0T_s[i] = f * P.act_cst;
      da0T_s[i] = df * P.act_cst;
    } else {
      h0T_s[i] = act_f(s, P.act) * P.act_cst;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (T / 4) * H; i += NT) {
    const int q = (i / H) * 4, j = i % H;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float4 h = *reinterpret_cast<const float4*>(h0T_s + k * T + q);
      const float w = __ldg(w1 + k * H + j);
      a0 = fmaf(h.x, w, a0); a1 = fmaf(h.y, w, a1);
      a2 = fmaf(h.z, w, a2); a3 = fmaf(h.w, w, a3);
    }
    const float a[4] = {a0 * P.s1, a1 * P.s1, a2 * P.s1, a3 * P.s1};
    float o[4], d[4];
#pragma unroll
    for (int i4 = 0; i4 < 4; ++i4) {
      if (da1T_s) {
        act_both(a[i4], P.act, &o[i4], &d[i4]);
      } else {
        o[i4] = act_f(a[i4], P.act);
        d[i4] = 0.f;
      }
    }
    *reinterpret_cast<float4*>(h1T_s + j * T + q) = make_float4(
        o[0] * P.act_cst, o[1] * P.act_cst, o[2] * P.act_cst,
        o[3] * P.act_cst);
    if (da1T_s)
      *reinterpret_cast<float4*>(da1T_s + j * T + q) = make_float4(
          d[0] * P.act_cst, d[1] * P.act_cst, d[2] * P.act_cst,
          d[3] * P.act_cst);
  }
  __syncthreads();
}

// the layer's path normalisation of one instruction against the pattern's
// (fan-in 1): its first p-sorted table term over the pattern's first
template <int L1, int L2, int L3>
__device__ __forceinline__ float pattern_scale(const int* I,
                                               const float* nzc_s) {
  return nzc_s[I[I_POFF]] * (1.f / CgPattern<L1, L2, L3>::c0);
}

__device__ __forceinline__ int shape_key(const int* I) {
  return ((I[I_DIM1] - 1) / 2) * 16 + ((I[I_DIM2] - 1) / 2) * 4
         + (I[I_DIM3] - 1) / 2;
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------

// the radial weights w = MLP * s2 * ms of a tile's rows into w_s (row e at
// e * nap), per (live column, row group of R rows): R sums in registers,
// the w2 column in four quarters of 16 registers, one 16-byte load of h1
// per four FFMA (rows past the tile's are computed and not stored)
template <int R>
__device__ __forceinline__ void w_rows_r(const Plan& P, const Shape& S,
                                         int rows, const float* h1T_s,
                                         const float* ms_s,
                                         const float* __restrict__ w2,
                                         float* w_s) {
  for (int j = threadIdx.x; j < P.n_active * S.s; j += NT) {
    const int c = j % P.n_active, g = j / P.n_active;
    const int e0 = g * R, e1 = min(e0 + R, rows);
    if (e0 >= e1) continue;
    const float* wg = w2 + __ldg(P.col_w + c);
    float acc[R];
#pragma unroll
    for (int e = 0; e < R; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int part = 0; part < 4; ++part) {
      float wc[H / 4];
#pragma unroll
      for (int k = 0; k < H / 4; ++k)
        wc[k] = __ldg(wg + (long)(part * (H / 4) + k) * P.wn);
#pragma unroll
      for (int k = 0; k < H / 4; ++k) {
        const float* hk = h1T_s + (part * (H / 4) + k) * S.T + e0;
#pragma unroll
        for (int i = 0; i < R / 4; ++i) {
          const float4 h = *reinterpret_cast<const float4*>(hk + 4 * i);
          acc[4 * i] = fmaf(h.x, wc[k], acc[4 * i]);
          acc[4 * i + 1] = fmaf(h.y, wc[k], acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(h.z, wc[k], acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(h.w, wc[k], acc[4 * i + 3]);
        }
        // at most two k of h1 loads in flight: ptxas hoists them all
        // otherwise and spills past 128 registers
        if (k % 2 == 1) asm volatile("" ::: "memory");
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e)
      if (e0 + e < e1) w_s[(e0 + e) * S.nap + c] = acc[e] * P.s2 * ms_s[e0 + e];
  }
}

__device__ __forceinline__ void w_rows(const Plan& P, const Shape& S,
                                       int rows, const float* h1T_s,
                                       const float* ms_s,
                                       const float* __restrict__ w2,
                                       float* w_s) {
  switch (S.T / S.s) {
    case 4: w_rows_r<4>(P, S, rows, h1T_s, ms_s, w2, w_s); break;
    case 8: w_rows_r<8>(P, S, rows, h1T_s, ms_s, w2, w_s); break;
    case 12: w_rows_r<12>(P, S, rows, h1T_s, ms_s, w2, w_s); break;
    default: w_rows_r<16>(P, S, rows, h1T_s, ms_s, w2, w_s); break;
  }
}

// the CG of one (live column, row group) of the forward: its partial
// aggregate over rows [e0, e1) of the tile, added to its own slots of aggp
template <int L1, int L2, int L3>
__device__ __forceinline__ void fwd_cg(const Plan& P, const int* I, int u,
                                       int c, float sc,
                                       const float* __restrict__ xr,
                                       const float* sh_s, const float* w_s,
                                       int nap, int e0, int e1,
                                       float* aggp) {
  constexpr int D1 = 2 * L1 + 1, D2 = 2 * L2 + 1, D3 = 2 * L3 + 1;
  float acc[D3];
#pragma unroll
  for (int p = 0; p < D3; ++p) acc[p] = 0.f;
  const int mul = I[I_MUL];
  const float* xb = xr + I[I_XOFF] + u;
  const float* sb = sh_s + L2 * L2;
  for (int e = e0; e < e1; ++e) {
    const float w = w_s[e * nap + c];
    if (w == 0.f) continue;              // grid pad row: no message
    float xv[D1], sv[D2], s[D3];
#pragma unroll
    for (int m = 0; m < D1; ++m) xv[m] = __ldg(xb + e * P.d1 + m * mul);
#pragma unroll
    for (int n = 0; n < D2; ++n) sv[n] = sb[e * SHP + n];
#pragma unroll
    for (int p = 0; p < D3; ++p) s[p] = 0.f;
    CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
      s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                   sv[decltype(n)::value],
                                   s[decltype(p)::value]);
    });
#pragma unroll
    for (int p = 0; p < D3; ++p) acc[p] = fmaf(w, s[p], acc[p]);
  }
  float* ab = aggp + I[I_AGG] + u;
  const int K = I[I_K];
#pragma unroll
  for (int p = 0; p < D3; ++p) ab[p * K] += acc[p] * sc;
}

__global__ void __launch_bounds__(NT, 3)
fused_conv_geom_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ vec,
                           const float* __restrict__ ms,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2,
                           const float* __restrict__ si2w, Plan P, Geom G,
                           Shape S, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = S.T;
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) {
    float* q = next_s; next_s += (n + 3) & ~3; return q;
  };
  float* sc_s = take(P.n_ins);
  float* sh_s = take(T * SHP);
  float* embT_s = take(T * P.nb);
  float* vec_s = take(T * 3);
  float* ms_s = take(T);
  float* h0T_s = take(T * H);
  float* h1T_s = take(T * H);
  float* w_s = take(T * S.nap);
  float* aggp_s = take(S.s * P.agg_dim);
  float* out_s = take(P.d_out);

  const int tid = threadIdx.x;
  load_tables(P, ins_s, nzi_s, nzc_s);
  __syncthreads();
  for (int i = tid; i < P.n_ins; i += NT) {
    const int* I = ins_s + i * I_STRIDE;
    float sc = 0.f;
    switch (shape_key(I)) {
#define GEOM_SCALE_CASE(a, b, c) \
      case a * 16 + b * 4 + c: sc = pattern_scale<a, b, c>(I, nzc_s); break;
      CG_SHAPES(GEOM_SCALE_CASE)
#undef GEOM_SCALE_CASE
    }
    sc_s[i] = sc;
  }
  const int R = T / S.s;                 // rows per row group

  for (int atom = blockIdx.x; atom < P.n_atoms; atom += gridDim.x) {
    __syncthreads();
    for (int i = tid; i < S.s * P.agg_dim; i += NT) aggp_s[i] = 0.f;
    for (int t0 = 0; t0 < P.D; t0 += T) {
      const long row0 = (long)atom * P.D + t0;
      const int rows = min(T, P.D - t0);
      __syncthreads();
      const float* xr = xg + row0 * P.d1;
      for (int i = tid; i < rows * 3; i += NT) vec_s[i] = vec[row0 * 3 + i];
      for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      __syncthreads();
      geom_rows(P, G, T, rows, vec_s, embT_s, sh_s);
      __syncthreads();
      hidden_rm(P, T, embT_s, w0, w1, h0T_s, h1T_s, nullptr, nullptr);
      w_rows(P, S, rows, h1T_s, ms_s, w2, w_s);
      __syncthreads();
      for (int j = tid; j < P.n_active * S.s; j += NT) {
        const int c = j % P.n_active, g = j / P.n_active;
        const int e0 = g * R, e1 = min(e0 + R, rows);
        if (e0 >= e1) continue;
        const int ii = __ldg(P.col_ins + c);
        const int* I = ins_s + ii * I_STRIDE;
        const int u = c - I[I_COL0];
        float* aggp = aggp_s + g * P.agg_dim;
        switch (shape_key(I)) {
#define GEOM_FWD_CASE(A, B, C)                                              \
          case A * 16 + B * 4 + C:                                          \
            fwd_cg<A, B, C>(P, I, u, c, sc_s[ii], xr, sh_s, w_s, S.nap,     \
                            e0, e1, aggp);                                  \
            break;
          CG_SHAPES(GEOM_FWD_CASE)
#undef GEOM_FWD_CASE
        }
      }
    }
    __syncthreads();
    // the row groups' partial aggregates, summed in a fixed order
    for (int i = tid; i < P.agg_dim; i += NT) {
      float a = aggp_s[i];
      for (int g = 1; g < S.s; ++g) a += aggp_s[g * P.agg_dim + i];
      aggp_s[i] = a;
    }
    for (int i = tid; i < P.d_out; i += NT) out_s[i] = 0.f;
    __syncthreads();
    // per-atom self-interaction 2 over the aggregated messages
    for (int g = 0; g < P.n_grp; ++g) {
      const int* Gr = P.grp + g * G_STRIDE;
      const int K = Gr[G_K], mo = Gr[G_MO], n = Gr[G_DIM3] * mo;
      const float alpha = P.grp_alpha[g];
      const float* W = si2w + Gr[G_WOFF];
      const float* a = aggp_s + Gr[G_AGG];
      for (int t = tid; t < n; t += NT) {
        const int p = t / mo, o = t - p * mo;
        const float* ap = a + p * K;
        float s = 0.f;
        for (int r = 0; r < K; ++r)
          s = fmaf(ap[r], __ldg(W + (long)r * mo + o), s);
        out_s[Gr[G_OUT] + p * mo + o] = s * alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < P.d_out; i += NT)
      __stcs(out + (long)atom * P.d_out + i, out_s[i]);
  }
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

// one instruction of an i1 class at one (row, channel): the CG backward of
// all three cotangents from registers (see the note at the top)
template <int NSH, int L1, int L2, int L3>
__device__ __forceinline__ void bwd_ins(const int* I, int u, float sc,
                                        const float* gm_s, float* wdw_row,
                                        float m_e,
                                        const float (&xv)[2 * L1 + 1],
                                        const float (&sv)[(NSH + 3) & ~3],
                                        float (&dx)[2 * L1 + 1],
                                        float (&dsh)[NSH]) {
  constexpr int D1 = 2 * L1 + 1, D2 = 2 * L2 + 1, D3 = 2 * L3 + 1;
  const int c = I[I_COL0] + u;
  const float w = wdw_row[c];
  const float* gb = gm_s + I[I_AGG] + u;
  const int K = I[I_K];
  float gmv[D3], t[D1], v[D2];
#pragma unroll
  for (int p = 0; p < D3; ++p) gmv[p] = gb[p * K] * sc;
#pragma unroll
  for (int m = 0; m < D1; ++m) t[m] = 0.f;
#pragma unroll
  for (int n = 0; n < D2; ++n) v[n] = 0.f;
  CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
    const float g = cf * gmv[decltype(p)::value];
    t[decltype(m)::value] = fmaf(g, sv[L2 * L2 + decltype(n)::value],
                                 t[decltype(m)::value]);
    v[decltype(n)::value] = fmaf(g, xv[decltype(m)::value],
                                 v[decltype(n)::value]);
  });
  float dw = 0.f;
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    dw = fmaf(xv[m], t[m], dw);
    dx[m] = fmaf(w, t[m], dx[m]);
  }
#pragma unroll
  for (int n = 0; n < D2; ++n)
    dsh[L2 * L2 + n] = fmaf(w, v[n], dsh[L2 * L2 + n]);
  wdw_row[c] = dw * m_e;
}

// per-block table of the i1 classes (the x entries)
struct XClass { int start, lanes, uit, xe, l1; };

// one item of an i1 class: channels lane_u, lane_u + 32, ... (uit of them)
// of x entry X on row e, every live instruction of the entry
template <int NSH, int L1>
__device__ __forceinline__ void bwd_class_item(
    const Plan& P, const int* X, const int* ins_s, const float* sc_s,
    const float* gm_s, const float* __restrict__ xg, float* __restrict__ dxg,
    long row, float m_e, const float (&sv)[(NSH + 3) & ~3], float* wdw_row,
    int lane_u, int uit, float (&dsh)[NSH]) {
  constexpr int D1 = 2 * L1 + 1;
  const int xoff = X[X_OFF], mul = X[X_MUL], nins = X[X_NINS];
  const int* users = P.xins + X[X_INS0];
  for (int it = 0; it < uit; ++it) {
    const int u = lane_u + 32 * it;
    float xv[D1], dx[D1];
    const float* xr = xg + row * P.d1 + xoff + u;
#pragma unroll
    for (int m = 0; m < D1; ++m) {
      xv[m] = m_e != 0.f ? __ldcs(xr + m * mul) : 0.f;
      dx[m] = 0.f;
    }
    for (int j = 0; j < nins; ++j) {
      const int ii = __ldg(users + j);
      const int* I = ins_s + ii * I_STRIDE;
      if (m_e == 0.f) {             // grid pad row: dw = 0, nothing flows
        wdw_row[I[I_COL0] + u] = 0.f;
        continue;
      }
      switch (shape_key(I)) {
#define GEOM_BWD_CASE(a, b, c)                                              \
        case a * 16 + b * 4 + c:                                            \
          if constexpr (a == L1 && (b + 1) * (b + 1) <= NSH)                \
            bwd_ins<NSH, a, b, c>(I, u, sc_s[ii], gm_s, wdw_row, m_e, xv,   \
                                  sv, dx, dsh);                             \
          break;
        CG_SHAPES(GEOM_BWD_CASE)
#undef GEOM_BWD_CASE
      }
    }
    float* dr = dxg + row * P.d1 + xoff + u;
#pragma unroll
    for (int m = 0; m < D1; ++m) __stcs(dr + m * mul, dx[m]);
  }
}

// sum 16 values over the 32 lanes of a warp: each step hands half of the
// values to the partner lane, so lane l ends with the total of value
// butterfly_index(l) (lanes l and l ^ 1 alike)
template <int O>
__device__ __forceinline__ void butterfly_step(float (&v)[SHP], int lane) {
  constexpr int HALF = O / 2;
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? v[i] : v[i + HALF];
    const float keep = up ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <int NSH>
__device__ __forceinline__ float butterfly16(const float (&dsh)[NSH],
                                             int lane) {
  float v[SHP];
#pragma unroll
  for (int i = 0; i < SHP; ++i) v[i] = i < NSH ? dsh[i] : 0.f;
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__device__ __forceinline__ int butterfly_index(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4
         + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
}

// NSH: (lmax + 1)^2 of the filter, 4, 9 or 16: the size of the per-thread
// sh and dsh arrays
template <int NSH>
__global__ void __launch_bounds__(NT, 2)
fused_conv_geom_bwd_kernel(const float* __restrict__ gout,
                           const float* __restrict__ xg,
                           const float* __restrict__ vec,
                           const float* __restrict__ ms,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ w1t,
                           const float* __restrict__ w2,
                           const float* __restrict__ w2t,
                           const float* __restrict__ si2wt, Plan P, Geom G,
                           Shape S, float* __restrict__ dxg,
                           float* __restrict__ dvec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = S.T;
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) {
    float* q = next_s; next_s += (n + 3) & ~3; return q;
  };
  float* sc_s = take(P.n_ins);
  XClass* cls_s = reinterpret_cast<XClass*>(take(MAX_XENT * 5));
  float* g_s = take(P.d_out);
  float* gm_s = take(P.agg_dim);                   // si2^T g
  float* wdw_s = take(TB * S.nap + SLAB);          // w, then dw, per row
  float* h0T_s = take(T * H);                      // then dpre0
  float* h1T_s = take(T * H);                      // then dpre1
  float* da0T_s = take(T * H);
  float* da1T_s = take(T * H);
  float* red_s = take(QD * T * H);                 // pass D partials
  float* dshp_s = take(NW * T * SHP);              // dsh partials per warp
  float* dsh_s = take(T * SHP);
  float* sh_s = take(T * SHP);
  float* embT_s = take(T * P.nb);                  // then demb
  float* vec_s = take(T * 3);
  float* ms_s = take(T);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_tables(P, ins_s, nzi_s, nzc_s);
  // w / dw rows start as zeros: pass D reads its 16-byte groups past a
  // quarter's last column (times a zero weight) and all TB rows
  for (int i = tid; i < TB * S.nap + SLAB; i += NT) wdw_s[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < P.n_ins; i += NT) {
    const int* I = ins_s + i * I_STRIDE;
    float sc = 0.f;
    switch (shape_key(I)) {
#define GEOM_SCALE_CASE(a, b, c) \
      case a * 16 + b * 4 + c: sc = pattern_scale<a, b, c>(I, nzc_s); break;
      CG_SHAPES(GEOM_SCALE_CASE)
#undef GEOM_SCALE_CASE
    }
    sc_s[i] = sc;
  }
  // the i1 classes (x entries): item ranges for T rows, each padded to a
  // warp
  int n_items = 0;
  if (tid == 0) {
    int nc = 0;
    for (int xe = 0; xe < P.n_xent && nc < MAX_XENT; ++xe) {
      // every x entry, users or not: a thread writes its dxg columns
      const int* X = P.xent + xe * X_STRIDE;
      const int mul = X[X_MUL];
      XClass C;
      C.lanes = mul % 32 == 0 ? 32 : mul;
      C.uit = mul % 32 == 0 ? mul / 32 : 1;
      C.start = n_items;
      C.xe = xe;
      C.l1 = (X[X_DIM] - 1) / 2;
      cls_s[nc++] = C;
      n_items += (T * C.lanes + 31) & ~31;
    }
    cls_s[nc].start = n_items;          // end marker
    cls_s[nc].xe = -1;
  }
  __syncthreads();
  {
    int k = 0;
    while (cls_s[k].xe >= 0) ++k;
    n_items = cls_s[k].start;
  }

  for (int atom = blockIdx.x; atom < P.n_atoms; atom += gridDim.x) {
    __syncthreads();
    for (int i = tid; i < P.d_out; i += NT)
      g_s[i] = gout[(long)atom * P.d_out + i];
    __syncthreads();
    // message cotangent, once per atom: gm[p][r] = alpha sum_o W[r,o] g[p,o]
    for (int g = 0; g < P.n_grp; ++g) {
      const int* Gr = P.grp + g * G_STRIDE;
      const int K = Gr[G_K], mo = Gr[G_MO], n = Gr[G_DIM3] * K;
      const float alpha = P.grp_alpha[g];
      const float* WT = si2wt + Gr[G_WOFF];   // (mo, K)
      for (int t = tid; t < n; t += NT) {
        const int p = t / K, r = t - p * K;
        const float* gp = g_s + Gr[G_OUT] + p * mo;
        float s = 0.f;
        for (int o = 0; o < mo; ++o)
          s = fmaf(__ldg(WT + (long)o * K + r), gp[o], s);
        gm_s[Gr[G_AGG] + p * K + r] = s * alpha;
      }
    }

    for (int t0 = 0; t0 < P.D; t0 += T) {
      const long row0 = (long)atom * P.D + t0;
      const int rows = min(T, P.D - t0);
      __syncthreads();
      for (int i = tid; i < rows * 3; i += NT) vec_s[i] = vec[row0 * 3 + i];
      for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      for (int i = tid; i < NW * T * SHP; i += NT) dshp_s[i] = 0.f;
      __syncthreads();
      geom_rows(P, G, T, rows, vec_s, embT_s, sh_s);
      __syncthreads();
      hidden_rm(P, T, embT_s, w0, w1, h0T_s, h1T_s, da0T_s, da1T_s);

      w_rows(P, S, rows, h1T_s, ms_s, w2, wdw_s);
      __syncthreads();

      // the CG backward by i1 class: dxg, dw (in place of w), dsh partials
      for (int j0 = warp * 32; j0 < n_items; j0 += NT) {
        int k = 0;
        while (cls_s[k + 1].xe >= 0 && cls_s[k + 1].start <= j0) ++k;
        const XClass C = cls_s[k];
        const int loc = j0 + lane - C.start;
        const int e = loc / C.lanes, lane_u = loc - e * C.lanes;
        const bool valid = e < rows;
        float dsh[NSH];
#pragma unroll
        for (int n = 0; n < NSH; ++n) dsh[n] = 0.f;
        if (valid) {
          const int* X = P.xent + C.xe * X_STRIDE;
          float sv[(NSH + 3) & ~3];
#pragma unroll
          for (int n = 0; n < ((NSH + 3) & ~3); n += 4) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(sh_s + e * SHP + n);
            sv[n] = s4.x; sv[n + 1] = s4.y; sv[n + 2] = s4.z; sv[n + 3] = s4.w;
          }
          const long row = row0 + e;
          const float m_e = ms_s[e];
          float* wdw_row = wdw_s + e * S.nap;
          switch (C.l1) {
#define GEOM_CLASS_CASE(l)                                                 \
            case l:                                                        \
              bwd_class_item<NSH, l>(P, X, ins_s, sc_s, gm_s, xg, dxg,     \
                                     row, m_e, sv, wdw_row, lane_u, C.uit, \
                                     dsh);                                 \
              break;
            GEOM_CLASS_CASE(0) GEOM_CLASS_CASE(1) GEOM_CLASS_CASE(2)
            GEOM_CLASS_CASE(3)
#undef GEOM_CLASS_CASE
          }
        }
        if (C.lanes == 32) {
          // the warp is one row (or past the tile's rows, all lanes alike)
          const float tot = butterfly16(dsh, lane);
          if (valid && !(lane & 1))
            dshp_s[(warp * T + e) * SHP + butterfly_index(lane)] += tot;
        } else {
          // a warp spans rows (multiplicity under 32): lane by lane
          for (int l = 0; l < 32; ++l) {
            if (lane == l && valid) {
#pragma unroll
              for (int n = 0; n < NSH; ++n)
                dshp_s[(warp * T + e) * SHP + n] += dsh[n];
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();

      // pass D: dh1 = dw @ w2^T, thread (quarter q, k): 16 w2^T entries in
      // registers, the rows' dw as 16-byte broadcasts; and the dsh sums
      {
        const int k = tid % H, q = tid / H;
        const int c_lo = q * S.cq, c_hi = min(c_lo + S.cq, P.n_active);
        float acc[TB];
#pragma unroll
        for (int e = 0; e < TB; ++e) acc[e] = 0.f;
        for (int c0 = c_lo; c0 < c_hi; c0 += SLAB) {
          float wr[SLAB];
#pragma unroll
          for (int i = 0; i < SLAB; ++i)
            wr[i] = c0 + i < c_hi
                        ? __ldg(w2t + (long)__ldg(P.col_w + c0 + i) * H + k)
                        : 0.f;
          // all TB rows (those past the tile's read finite stale rows and
          // are not stored): the 16 sums interleave
#pragma unroll
          for (int i = 0; i < SLAB / 4; ++i) {
#pragma unroll
            for (int e = 0; e < TB; ++e) {
              const float4 d = *reinterpret_cast<const float4*>(
                  wdw_s + e * S.nap + c0 + 4 * i);
              acc[e] = fmaf(d.x, wr[4 * i], acc[e]);
              acc[e] = fmaf(d.y, wr[4 * i + 1], acc[e]);
              acc[e] = fmaf(d.z, wr[4 * i + 2], acc[e]);
              acc[e] = fmaf(d.w, wr[4 * i + 3], acc[e]);
            }
          }
        }
#pragma unroll
        for (int e = 0; e < TB; ++e)
          if (e < rows) red_s[(q * T + e) * H + k] = acc[e];
      }
      for (int i = tid; i < rows * SHP; i += NT) {
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += dshp_s[w * T * SHP + i];
        dsh_s[i] = s;
      }
      __syncthreads();
      // dpre1 = dh1 * s2 * act'(pre1), row-minor into h1T_s
      for (int i = tid; i < rows * H; i += NT) {
        const int e = i / H, k = i - e * H;
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < QD; ++q) s += red_s[(q * T + e) * H + k];
        h1T_s[k * T + e] = s * P.s2 * da1T_s[k * T + e];
      }
      __syncthreads();
      // pass E: dpre0 = (dpre1 @ w1^T) * s1 * act'(pre0), row-minor into
      // h0T_s; a thread owns one j and four rows
      for (int i = tid; i < (T / 4) * H; i += NT) {
        const int q = (i / H) * 4, j = i % H;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 d = *reinterpret_cast<const float4*>(h1T_s + k * T + q);
          const float w = __ldg(w1t + k * H + j);
          a0 = fmaf(d.x, w, a0); a1 = fmaf(d.y, w, a1);
          a2 = fmaf(d.z, w, a2); a3 = fmaf(d.w, w, a3);
        }
        const float4 da = *reinterpret_cast<const float4*>(da0T_s + j * T + q);
        float4 o;
        o.x = a0 * P.s1 * da.x; o.y = a1 * P.s1 * da.y;
        o.z = a2 * P.s1 * da.z; o.w = a3 * P.s1 * da.w;
        *reinterpret_cast<float4*>(h0T_s + j * T + q) = o;
      }
      __syncthreads();
      // pass F: demb = s0 dpre0 @ w0^T, one thread per (basis, row)
      for (int i = tid; i < P.nb * T; i += NT) {
        const int b = i / T, e = i - b * T;
        const float* wr = w0 + b * H;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < H; ++j) s = fmaf(h0T_s[j * T + e], __ldg(wr + j), s);
        embT_s[i] = s * P.s0;
      }
      __syncthreads();
      geom_vjp(P, G, T, rows, row0, vec_s, ms_s, embT_s, dsh_s, dvec);
    }
  }
}

// ---------------------------------------------------------------------
// host side: launch shape, shared memory, persistent grid
// ---------------------------------------------------------------------

// the tile: at most tmax rows, D rounded up to 4 when that is fewer
int tile_rows(int D, int tmax) {
  const int d4 = (D + 3) & ~3;
  return d4 < tmax ? d4 : tmax;
}

size_t fwd_words(const Plan& P, const Shape& S) {
  auto r4 = [](size_t n) { return (n + 3) & ~(size_t)3; };
  const size_t T = S.T;
  return (size_t)table_words(P) + r4(P.n_ins) + r4(T * SHP)
         + r4(T * P.nb) + r4(T * 3) + r4(T) + 2 * r4(T * H)
         + r4(T * S.nap) + r4((size_t)S.s * P.agg_dim) + r4(P.d_out);
}

size_t bwd_words(const Plan& P, const Shape& S) {
  auto r4 = [](size_t n) { return (n + 3) & ~(size_t)3; };
  const size_t T = S.T;
  return (size_t)table_words(P) + r4(P.n_ins) + r4(MAX_XENT * 5)
         + r4(P.d_out) + r4(P.agg_dim) + r4(TB * S.nap + SLAB) + 4 * r4(T * H)
         + r4(QD * T * H) + r4(NW * T * SHP) + 2 * r4(T * SHP)
         + r4(T * P.nb) + r4(T * 3) + r4(T);
}

// shared memory of one block when two fit on an SM (228 KB, 1 KB of it
// reserved per block)
constexpr size_t TWO_PER_SM = (233472 - 2 * 1024) / 2;

// rows per tile and row groups per column: the groups (1, 2 or 4, each a
// multiple of 4 rows) that take the fewest rounds of the block's threads,
// a w2 column load counted as 4 rows of work, within two blocks an SM
Shape geom_shape(const Plan& P, int tmax, bool bwd) {
  Shape S;
  S.T = tile_rows(P.D, tmax);
  S.nap = (P.n_active + 3) & ~3;
  S.cq = ((P.n_active + QD - 1) / QD + 3) & ~3;
  S.s = 1;
  long best = -1;
  for (int s = 1; s <= 4; s *= 2) {
    if (S.T % (4 * s)) break;
    Shape t = S;
    t.s = s;
    const size_t bytes = 4 * (bwd ? bwd_words(P, t) : fwd_words(P, t));
    if (s > 1 && bytes > TWO_PER_SM) break;
    const long rounds = ((long)P.n_active * s + NT - 1) / NT;
    const long cost = rounds * (S.T / s + 4);
    if (best < 0 || cost < best) { best = cost; S.s = s; }
  }
  return S;
}

// persistent grid: the SMs times the blocks that fit on one
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int n_atoms,
                            int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) return err;
  const int fit = sms * per_sm > 1 ? sms * per_sm : 1;
  *grid = n_atoms < fit ? n_atoms : fit;
  return cudaSuccess;
}

}  // namespace

static size_t geom_fwd_reserved[MAX_DEVICES], geom_bwd_reserved[MAX_DEVICES];

#define GEOM_ARGS                                                          \
  const float *coeffs, const int *sh_idx, const float *sh_coef,            \
      const int *sh_off, int n_terms, int env_kind, int normalize,         \
      float cutoff, float env_p, float r_on

static Geom make_geom(GEOM_ARGS) {
  Geom G;
  G.coeffs = coeffs; G.sh_idx = sh_idx; G.sh_coef = sh_coef;
  G.sh_off = sh_off; G.n_terms = n_terms; G.env_kind = env_kind;
  G.normalize = normalize; G.cutoff = cutoff; G.env_p = env_p;
  G.r_on = r_on;
  return G;
}
#define GEOM_CALL                                                          \
  make_geom(coeffs, sh_idx, sh_coef, sh_off, n_terms, env_kind, normalize, \
            cutoff, env_p, r_on)

// the launch shape a layer gets (ops/fused_conv_geom.py holds the same
// arithmetic): T, s, nap, cq and the dynamic shared bytes
extern "C" int fused_conv_geom_shape(int bwd, PLAN_ARGS, int* out) {
  const Plan P = PLAN_CALL;
  const Shape S = geom_shape(P, bwd ? TB : TF, bwd != 0);
  out[0] = S.T; out[1] = S.s; out[2] = S.nap; out[3] = S.cq;
  out[4] = (int)(4 * (bwd ? bwd_words(P, S) : fwd_words(P, S)));
  return 0;
}

extern "C" int fused_conv_geom_fwd(const float* xg, const float* vec,
                                   const float* ms, const float* w0,
                                   const float* w1, const float* w2,
                                   const float* si2w, PLAN_ARGS, GEOM_ARGS,
                                   float* out, void* stream) {
  const Plan P = PLAN_CALL;
  const Geom G = GEOM_CALL;
  if (P.f > SHP) return (int)cudaErrorInvalidValue;
  const Shape S = geom_shape(P, TF, false);
  const size_t smem = 4 * fwd_words(P, S);
  cudaError_t err =
      reserve_smem(fused_conv_geom_fwd_kernel, smem, geom_fwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_geom_fwd_kernel, smem, P.n_atoms, &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_geom_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        xg, vec, ms, w0, w1, w2, si2w, P, G, S, out);
  }
  return (int)cudaGetLastError();
}

template <int NSH>
static int launch_geom_bwd(const float* g, const float* xg, const float* vec,
                           const float* ms, const float* w0, const float* w1,
                           const float* w1t, const float* w2,
                           const float* w2t, const float* si2wt,
                           const Plan& P, const Geom& G, float* dxg,
                           float* dvec, void* stream, size_t* reserved) {
  const Shape S = geom_shape(P, TB, true);
  const size_t smem = 4 * bwd_words(P, S);
  cudaError_t err =
      reserve_smem(fused_conv_geom_bwd_kernel<NSH>, smem, reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_geom_bwd_kernel<NSH>, smem, P.n_atoms,
                          &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_geom_bwd_kernel<NSH><<<grid, NT, smem, (cudaStream_t)stream>>>(
        g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P, G, S, dxg, dvec);
  }
  return (int)cudaGetLastError();
}

static size_t geom_bwd4_reserved[MAX_DEVICES],
    geom_bwd9_reserved[MAX_DEVICES];

extern "C" int fused_conv_geom_bwd(const float* g, const float* xg,
                                   const float* vec, const float* ms,
                                   const float* w0, const float* w1,
                                   const float* w1t, const float* w2,
                                   const float* w2t, const float* si2wt,
                                   PLAN_ARGS, GEOM_ARGS, float* dxg,
                                   float* dvec, void* stream) {
  const Plan P = PLAN_CALL;
  const Geom G = GEOM_CALL;
  if (P.f > SHP || P.n_xent >= MAX_XENT) return (int)cudaErrorInvalidValue;
  if (P.f <= 4)
    return launch_geom_bwd<4>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P,
                              G, dxg, dvec, stream, geom_bwd4_reserved);
  if (P.f <= 9)
    return launch_geom_bwd<9>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P,
                              G, dxg, dvec, stream, geom_bwd9_reserved);
  return launch_geom_bwd<16>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P,
                             G, dxg, dvec, stream, geom_bwd_reserved);
}
