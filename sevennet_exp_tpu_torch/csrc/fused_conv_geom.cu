// Convolution block on the dense neighbor grid, forward and force backward,
// for NVIDIA Hopper (sm_90a), fp32 on the CUDA cores: the geometry-fused
// pair and the dense pair, one template on MODE, and the edge pair, its
// third mode: the dense passes on the plain edge list (below the backward).
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_geom_fwd <- make_fused_conv(agg_d > 0, geom).fwd_kernel_geom
//                          (_geom_fm, _sh_rows_fm, _mlp_fm, _cm_fwd_core)
//   fused_conv_geom_bwd <- make_fused_conv(agg_d > 0, geom).bwd_kernel_geom
//                          (the same, _cm_bwd_core and the geometry VJP)
//   fused_conv_fwd      <- make_fused_conv(agg_d > 0).fwd_kernel_cm
//                          (_cm_fwd_core, _cg_acc_cm, _mlp_forward)
//   fused_conv_bwd      <- make_fused_conv(agg_d > 0).bwd_kernel_cm
//                          (_cm_bwd_core, _act_grad)
//   fused_conv_edge_fwd <- make_fused_conv(agg_d = 0).fwd_kernel_cm
//   fused_conv_edge_bwd <- make_fused_conv(agg_d = 0).bwd_kernel_cm
// With GEOM the kernels compute each row's emb and sh from its edge vector
// (below) and the backward returns dvec. Without it (the dense pair) they
// take the rows' sh (rows, f) and emb (rows, nb), staged into the same
// shared layout by 16-byte loads, and the backward writes the rows' dsh and
// demb with streaming stores, exact zeros where ms == 0; everything between
// is the same code. The dense pair needs every instruction's SH block at
// l2^2 and f <= 16, as the geometry does (ops/fused_conv.py checks).
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
// the backward spills. The dense instances hold the same bounds with less
// shared memory (no edge vectors); their staged rows and stores cost a few
// instructions a row where the geometry cost ~7 % of the kernels' time.
//
// The edge pair (agg_d = 0, the calculator's padded edge list): one output
// row per input row, y[e] = si2(msg[e]), the caller scatters the rows onto
// the atoms. si2 per row is ~107k multiply-adds in a mid layer, two thirds
// of the row's work, and its ~220 kB of weights fit no shared memory; the
// first design (a block owning 8 rows forward, 4 backward, each weight
// read from L2 for them by one load per multiply-add) ran it at ~10 and
// ~4 TFLOP/s. Both kernels run si2 group by group as a product over a
// tile's rows (row_product): a thread holds an 8-row by 4-column block of
// sums and reads the group's weights from L2 by 16-byte loads, each weight
// once a tile for the block.
//  - The forward (edge_fwd_tiles) fits its tile to two blocks an SM: up to
//    TEF = 16 rows, set by the widest group's columns and the largest
//    group's messages (T x dim3 K: 80 kB at a mid layer), which is all a
//    tile holds of the messages. Per tile it stages the rows and runs the
//    hidden layers once; then per si2 group the w pass over the group's
//    columns (a group's instructions, and so its columns, are consecutive),
//    the CG of those columns into the group's message tile in the plain
//    chain's layout, and the product with W, written as output rows.
//  - The backward walks tiles of TE = 8 rows with the dense pair's passes
//    (stage_rows, hidden_rm, w_rows, the class pass, passes D-F,
//    store_rows) and forms gm = alpha g W^T per row by the same product
//    before its class pass, which reads each row's own gm where the dense
//    pair keeps one per atom. The per-row cotangents (T x agg_dim words,
//    60 kB for 8 rows at a mid layer) are what holds it to 8 rows at two
//    blocks an SM; the rows' g sit in the words of the MLP's rows, which
//    are written after them.
// Tiles whose rows are all pads store zeros and skip the rest; sums run in
// a fixed order (no atomics: two launches give one result).

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
constexpr int TE = 8;       // edge backward: rows per tile
constexpr int TEF = 16;     // edge forward: rows per tile (at most)
constexpr int KS_MAX = 8;   // edge products: threads that share one block
constexpr int RB = 8;       // edge products: rows of a thread's block
// edge forward: shared words of one block, two an SM (228 KB, 1 KB of it
// reserved per block); the kernel fits its tile into them
constexpr int EDGE_FWD_WORDS = (233472 - 2 * 1024) / 2 / 4;

// the template's pairs: the dense pair (kernels 1-2), the geometry-fused
// pair (rows 5-6), the edge pair (kernels 1-2 at agg_d = 0)
constexpr int K_DENSE = 0, K_GEOM = 1, K_EDGE = 2;

// the activation of this build. The library fused_conv_geom takes the
// plan's act at run time (0 silu, 1 tanh); fused_conv_geom_ssp, the same
// source built with -DFUSED_CONV_SSP=1 (ops/cuda_build.py), runs the shifted
// softplus, the plan's code 2 (ops/fused_conv.py _ACT_CODE), and is built
// only when a layer with it first launches. Each build refuses the other's
// plans.
#ifndef FUSED_CONV_SSP
#define FUSED_CONV_SSP 0
#endif
// the external-weight backward (row 8) is a build of its own,
// fused_conv_geom_extw (-DFUSED_CONV_EXTW=1), compiling that kernel only
#ifndef FUSED_CONV_EXTW
#define FUSED_CONV_EXTW 0
#endif
constexpr bool SSP_BUILD = FUSED_CONV_SSP != 0;
constexpr int ACT_SSP = 2;

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

// per-row inputs and outputs of the dense pair, row-major: sh (rows, f),
// emb (rows, nb); the backward writes dsh and demb of the same shapes
struct Dense {
  const float* sh;
  const float* emb;
  float* dsh;
  float* demb;
};

// what a kernel takes for its rows' sh and emb: the geometry, or Dense
template <int MODE> struct RowArgs { using type = Dense; };
template <> struct RowArgs<K_GEOM> { using type = Geom; };

// the shifted softplus, ssp(x) = softplus(x) - ln 2, and its derivative
// sigmoid(x), from one exp (JAX pallas_conv's 'ssp'). logf(1 + e), not
// log1pf(e): within 6e-8 of it for e <= 1, and log1pf left the
// geometry-fused forward (80 registers) with a spill
__device__ __forceinline__ void ssp_both(float x, float* f, float* df) {
  const float e = expf(-fabsf(x));
  const float s = 1.f / (1.f + e);
  *f = fmaxf(x, 0.f) + logf(1.f + e) - 0.693147180559945309f;
  *df = x >= 0.f ? s : 1.f - s;
}

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

// the activation of this build: the plan's act, or the shifted softplus
__device__ __forceinline__ void act_pair(float x, int act, float* f,
                                         float* df) {
  if constexpr (SSP_BUILD) {
    ssp_both(x, f, df);
  } else {
    act_both(x, act, f, df);
  }
}

__device__ __forceinline__ float act_one(float x, int act) {
  if constexpr (SSP_BUILD) {
    float f, df;
    ssp_both(x, &f, &df);
    return f;
  } else {
    return act_f(x, act);
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

// put(i, src[i]) for i < n: 16-byte loads over the 16-byte aligned part of
// src, single floats before and after it
template <typename Put>
__device__ __forceinline__ void load_block(const float* __restrict__ src,
                                           int n, Put put) {
  const int head =
      min(n, (int)(((16 - (reinterpret_cast<size_t>(src) & 15)) & 15) >> 2));
  const int n4 = (n - head) >> 2;
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  for (int i = threadIdx.x; i < n4; i += NT) {
    const float4 v = __ldg(s4 + i);
    const int j = head + 4 * i;
    put(j, v.x); put(j + 1, v.y); put(j + 2, v.z); put(j + 3, v.w);
  }
  for (int i = threadIdx.x; i < head; i += NT) put(i, __ldg(src + i));
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += NT)
    put(i, __ldg(src + i));
}

// dst[i] = get(i) for i < n: 16-byte streaming stores over the aligned part
// of dst, single floats before and after it
template <typename Get>
__device__ __forceinline__ void store_block(float* __restrict__ dst, int n,
                                            Get get) {
  const int head =
      min(n, (int)(((16 - (reinterpret_cast<size_t>(dst) & 15)) & 15) >> 2));
  const int n4 = (n - head) >> 2;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < n4; i += NT) {
    const int j = head + 4 * i;
    __stcs(d4 + i, make_float4(get(j), get(j + 1), get(j + 2), get(j + 3)));
  }
  for (int i = threadIdx.x; i < head; i += NT) __stcs(dst + i, get(i));
  for (int i = head + 4 * n4 + threadIdx.x; i < n; i += NT)
    __stcs(dst + i, get(i));
}

// the dense pair's rows of a tile, in geom_rows' layout: emb row-minor
// (basis n of row e at n * T + e), sh at e * SHP with zeros past f. Not
// synced.
__device__ __forceinline__ void stage_rows(const Plan& P, const Dense& G,
                                           int T, int rows, long row0,
                                           float* embT_s, float* sh_s) {
  const int nb = P.nb, f = P.f, pad = SHP - P.f;
  load_block(G.emb + row0 * nb, rows * nb, [&](int i, float v) {
    const int e = i / nb;
    embT_s[(i - e * nb) * T + e] = v;
  });
  load_block(G.sh + row0 * f, rows * f, [&](int i, float v) {
    const int e = i / f;
    sh_s[e * SHP + i - e * f] = v;
  });
  for (int i = threadIdx.x; i < rows * pad; i += NT) {
    const int e = i / pad;
    sh_s[e * SHP + f + i - e * pad] = 0.f;
  }
}

// the dense backward's outputs of a tile: dsh rows from dsh_s (row e at
// e * SHP), demb rows from the row-minor dembT_s; rows with ms == 0 get
// zeros
__device__ __forceinline__ void store_rows(const Plan& P, const Dense& G,
                                           int T, int rows, long row0,
                                           const float* ms_s,
                                           const float* dembT_s,
                                           const float* dsh_s) {
  const int nb = P.nb, f = P.f;
  store_block(G.dsh + row0 * f, rows * f, [&](int i) {
    const int e = i / f;
    return ms_s[e] != 0.f ? dsh_s[e * SHP + i - e * f] : 0.f;
  });
  store_block(G.demb + row0 * nb, rows * nb, [&](int i) {
    const int e = i / nb;
    return ms_s[e] != 0.f ? dembT_s[(i - e * nb) * T + e] : 0.f;
  });
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
      act_pair(s, P.act, &f, &df);
      h0T_s[i] = f * P.act_cst;
      da0T_s[i] = df * P.act_cst;
    } else {
      h0T_s[i] = act_one(s, P.act) * P.act_cst;
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
        act_pair(a[i4], P.act, &o[i4], &d[i4]);
      } else {
        o[i4] = act_one(a[i4], P.act);
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
// the edge pair's per-row si2: products over a tile's rows
// ---------------------------------------------------------------------

// The per-row self-interaction of one si2 group over a tile of T rows:
//   put(e, p, j, v): v[t] = sum_k A[e ae + p ap + k] B[k][j + t]
// for rows e < T (a multiple of RB), components p < d3, columns j + t < n,
// k < kred. Forward: A the rows' messages of the group, B its W (K x mo);
// backward: A the rows' cotangents g, B the group's W^T (mo x K). A thread
// owns a block of RB (e, p) rows (one p, RB consecutive e) by 4 columns,
// so each weight it loads serves RB rows: A by shared-memory broadcasts,
// four k of a row in one 16-byte load, and B straight from global memory,
// 16 bytes a k, the next four k loaded while the FMAs of these run (the
// loads come from L2). Blocks of 4 rows ran the backward 6 % faster but
// left one register of its 16-SH instance in local memory; without the
// prefetch they ran it 10 % slower still. Plans
// whose offsets or widths are not multiples of 4 take a loop of single,
// guarded loads instead (the choice is uniform over the block and made
// outside the loop: one instance serves every plan); the k past the last
// multiple of 4 are a scalar tail. The block's threads read each weight
// from L2 once for the tile, the L1 serving the threads that share it:
// staging B in shared memory by cp.async, in chunks behind a barrier each,
// was slower (two stages or three).
// When the blocks are fewer than the threads, ks threads share one, each
// taking every ks-th group of 4 k (part 0 also the tail), and part 0 adds
// the others' sums in order from red (no atomics: one result; red holds
// red_words). Starts after a sync of A; ends synchronised, red free.
template <typename Put>
__device__ __forceinline__ void row_product(int T, const float* A, int ae,
                                            int ap, int d3,
                                            const float* __restrict__ B,
                                            int kred, int n, float* red,
                                            int red_words, Put put) {
  const int tid = threadIdx.x;
  const bool fast =
      ((ae | ap | n) & 3) == 0
      && ((reinterpret_cast<size_t>(A) | reinterpret_cast<size_t>(B)) & 15)
             == 0;
  const int nq = (n + 3) / 4, k4 = kred & ~3;
  const int items = (T * d3 / RB) * nq;
  const int ks = items >= NT ? 1
                             : min(min(NT / items, KS_MAX),
                                   1 + red_words / (4 * RB * items));
  for (int base = 0; base < items; base += NT) {
    const int item = items >= NT ? base + tid : tid % items;
    const int part = items >= NT ? 0 : tid / items;
    const bool on = item < items && part < ks;
    const int rq = on ? item / nq : 0, jq = on ? item - rq * nq : 0;
    const int p = (RB * rq) / T, e0 = RB * rq - p * T;
    const float* a = A + (long)e0 * ae + p * ap;
    const float* b = B + 4 * jq;
    float acc[RB][4];
#pragma unroll
    for (int e = 0; e < RB; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[e][t] = 0.f;
    // B[k][4 jq .. 4 jq + 3] by single loads, zeros past n
    auto b_at = [&](int k) {
      const float* r = b + (long)k * n;
      const int m = n - 4 * jq;
      return make_float4(__ldg(r), m > 1 ? __ldg(r + 1) : 0.f,
                         m > 2 ? __ldg(r + 2) : 0.f,
                         m > 3 ? __ldg(r + 3) : 0.f);
    };
    auto fma_row = [](float (&c)[4], float x, const float4& w) {
      c[0] = fmaf(x, w.x, c[0]);
      c[1] = fmaf(x, w.y, c[1]);
      c[2] = fmaf(x, w.z, c[2]);
      c[3] = fmaf(x, w.w, c[3]);
    };
    if (on) {
      if (fast) {
        int k = 4 * part;
        float4 bn[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          bn[kk] = k < k4 ? __ldg(reinterpret_cast<const float4*>(
                                b + (long)(k + kk) * n))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1
        for (; k < k4; k += 4 * ks) {
          float4 bk[4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) bk[kk] = bn[kk];
          if (k + 4 * ks < k4)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              bn[kk] = __ldg(reinterpret_cast<const float4*>(
                  b + (long)(k + 4 * ks + kk) * n));
#pragma unroll
          for (int e = 0; e < RB; ++e) {
            const float4 av =
                *reinterpret_cast<const float4*>(a + e * ae + k);
            fma_row(acc[e], av.x, bk[0]);
            fma_row(acc[e], av.y, bk[1]);
            fma_row(acc[e], av.z, bk[2]);
            fma_row(acc[e], av.w, bk[3]);
          }
        }
      } else {
#pragma unroll 1
        for (int k = 4 * part; k < k4; k += 4 * ks)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 w = b_at(k + kk);
#pragma unroll
            for (int e = 0; e < RB; ++e)
              fma_row(acc[e], a[e * ae + k + kk], w);
          }
      }
      if (part == 0)
        for (int k = k4; k < kred; ++k) {
          const float4 w = b_at(k);
#pragma unroll
          for (int e = 0; e < RB; ++e) fma_row(acc[e], a[e * ae + k], w);
        }
    }
    if (ks > 1) {
      if (on && part > 0)
#pragma unroll
        for (int e = 0; e < RB; ++e)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            red[((part - 1) * items + item) * (4 * RB) + 4 * e + t] =
                acc[e][t];
      __syncthreads();
      if (on && part == 0)
        for (int q = 1; q < ks; ++q)
#pragma unroll
          for (int e = 0; e < RB; ++e)
#pragma unroll
            for (int t = 0; t < 4; ++t)
              acc[e][t] +=
                  red[((q - 1) * items + item) * (4 * RB) + 4 * e + t];
    }
    if (on && part == 0)
#pragma unroll
      for (int e = 0; e < RB; ++e) put(e0 + e, p, 4 * jq, acc[e]);
    __syncthreads();
  }
}

// si2 group g's live columns [*c0, *c0 + *nc): ops/fused_conv.py lists the
// instructions group by group, so a group's columns are consecutive
__device__ __forceinline__ void group_columns(const Plan& P,
                                              const int* ins_s, int g,
                                              int* c0, int* nc) {
  const int* Gr = P.grp + g * G_STRIDE;
  const int a0 = Gr[G_AGG], a1 = a0 + Gr[G_DIM3] * Gr[G_K];
  int lo = P.n_active, hi = 0;
  for (int i = 0; i < P.n_ins; ++i) {
    const int* I = ins_s + i * I_STRIDE;
    if (I[I_AGG] >= a0 && I[I_AGG] < a1) {
      lo = min(lo, I[I_COL0]);
      hi = max(hi, I[I_COL0] + I[I_MUL]);
    }
  }
  *c0 = lo;
  *nc = max(hi - lo, 0);
}

// the output columns that no si2 group writes (zeros in every row): their
// count at unc_s[0], the columns after it. Not synced.
__device__ __forceinline__ void unwritten_columns(const Plan& P, int* unc_s) {
  if (threadIdx.x != 0) return;
  int nu = 0;
  for (int j = 0; j < P.d_out; ++j) {
    bool hit = false;
    for (int g = 0; g < P.n_grp && !hit; ++g) {
      const int* Gr = P.grp + g * G_STRIDE;
      hit = j >= Gr[G_OUT] && j < Gr[G_OUT] + Gr[G_DIM3] * Gr[G_MO];
    }
    if (!hit) unc_s[1 + nu++] = j;
  }
  unc_s[0] = nu;
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

// the edge forward's CG of one live column of an si2 group over rows
// [e0, e1) of a tile: one message a row, row e at msg + e * as in the
// group's slice of the plain chain's layout (msg at the instruction's
// offset in the slice; every slot of a row is some column's, so nothing is
// zeroed first); w_s holds the group's columns (lc the column's place
// there); pad rows (w = 0) get zeros and load nothing
template <int L1, int L2, int L3>
__device__ __forceinline__ void fwd_cg_rows(const Plan& P, const int* I,
                                            int u, int lc, float sc,
                                            const float* __restrict__ xr,
                                            const float* sh_s,
                                            const float* w_s, int nap,
                                            int e0, int e1, float* msg,
                                            int as) {
  constexpr int D1 = 2 * L1 + 1, D2 = 2 * L2 + 1, D3 = 2 * L3 + 1;
  const int mul = I[I_MUL], K = I[I_K];
  const float* xb = xr + I[I_XOFF] + u;
  const float* sb = sh_s + L2 * L2;
  float* mb = msg + u;
#pragma unroll 2
  for (int e = e0; e < e1; ++e) {
    const float w = w_s[e * nap + lc];
    float s[D3];
#pragma unroll
    for (int p = 0; p < D3; ++p) s[p] = 0.f;
    if (w != 0.f) {
      float xv[D1], sv[D2];
#pragma unroll
      for (int m = 0; m < D1; ++m) xv[m] = __ldg(xb + e * P.d1 + m * mul);
#pragma unroll
      for (int n = 0; n < D2; ++n) sv[n] = sb[e * SHP + n];
      CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
        s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                     sv[decltype(n)::value],
                                     s[decltype(p)::value]);
      });
    }
#pragma unroll
    for (int p = 0; p < D3; ++p) mb[e * as + p * K] = w * s[p] * sc;
  }
}

// the edge forward's tile rows: the most, a multiple of RB up to TEF, whose
// words fit EDGE_FWD_WORDS next to `fixed` words: per row its sh, emb, ms
// and h1, the widest group's w (nc4 columns) and the larger of h0 and the
// largest group's messages (slice4 words); 0 when not even RB rows fit
__host__ __device__ inline int edge_fwd_rows(int fixed, int nb, int nc4,
                                             int slice4) {
  const int msg = slice4 > H ? slice4 : H;
  const int per_row = SHP + nb + 1 + H + nc4 + msg;
  for (int T = TEF; T >= RB; T -= RB)
    if (fixed + T * per_row <= EDGE_FWD_WORDS) return T;
  return 0;
}

// n floats from src into L2, a 128-byte line a thread
__device__ __forceinline__ void prefetch_rows(const float* src, int n) {
  const char* p = reinterpret_cast<const char*>(src);
  const long lines = ((long)n * 4 + 127) / 128;
  for (long i = threadIdx.x; i < lines; i += NT)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + 128 * i));
}

// row groups of a w pass over nc columns of T rows: geom_shape's rule
__device__ __forceinline__ int w_row_groups(int nc, int T) {
  int best = -1, s_best = 1;
  for (int s = 1; s <= 4; s *= 2) {
    if (T % (4 * s)) break;
    const int cost = ((nc * s + NT - 1) / NT) * (T / s + 4);
    if (best < 0 || cost < best) { best = cost; s_best = s; }
  }
  return s_best;
}

// The edge forward (K_EDGE), after the tables: tiles of T rows of the edge
// list, walked persistently; per tile the staged rows and the hidden layers
// once, then per si2 group its w pass, its CG into the group's message
// tile (T x dim3 K) and the product with its W, written as output rows.
// Tiles whose rows are all pads store zeros and skip the rest.
__device__ void edge_fwd_tiles(const Plan& P, const Dense& G,
                               const float* __restrict__ xg,
                               const float* __restrict__ ms,
                               const float* __restrict__ w0,
                               const float* __restrict__ w1,
                               const float* __restrict__ w2,
                               const float* __restrict__ si2w,
                               const int* ins_s, const float* sc_s,
                               float* smem, float* next_s,
                               float* __restrict__ out) {
  auto r4 = [](int n) { return (n + 3) & ~3; };
  auto take = [&next_s](int n) {
    float* q = next_s; next_s += (n + 3) & ~3; return q;
  };
  int nc4 = 0, slice4 = 0;
  for (int g = 0; g < P.n_grp; ++g) {
    const int* Gr = P.grp + g * G_STRIDE;
    int c0, nc;
    group_columns(P, ins_s, g, &c0, &nc);
    nc4 = max(nc4, r4(nc));
    slice4 = max(slice4, r4(Gr[G_DIM3] * Gr[G_K]));
  }
  int* unc_s = reinterpret_cast<int*>(take(P.d_out + 1));
  const int T = edge_fwd_rows((int)(next_s - smem), P.nb, nc4, slice4);
  float* sh_s = take(T * SHP);
  float* embT_s = take(T * P.nb);
  float* ms_s = take(T);
  float* h1T_s = take(T * H);
  float* w_s = take(T * nc4);             // the group's w, then its sums
  float* msg_s = take(T * max(H, slice4));   // h0, then the messages
  const int tid = threadIdx.x;
  unwritten_columns(P, unc_s);
  const bool vec_out = (P.d_out & 3) == 0
                       && (reinterpret_cast<size_t>(out) & 15) == 0;
  const long n_tiles = T ? (P.n_rows + T - 1) / T : 0;
  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long row0 = tile * T;
    const int rows = (int)min((long)T, P.n_rows - row0);
    __syncthreads();
    for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
    // the x rows of this tile (the first) and of the block's next one into
    // L2: the CG reads them once a group, the first time from HBM
    for (long t = tile == blockIdx.x ? tile : tile + gridDim.x;
         t <= tile + gridDim.x && t < n_tiles; t += gridDim.x)
      prefetch_rows(xg + t * T * P.d1,
                    (int)min((long)T, P.n_rows - t * T) * P.d1);
    // a tile of pads only: zero rows, nothing else
    if (!__syncthreads_or(tid < rows && ms_s[tid] != 0.f)) {
      store_block(out + row0 * P.d_out, rows * P.d_out,
                  [](int) { return 0.f; });
      continue;
    }
    stage_rows(P, G, T, rows, row0, embT_s, sh_s);
    __syncthreads();
    hidden_rm(P, T, embT_s, w0, w1, msg_s, h1T_s, nullptr, nullptr);
    // columns no group writes: zeros
    const int nu = unc_s[0];
    for (int i = tid; i < rows * nu; i += NT) {
      const int e = i / nu;
      __stcs(out + (row0 + e) * P.d_out + unc_s[1 + i - e * nu], 0.f);
    }
    const float* xr = xg + row0 * P.d1;
    for (int g = 0; g < P.n_grp; ++g) {
      const int* Gr = P.grp + g * G_STRIDE;
      const int K = Gr[G_K], mo = Gr[G_MO], d3 = Gr[G_DIM3];
      const int a0 = Gr[G_AGG], o_off = Gr[G_OUT], as = r4(d3 * K);
      const float alpha = P.grp_alpha[g];
      int c0, nc;
      group_columns(P, ins_s, g, &c0, &nc);
      // the w pass over the group's columns: a plan whose live columns
      // are the group's
      Plan Pg = P;
      Pg.n_active = nc;
      Pg.col_w = P.col_w + c0;
      Shape Sg;
      Sg.T = T;
      Sg.s = w_row_groups(nc, T);
      Sg.nap = nc4;
      Sg.cq = 0;
      w_rows(Pg, Sg, rows, h1T_s, ms_s, w2, w_s);
      __syncthreads();
      // the CG, (column, part of the rows) items
      int sp = 1;
      while (sp < 4 && nc * sp * 2 <= NT) sp *= 2;
      const int R = T / sp;
      for (int j = tid; j < nc * sp; j += NT) {
        const int lc = j % nc, q = j / nc;
        const int e0 = q * R, e1 = min(e0 + R, rows);
        if (e0 >= e1) continue;
        const int ii = __ldg(P.col_ins + c0 + lc);
        const int* I = ins_s + ii * I_STRIDE;
        const int u = c0 + lc - I[I_COL0];
        float* msg = msg_s + (I[I_AGG] - a0);
        switch (shape_key(I)) {
#define EDGE_FWD_CASE(A, B, C)                                              \
          case A * 16 + B * 4 + C:                                          \
            fwd_cg_rows<A, B, C>(P, I, u, lc, sc_s[ii], xr, sh_s, w_s, nc4, \
                                 e0, e1, msg, as);                          \
            break;
          CG_SHAPES(EDGE_FWD_CASE)
#undef EDGE_FWD_CASE
        }
      }
      __syncthreads();
      const bool v4 = vec_out && (mo & 3) == 0 && (o_off & 3) == 0;
      row_product(
          T, msg_s, as, K, d3, si2w + Gr[G_WOFF], K, mo, w_s, T * nc4,
          [&](int e, int p, int j, const float (&v)[4]) {
            if (e >= rows) return;
            float* o = out + (row0 + e) * P.d_out + o_off + p * mo + j;
            if (v4) {
              __stcs(reinterpret_cast<float4*>(o),
                     make_float4(v[0] * alpha, v[1] * alpha, v[2] * alpha,
                                 v[3] * alpha));
            } else {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (j + t < mo) __stcs(o + t, v[t] * alpha);
            }
          });
    }
  }
}

// MODE K_EDGE: edge_fwd_tiles after the tables
template <int MODE>
__global__ void __launch_bounds__(NT, MODE == K_EDGE ? 2 : 3)
fused_conv_geom_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ vec,
                           const float* __restrict__ ms,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2,
                           const float* __restrict__ si2w, Plan P,
                           typename RowArgs<MODE>::type G, Shape S,
                           float* __restrict__ out) {
  constexpr bool GEOM = MODE == K_GEOM;
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
  // one expression: a nullptr assigned under `if constexpr` renumbered PTX
  // registers and moved the GEOM backward's SASS
  float* vec_s = GEOM ? take(T * 3) : nullptr;
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
  if constexpr (MODE == K_EDGE) {
    edge_fwd_tiles(P, G, xg, ms, w0, w1, w2, si2w, ins_s, sc_s, smem,
                   sc_s + ((P.n_ins + 3) & ~3), out);
    return;
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
      if constexpr (GEOM)
        for (int i = tid; i < rows * 3; i += NT) vec_s[i] = vec[row0 * 3 + i];
      for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      if constexpr (GEOM) {
        __syncthreads();
        geom_rows(P, G, T, rows, vec_s, embT_s, sh_s);
      } else {
        stage_rows(P, G, T, rows, row0, embT_s, sh_s);
      }
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
// sh and dsh arrays. MODE K_EDGE: tiles of TE rows of the edge list in
// place of an atom's D rows, and gm = alpha g W^T per row (the products over
// the tile's rows, in the words that w / dw and the MLP's rows take after
// them) in place of once per atom; the class pass reads each row's own gm
template <int NSH, int MODE>
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
                           const float* __restrict__ si2wt, Plan P,
                           typename RowArgs<MODE>::type G, Shape S,
                           float* __restrict__ dxg,
                           float* __restrict__ dvec) {
  constexpr bool GEOM = MODE == K_GEOM, EDGE = MODE == K_EDGE;
  constexpr int TR = EDGE ? TE : TB;   // rows pass D computes
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
  float* g_s = take(EDGE ? 0 : P.d_out);
  float* gm_s = take(EDGE ? T * P.agg_dim : P.agg_dim);   // si2^T g
  // w, then dw, per row. EDGE: from here to the pass-D partials first the
  // rows' g, then the products' partial sums
  float* wdw_s = take(EDGE ? max(TE * S.nap + SLAB,
                                 T * ((P.d_out + 3) & ~3)
                                     - (4 + QD) * T * H - NW * T * SHP)
                           : TB * S.nap + SLAB);
  float* h0T_s = take(T * H);                      // then dpre0
  float* h1T_s = take(T * H);                      // then dpre1
  float* da0T_s = take(T * H);
  float* da1T_s = take(T * H);
  float* red_s = take(QD * T * H);                 // pass D partials
  float* dshp_s = take(NW * T * SHP);              // dsh partials per warp
  float* dsh_s = take(T * SHP);
  float* sh_s = take(T * SHP);
  float* embT_s = take(T * P.nb);                  // then demb
  float* vec_s = GEOM ? take(T * 3) : nullptr;
  float* ms_s = take(T);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_tables(P, ins_s, nzi_s, nzc_s);
  // w / dw rows start as zeros: pass D reads its 16-byte groups past a
  // quarter's last column (times a zero weight) and all TR rows
  for (int i = tid; i < TR * S.nap + SLAB; i += NT) wdw_s[i] = 0.f;
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
    if constexpr (EDGE) {
      // the tile's rows: pads only -> zero rows; else gm per row
      const long row0 = (long)atom * T;
      const int rows = (int)min((long)T, P.n_rows - row0);
      for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      if (!__syncthreads_or(tid < rows && ms_s[tid] != 0.f)) {
        auto zero = [](int) { return 0.f; };
        store_block(dxg + row0 * P.d1, rows * P.d1, zero);
        store_block(G.dsh + row0 * P.f, rows * P.f, zero);
        store_block(G.demb + row0 * P.nb, rows * P.nb, zero);
        continue;
      }
      const int ds = (P.d_out + 3) & ~3;
      float* gt_s = wdw_s;                         // the rows' g
      load_block(gout + row0 * P.d_out, rows * P.d_out, [&](int i, float v) {
        const int e = i / P.d_out;
        gt_s[e * ds + i - e * P.d_out] = v;
      });
      for (int i = rows * ds + tid; i < T * ds; i += NT) gt_s[i] = 0.f;
      __syncthreads();
      for (int g = 0; g < P.n_grp; ++g) {
        const int* Gr = P.grp + g * G_STRIDE;
        const int K = Gr[G_K], mo = Gr[G_MO];
        float* gm = gm_s + Gr[G_AGG];
        const float alpha = P.grp_alpha[g];
        row_product(
            T, gt_s + Gr[G_OUT], ds, mo, Gr[G_DIM3], si2wt + Gr[G_WOFF], mo, K,
            gt_s + T * ds,
            (int)(dshp_s + NW * T * SHP - (gt_s + T * ds)),
            [&](int e, int p, int j, const float (&v)[4]) {
#pragma unroll
              for (int t = 0; t < 4; ++t)
                if (j + t < K) gm[e * P.agg_dim + p * K + j + t] = v[t] * alpha;
            });
      }
      // w / dw rows start as zeros (see above)
      for (int i = tid; i < TE * S.nap + SLAB; i += NT) wdw_s[i] = 0.f;
    }
    if constexpr (!EDGE) {
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
    }

    for (int t0 = 0; t0 < P.D; t0 += T) {
      const long row0 = (long)atom * P.D + t0;
      const int rows = EDGE ? (int)min((long)T, P.n_rows - row0)
                            : min(T, P.D - t0);
      __syncthreads();
      if constexpr (GEOM)
        for (int i = tid; i < rows * 3; i += NT) vec_s[i] = vec[row0 * 3 + i];
      for (int i = tid; i < T; i += NT) ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      for (int i = tid; i < NW * T * SHP; i += NT) dshp_s[i] = 0.f;
      if constexpr (GEOM) {
        __syncthreads();
        geom_rows(P, G, T, rows, vec_s, embT_s, sh_s);
      } else {
        stage_rows(P, G, T, rows, row0, embT_s, sh_s);
      }
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
              bwd_class_item<NSH, l>(P, X, ins_s, sc_s,                    \
                                     gm_s + (EDGE ? e * P.agg_dim : 0),    \
                                     xg, dxg, row, m_e, sv, wdw_row,       \
                                     lane_u, C.uit, dsh);                  \
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
        float acc[TR];
#pragma unroll
        for (int e = 0; e < TR; ++e) acc[e] = 0.f;
        for (int c0 = c_lo; c0 < c_hi; c0 += SLAB) {
          float wr[SLAB];
#pragma unroll
          for (int i = 0; i < SLAB; ++i)
            wr[i] = c0 + i < c_hi
                        ? __ldg(w2t + (long)__ldg(P.col_w + c0 + i) * H + k)
                        : 0.f;
          // all TR rows (those past the tile's read finite stale rows and
          // are not stored): the 16 sums interleave
#pragma unroll
          for (int i = 0; i < SLAB / 4; ++i) {
#pragma unroll
            for (int e = 0; e < TR; ++e) {
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
        for (int e = 0; e < TR; ++e)
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
      if constexpr (GEOM)
        geom_vjp(P, G, T, rows, row0, vec_s, ms_s, embT_s, dsh_s, dvec);
      else
        store_rows(P, G, T, rows, row0, ms_s, embT_s, dsh_s);
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

// shared words of one block; geom: the edge vectors' T * 3 words too
size_t fwd_words(const Plan& P, const Shape& S, bool geom) {
  auto r4 = [](size_t n) { return (n + 3) & ~(size_t)3; };
  const size_t T = S.T;
  return (size_t)table_words(P) + r4(P.n_ins) + r4(T * SHP)
         + r4(T * P.nb) + (geom ? r4(T * 3) : 0) + r4(T) + 2 * r4(T * H)
         + r4(T * S.nap) + r4((size_t)S.s * P.agg_dim) + r4(P.d_out);
}

size_t bwd_words(const Plan& P, const Shape& S, bool geom) {
  auto r4 = [](size_t n) { return (n + 3) & ~(size_t)3; };
  const size_t T = S.T;
  return (size_t)table_words(P) + r4(P.n_ins) + r4(MAX_XENT * 5)
         + r4(P.d_out) + r4(P.agg_dim) + r4(TB * S.nap + SLAB) + 4 * r4(T * H)
         + r4(QD * T * H) + r4(NW * T * SHP) + 2 * r4(T * SHP)
         + r4(T * P.nb) + (geom ? r4(T * 3) : 0) + r4(T);
}

// the edge pair's shared words: forward EDGE_FWD_WORDS, into which the
// kernel fits its tile (edge_fwd_rows); backward (T = TE) the dense layout
// with one message cotangent per row, w / dw wide enough that with the
// MLP's rows after it the words hold the tile's g rows
size_t edge_words(const Plan& P, const Shape& S, bool bwd) {
  if (!bwd) return EDGE_FWD_WORDS;
  auto r4 = [](long n) { return (n + 3) & ~3L; };
  const long T = S.T;
  const long head = table_words(P) + r4(P.n_ins) + r4(T * P.agg_dim)
                    + r4(T * SHP) + r4(T * P.nb) + r4(T);
  const long mlp = (4L + QD) * T * H + NW * T * SHP;
  const long wdw = TE * S.nap + SLAB > T * r4(P.d_out) - mlp
                       ? TE * S.nap + SLAB
                       : T * r4(P.d_out) - mlp;
  return head + r4(MAX_XENT * 5) + r4(T * SHP) + r4(wdw) + mlp;
}

// the dynamic shared words of one block of a mode's kernel
size_t words(const Plan& P, const Shape& S, bool bwd, int mode) {
  if (mode == K_EDGE) return edge_words(P, S, bwd);
  return bwd ? bwd_words(P, S, mode == K_GEOM)
             : fwd_words(P, S, mode == K_GEOM);
}

// shared memory of one block when two fit on an SM (228 KB, 1 KB of it
// reserved per block)
constexpr size_t TWO_PER_SM = (233472 - 2 * 1024) / 2;

// rows per tile and row groups per column: the groups (1, 2 or 4, each a
// multiple of 4 rows) that take the fewest rounds of the block's threads,
// a w2 column load counted as 4 rows of work, within two blocks an SM
Shape geom_shape(const Plan& P, bool bwd, int mode) {
  Shape S;
  S.T = mode == K_EDGE ? (bwd ? TE : TEF)
                       : tile_rows(P.D, bwd ? TB : TF);
  S.nap = (P.n_active + 3) & ~3;
  S.cq = ((P.n_active + QD - 1) / QD + 3) & ~3;
  S.s = 1;
  // the edge forward picks its row groups per si2 group (w_row_groups)
  if (mode == K_EDGE && !bwd) return S;
  long best = -1;
  for (int s = 1; s <= 4; s *= 2) {
    if (S.T % (4 * s)) break;
    Shape t = S;
    t.s = s;
    if (s > 1 && 4 * words(P, t, bwd, mode) > TWO_PER_SM) break;
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

// the dynamic shared bytes each kernel instance was last given, per device
template <bool BWD, int NSH, int MODE>
struct Reserved { static size_t bytes[MAX_DEVICES]; };
template <bool BWD, int NSH, int MODE>
size_t Reserved<BWD, NSH, MODE>::bytes[MAX_DEVICES];

// registers, local bytes a thread, blocks an SM and dynamic shared bytes
// of one kernel instance at `smem`
template <typename Kernel>
int resources(Kernel kernel, size_t smem, size_t* reserved, int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = reserve_smem(kernel, smem, reserved);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs; out[1] = (int)a.localSizeBytes; out[2] = per_sm;
  out[3] = (int)smem;
  return 0;
}

template <int MODE>
int launch_fwd(const float* xg, const float* vec, const float* ms,
               const float* w0, const float* w1, const float* w2,
               const float* si2w, const Plan& P,
               const typename RowArgs<MODE>::type& G, float* out,
               void* stream) {
  if (P.f > SHP || (P.act == ACT_SSP) != SSP_BUILD)
    return (int)cudaErrorInvalidValue;
  const Shape S = geom_shape(P, false, MODE);
  const size_t smem = 4 * words(P, S, false, MODE);
  cudaError_t err = reserve_smem(fused_conv_geom_fwd_kernel<MODE>, smem,
                                 Reserved<false, 0, MODE>::bytes);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_geom_fwd_kernel<MODE>, smem, P.n_atoms,
                          &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_geom_fwd_kernel<MODE>
        <<<grid, NT, smem, (cudaStream_t)stream>>>(xg, vec, ms, w0, w1, w2,
                                                   si2w, P, G, S, out);
  }
  return (int)cudaGetLastError();
}

template <int NSH, int MODE>
int launch_bwd(const float* g, const float* xg, const float* vec,
               const float* ms, const float* w0, const float* w1,
               const float* w1t, const float* w2, const float* w2t,
               const float* si2wt, const Plan& P,
               const typename RowArgs<MODE>::type& G, float* dxg,
               float* dvec, void* stream) {
  const Shape S = geom_shape(P, true, MODE);
  const size_t smem = 4 * words(P, S, true, MODE);
  cudaError_t err = reserve_smem(fused_conv_geom_bwd_kernel<NSH, MODE>, smem,
                                 Reserved<true, NSH, MODE>::bytes);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_geom_bwd_kernel<NSH, MODE>, smem,
                          P.n_atoms, &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_geom_bwd_kernel<NSH, MODE>
        <<<grid, NT, smem, (cudaStream_t)stream>>>(
            g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P, G, S, dxg, dvec);
  }
  return (int)cudaGetLastError();
}

// the backward instance for the filter's SH count
template <int MODE>
int launch_bwd_nsh(const float* g, const float* xg, const float* vec,
                   const float* ms, const float* w0, const float* w1,
                   const float* w1t, const float* w2, const float* w2t,
                   const float* si2wt, const Plan& P,
                   const typename RowArgs<MODE>::type& G, float* dxg,
                   float* dvec, void* stream) {
  if (P.f > SHP || P.n_xent >= MAX_XENT || (P.act == ACT_SSP) != SSP_BUILD)
    return (int)cudaErrorInvalidValue;
  if (P.f <= 4)
    return launch_bwd<4, MODE>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt,
                               P, G, dxg, dvec, stream);
  if (P.f <= 9)
    return launch_bwd<9, MODE>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt,
                               P, G, dxg, dvec, stream);
  return launch_bwd<16, MODE>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P,
                              G, dxg, dvec, stream);
}

template <int MODE>
int resources_of(const Plan& P, bool bwd, int* out) {
  if (P.f > SHP || (P.act == ACT_SSP) != SSP_BUILD)
    return (int)cudaErrorInvalidValue;
  const Shape S = geom_shape(P, bwd, MODE);
  const size_t smem = 4 * words(P, S, bwd, MODE);
  if (!bwd)
    return resources(fused_conv_geom_fwd_kernel<MODE>, smem,
                     Reserved<false, 0, MODE>::bytes, out);
  if (P.f <= 4)
    return resources(fused_conv_geom_bwd_kernel<4, MODE>, smem,
                     Reserved<true, 4, MODE>::bytes, out);
  if (P.f <= 9)
    return resources(fused_conv_geom_bwd_kernel<9, MODE>, smem,
                     Reserved<true, 9, MODE>::bytes, out);
  return resources(fused_conv_geom_bwd_kernel<16, MODE>, smem,
                   Reserved<true, 16, MODE>::bytes, out);
}

#if FUSED_CONV_EXTW
// ---------------------------------------------------------------------
// the external-weight backward (fused_conv_extw_bwd, row 8)
// ---------------------------------------------------------------------
//
// Replaces make_fused_conv(agg_d > 0, ext_w).bwd_kernel_cm_w
// (sevennet_exp_tpu/ops/pallas_conv.py, _cm_bwd_core): from the node
// cotangent g, the rows' xg, sh and weights weff (already scaled by the
// mask), dxg, dsh and dweff; no MLP. Built only in the library
// fused_conv_geom_extw (-DFUSED_CONV_EXTW=1, ops/cuda_build.py), which
// compiles nothing else of this file, so the 12 instances of the default
// build keep their code.
//
// What bounds it on this card: bytes. A mid layer reads ~4.3 kB a row (xg,
// sh, 576 live weights) and writes as much (dxg, dsh, dweff) for ~13k
// multiply-adds: ~1.5 flop/byte, far under the fp32 ridge. Its first design
// (fused_conv_body.cuh, bwd_body<M_EXTW>) ran at ~8 % of that bound: three
// table-driven CG passes per 8-row tile (dweff, dxg scanning every x entry
// per column, dsh), two table and two operand loads per multiply-add, one
// block per atom and a scattered store of every dead weight column.
// What this design does:
//  - The CG is the class pass of the backward above (bwd_class_item: per
//    (x entry, row, channel) every live instruction that reads the entry,
//    unrolled per (l1, l2, l3) from cg_patterns.cuh, operands in registers,
//    dsh summed over the warp by the butterfly), one pass for all three
//    cotangents; w comes from weff and dw goes back to dweff.
//  - weff and dweff move as whole rows: the tile's rows are one contiguous
//    block, read by 16-byte loads (four in flight a thread) into the live
//    columns' slots (a per-block map from weight column to live column)
//    and written back by 16-byte streaming stores, dead columns as zeros;
//    dsh rows the same way.
//  - Tiles of up to 32 rows (a whole atom at D = 32, two blocks an SM), a
//    persistent grid, and gm = alpha W^T g once an atom with one 16-byte
//    load of W^T per 4 multiply-adds.
// A row whose live weights are all zero is a pad: its dxg, dsh and dweff
// rows are exact zeros. Sums run in a fixed order (no atomics).

constexpr int TX = 32;       // rows per tile at most
constexpr int OX = 32;       // per-atom W^T g: o a lane, about

// shared words of one block at T rows (the C entry holds the caller's
// number against it)
__host__ __device__ inline int extw_words(const Plan& P, int T) {
  auto r4 = [](int n) { return (n + 3) & ~3; };
  const int nap = r4(P.n_active);
  return table_words(P) + r4(P.n_ins) + r4((P.n_xent + 1) * 5) + r4(P.wn)
         + r4(P.d_out) + r4(P.agg_dim) + T * nap + NW * T * SHP + T * SHP
         + r4(T);
}

template <int NSH>
__global__ void __launch_bounds__(NT, 2)
fused_conv_extw_bwd_kernel(const float* __restrict__ gout,
                           const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ weff,
                           const float* __restrict__ si2wt, Plan P, int T,
                           float* __restrict__ dxg, float* __restrict__ dsh,
                           float* __restrict__ dweff) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  auto r4 = [](int n) { return (n + 3) & ~3; };
  int* ins_s = reinterpret_cast<int*>(smem);
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) {
    float* q = next_s; next_s += n; return q;
  };
  const int nap = r4(P.n_active);
  float* sc_s = take(r4(P.n_ins));
  XClass* cls_s = reinterpret_cast<XClass*>(take(r4((P.n_xent + 1) * 5)));
  int* wc_s = reinterpret_cast<int*>(take(r4(P.wn)));  // weight -> live col
  float* g_s = take(r4(P.d_out));
  float* gm_s = take(r4(P.agg_dim));
  float* w_s = take(T * nap);                          // w, then dw
  float* dshp_s = take(NW * T * SHP);                  // dsh per warp
  float* sh_s = take(T * SHP);
  float* ms_s = take(r4(T));                           // 1: a live row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_tables(P, ins_s, nzi_s, nzc_s);
  for (int i = tid; i < P.wn; i += NT) wc_s[i] = -1;
  __syncthreads();
  for (int c = tid; c < P.n_active; c += NT) wc_s[__ldg(P.col_w + c)] = c;
  for (int i = tid; i < P.n_ins; i += NT) {
    const int* I = ins_s + i * I_STRIDE;
    float sc = 0.f;
    switch (shape_key(I)) {
#define EXTW_SCALE_CASE(a, b, c) \
      case a * 16 + b * 4 + c: sc = pattern_scale<a, b, c>(I, nzc_s); break;
      CG_SHAPES(EXTW_SCALE_CASE)
#undef EXTW_SCALE_CASE
    }
    sc_s[i] = sc;
  }
  // the i1 classes (x entries): item ranges for T rows, each padded to a
  // warp, every x entry (a thread writes its dxg columns)
  if (tid == 0) {
    int n_items = 0;
    for (int xe = 0; xe < P.n_xent; ++xe) {
      const int* X = P.xent + xe * X_STRIDE;
      const int mul = X[X_MUL];
      XClass C;
      C.lanes = mul % 32 == 0 ? 32 : mul;
      C.uit = mul % 32 == 0 ? mul / 32 : 1;
      C.start = n_items;
      C.xe = xe;
      C.l1 = (X[X_DIM] - 1) / 2;
      cls_s[xe] = C;
      n_items += (T * C.lanes + 31) & ~31;
    }
    cls_s[P.n_xent].start = n_items;     // end marker
    cls_s[P.n_xent].xe = -1;
  }
  __syncthreads();
  const int n_items = cls_s[P.n_xent].start;
  const bool g4 = (reinterpret_cast<size_t>(si2wt) & 15) == 0;

  for (int atom = blockIdx.x; atom < P.n_atoms; atom += gridDim.x) {
    __syncthreads();
    for (int i = tid; i < P.d_out; i += NT)
      g_s[i] = gout[(long)atom * P.d_out + i];
    __syncthreads();
    // gm[p][r] = alpha sum_o W^T[o][r] g[p][o], once per atom. A unit is
    // (si2 group, component p, 4 consecutive r); its o range is cut into L
    // parts (L a power of two, at most 8, a part about OX o) run by L
    // neighbouring lanes and summed by an xor butterfly; each group's lanes
    // start on a warp. One 16-byte load of W^T per 4 FMA.
    {
      auto lanes_of = [](int mo) {
        const int np = (mo + OX - 1) / OX;
        return np > 4 ? 8 : np > 2 ? 4 : np;
      };
      auto n_slots = [&](const int* Gr) {
        return (Gr[G_DIM3] * ((Gr[G_K] + 3) / 4) * lanes_of(Gr[G_MO]) + 31)
               & ~31;
      };
      int total = 0;
      for (int g = 0; g < P.n_grp; ++g) total += n_slots(P.grp + g * G_STRIDE);
      for (int s0 = warp * 32; s0 < total; s0 += NT) {
        int g = 0, base = 0;
        while (s0 >= base + n_slots(P.grp + g * G_STRIDE)) {
          base += n_slots(P.grp + g * G_STRIDE);
          ++g;
        }
        const int* Gr = P.grp + g * G_STRIDE;
        const int K = Gr[G_K], mo = Gr[G_MO], kq = (K + 3) / 4;
        const int L = lanes_of(mo), slot = s0 + lane - base, j = slot % L;
        const int unit = slot / L;
        const bool on = unit < Gr[G_DIM3] * kq;
        const int r = 4 * (unit % kq), p = unit / kq;
        const int len = (mo + L - 1) / L;
        const int o0 = on ? j * len : 0, o1 = on ? min(mo, o0 + len) : 0;
        const float* WT = si2wt + Gr[G_WOFF] + r;   // (mo, K)
        const bool v4 = g4 && ((Gr[G_WOFF] | K) & 3) == 0;
        const float* gp = g_s + Gr[G_OUT] + p * mo;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int o = o0; o < o1; ++o) {
          const float* wr = WT + (long)o * K;
          float4 w;
          if (v4) {
            w = __ldg(reinterpret_cast<const float4*>(wr));
          } else {
            w = make_float4(__ldg(wr), r + 1 < K ? __ldg(wr + 1) : 0.f,
                            r + 2 < K ? __ldg(wr + 2) : 0.f,
                            r + 3 < K ? __ldg(wr + 3) : 0.f);
          }
          const float gv = gp[o];
          a0 = fmaf(w.x, gv, a0); a1 = fmaf(w.y, gv, a1);
          a2 = fmaf(w.z, gv, a2); a3 = fmaf(w.w, gv, a3);
        }
        for (int off = L / 2; off > 0; off >>= 1) {
          a0 += __shfl_xor_sync(0xffffffffu, a0, off);
          a1 += __shfl_xor_sync(0xffffffffu, a1, off);
          a2 += __shfl_xor_sync(0xffffffffu, a2, off);
          a3 += __shfl_xor_sync(0xffffffffu, a3, off);
        }
        if (on && j == 0) {
          const float alpha = P.grp_alpha[g];
          float* gm = gm_s + Gr[G_AGG] + p * K + r;
          gm[0] = a0 * alpha;
          if (r + 1 < K) gm[1] = a1 * alpha;
          if (r + 2 < K) gm[2] = a2 * alpha;
          if (r + 3 < K) gm[3] = a3 * alpha;
        }
      }
    }

    for (int t0 = 0; t0 < P.D; t0 += T) {
      const long row0 = (long)atom * P.D + t0;
      const int rows = min(T, P.D - t0);
      __syncthreads();
      for (int i = tid; i < T; i += NT) ms_s[i] = 0.f;
      for (int i = tid; i < NW * T * SHP; i += NT) dshp_s[i] = 0.f;
      load_block(sh + row0 * P.f, rows * P.f, [&](int i, float v) {
        const int e = i / P.f;
        sh_s[e * SHP + i - e * P.f] = v;
      });
      for (int i = tid; i < rows * (SHP - P.f); i += NT) {
        const int e = i / (SHP - P.f);
        sh_s[e * SHP + P.f + i - e * (SHP - P.f)] = 0.f;
      }
      __syncthreads();
      // the rows' weights, one contiguous block: four 16-byte loads in
      // flight a thread, each value into its live column's slot; a row
      // with a nonzero live weight is marked live (every writer stores 1)
      {
        const float* src = weff + row0 * P.wn;
        const int n = rows * P.wn;
        auto put = [&](int i, float v) {
          const int e = i / P.wn, c = wc_s[i - e * P.wn];
          if (c >= 0) {
            w_s[e * nap + c] = v;
            if (v != 0.f) ms_s[e] = 1.f;
          }
        };
        const int head = min(
            n, (int)(((16 - (reinterpret_cast<size_t>(src) & 15)) & 15) >> 2));
        const int n4 = (n - head) >> 2;
        const float4* s4 = reinterpret_cast<const float4*>(src + head);
        for (int i = tid; i < n4; i += 4 * NT) {
          float4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (i + k * NT < n4) v[k] = __ldcs(s4 + i + k * NT);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (i + k * NT < n4) {
              const int j = head + 4 * (i + k * NT);
              put(j, v[k].x); put(j + 1, v[k].y);
              put(j + 2, v[k].z); put(j + 3, v[k].w);
            }
          }
        }
        for (int i = tid; i < head; i += NT) put(i, __ldcs(src + i));
        for (int i = head + 4 * n4 + tid; i < n; i += NT)
          put(i, __ldcs(src + i));
      }
      // a tile of pads only: zero rows, nothing else
      __syncthreads();
      if (!__syncthreads_or(tid < rows && ms_s[tid] != 0.f)) {
        auto zero = [](int) { return 0.f; };
        store_block(dxg + row0 * P.d1, rows * P.d1, zero);
        store_block(dsh + row0 * P.f, rows * P.f, zero);
        store_block(dweff + row0 * P.wn, rows * P.wn, zero);
        continue;
      }
      // the CG backward by i1 class: dxg, dw (in place of w), dsh partials
      for (int j0 = warp * 32; j0 < n_items; j0 += NT) {
        int k = 0;
        while (cls_s[k + 1].xe >= 0 && cls_s[k + 1].start <= j0) ++k;
        const XClass C = cls_s[k];
        const int loc = j0 + lane - C.start;
        const int e = loc / C.lanes, lane_u = loc - e * C.lanes;
        const bool valid = e < rows;
        float dshv[NSH];
#pragma unroll
        for (int n = 0; n < NSH; ++n) dshv[n] = 0.f;
        if (valid) {
          const int* X = P.xent + C.xe * X_STRIDE;
          float sv[(NSH + 3) & ~3];
#pragma unroll
          for (int n = 0; n < ((NSH + 3) & ~3); n += 4) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(sh_s + e * SHP + n);
            sv[n] = s4.x; sv[n + 1] = s4.y; sv[n + 2] = s4.z; sv[n + 3] = s4.w;
          }
          switch (C.l1) {
#define EXTW_CLASS_CASE(l)                                                 \
            case l:                                                        \
              bwd_class_item<NSH, l>(P, X, ins_s, sc_s, gm_s, xg, dxg,     \
                                     row0 + e, ms_s[e], sv,                \
                                     w_s + e * nap, lane_u, C.uit, dshv);  \
              break;
            EXTW_CLASS_CASE(0) EXTW_CLASS_CASE(1) EXTW_CLASS_CASE(2)
            EXTW_CLASS_CASE(3)
#undef EXTW_CLASS_CASE
          }
        }
        if (C.lanes == 32) {
          const float tot = butterfly16(dshv, lane);
          if (valid && !(lane & 1))
            dshp_s[(warp * T + e) * SHP + butterfly_index(lane)] += tot;
        } else {
          for (int l = 0; l < 32; ++l) {
            if (lane == l && valid) {
#pragma unroll
              for (int n = 0; n < NSH; ++n)
                dshp_s[(warp * T + e) * SHP + n] += dshv[n];
            }
            __syncwarp();
          }
        }
      }
      __syncthreads();
      // the rows' dsh and dweff: 16-byte streaming stores, zeros in the
      // dead weight columns (and everywhere on pad rows)
      store_block(dsh + row0 * P.f, rows * P.f, [&](int i) {
        const int e = i / P.f, j = i - e * P.f;
        float s = 0.f;
        for (int w = 0; w < NW; ++w) s += dshp_s[(w * T + e) * SHP + j];
        return s;
      });
      store_block(dweff + row0 * P.wn, rows * P.wn, [&](int i) {
        const int e = i / P.wn, c = wc_s[i - e * P.wn];
        return c >= 0 ? w_s[e * nap + c] : 0.f;
      });
    }
  }
}

// rows per tile: the largest of 32, 16, 8 (not past D rounded up to 8)
// whose block fits two an SM, else the smallest that fits one; 0 if none
int extw_tile(const Plan& P) {
  const int dmax = ((P.D + 7) & ~7) < TX ? ((P.D + 7) & ~7) : TX;
  for (int T = dmax; T >= 8; T /= 2)
    if ((size_t)4 * extw_words(P, T) <= TWO_PER_SM) return T;
  return (size_t)4 * extw_words(P, 8) <= 232448 ? 8 : 0;
}

template <int NSH>
int launch_extw_bwd(const float* g, const float* xg, const float* sh,
                    const float* weff, const float* si2wt, const Plan& P,
                    int T, float* dxg, float* dsh, float* dweff,
                    void* stream) {
  const size_t smem = 4 * (size_t)extw_words(P, T);
  cudaError_t err = reserve_smem(fused_conv_extw_bwd_kernel<NSH>, smem,
                                 Reserved<true, NSH, 3>::bytes);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_extw_bwd_kernel<NSH>, smem, P.n_atoms,
                          &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_extw_bwd_kernel<NSH><<<grid, NT, smem, (cudaStream_t)stream>>>(
        g, xg, sh, weff, si2wt, P, T, dxg, dsh, dweff);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// the external-weight forward (fused_conv_extw_fwd, row 7)
// ---------------------------------------------------------------------
//
// Replaces make_fused_conv(agg_d > 0, ext_w).fwd_kernel_cm_w
// (sevennet_exp_tpu/ops/pallas_conv.py, _cm_fwd_core on given weights): per
// atom A = sum over its D rows of weff (x) CG(xg, sh), then y = si2(A); no
// MLP. Built, like the backward above, only in fused_conv_geom_extw.
//
// What bounds it on this card: bytes. A mid layer reads ~4.3 kB a row (xg,
// sh, 576 live of 960 weights) for ~5k multiply-adds. Its first design
// (fwd_body<M_EXTW> of fused_conv_body.cuh) ran at ~10 % of that bound: a
// block per atom on 32-row tiles staged by 4-byte loads, a thread per live
// column with one weight load in flight, the CG table-driven with four
// shared table loads per term. What this design does:
//  - The dense forward's CG (fwd_cg: unrolled per (l1, l2, l3) from
//    cg_patterns.cuh, one (live column, row group) a thread, the row
//    groups' partial aggregates summed in a fixed order), with w read from
//    the tile's weights where the dense forward computes it.
//  - The weights: only the live column runs (an instruction's columns are
//    the contiguous [w_off, w_off + mul)), by 16-byte streaming loads, four
//    in flight a thread, into the packed live columns of the tile (single
//    loads when a run is not 16-byte aligned); sh rows by 16-byte loads.
//    xg is read by the CG's coalesced loads, once per instruction, as the
//    dense forward reads it.
//  - Tiles of up to 16 rows at three blocks an SM (tile and row groups:
//    extw_fwd_shape), a persistent grid, si2 once per atom.
// A row whose live weights are all zero is a pad: it sends nothing (the CG
// skips a zero weight). Sums run in a fixed order (no atomics).

// shared words of one forward block at T rows and s row groups (the C entry
// holds the caller's number against it)
__host__ __device__ inline int extw_fwd_words(const Plan& P, int T, int s) {
  auto r4 = [](int n) { return (n + 3) & ~3; };
  const int nap = r4(P.n_active);
  return table_words(P) + r4(P.n_ins) + nap + T * SHP + T * nap
         + s * r4(P.agg_dim) + r4(P.d_out);
}

// rows per tile and CG row groups: the most rows, D rounded up to 4 at most
// 16, whose block fits three an SM (else two, else one) with one row
// group; then the row groups (1, 2 or 4, each a multiple of 4 rows) that
// take the fewest rounds of the block's threads, a column's start counted
// as 4 rows, within the same blocks an SM. T = 0: no tile fits.
void extw_fwd_shape(const Plan& P, int* T_out, int* s_out) {
  const size_t fits[3] = {(233472 - 3 * 1024) / 3, TWO_PER_SM, 232448};
  *T_out = *s_out = 0;
  for (size_t lim : fits) {
    for (int T = tile_rows(P.D, TF); T >= 4; T -= 4) {
      if ((size_t)4 * extw_fwd_words(P, T, 1) > lim) continue;
      long best = -1;
      for (int s = 1; s <= 4; s *= 2) {
        if (T % (4 * s) || (size_t)4 * extw_fwd_words(P, T, s) > lim) break;
        const long cost = (((long)P.n_active * s + NT - 1) / NT) * (T / s + 4);
        if (best < 0 || cost < best) { best = cost; *s_out = s; }
      }
      *T_out = T;
      return;
    }
  }
}

__global__ void __launch_bounds__(NT, 3)
fused_conv_extw_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ weff,
                           const float* __restrict__ si2w, Plan P, int T,
                           int s, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  auto r4 = [](int n) { return (n + 3) & ~3; };
  int* ins_s = reinterpret_cast<int*>(smem);
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) {
    float* q = next_s; next_s += n; return q;
  };
  const int nap = r4(P.n_active);
  float* sc_s = take(r4(P.n_ins));
  int* src_s = reinterpret_cast<int*>(take(nap));   // live col -> weight col
  float* sh_s = take(T * SHP);
  float* w_s = take(T * nap);
  float* aggp_s = take(s * r4(P.agg_dim));
  float* out_s = take(r4(P.d_out));

  const int tid = threadIdx.x;
  load_tables(P, ins_s, nzi_s, nzc_s);
  for (int c = tid; c < P.n_active; c += NT) src_s[c] = __ldg(P.col_w + c);
  __syncthreads();
  for (int i = tid; i < P.n_ins; i += NT) {
    const int* I = ins_s + i * I_STRIDE;
    float sc = 0.f;
    switch (shape_key(I)) {
#define EXTW_FWD_SCALE_CASE(a, b, c) \
      case a * 16 + b * 4 + c: sc = pattern_scale<a, b, c>(I, nzc_s); break;
      CG_SHAPES(EXTW_FWD_SCALE_CASE)
#undef EXTW_FWD_SCALE_CASE
    }
    sc_s[i] = sc;
  }
  // the live columns in aligned runs of four (every run's start and length
  // a multiple of 4, 16-byte weight rows): 16-byte loads, else single ones
  bool run4 = (P.n_active & 3) == 0 && (P.wn & 3) == 0
              && (reinterpret_cast<size_t>(weff) & 15) == 0;
  for (int c = tid; c < P.n_active && run4; c += NT)
    run4 = (c & 3) ? src_s[c] == src_s[c - 1] + 1 : (src_s[c] & 3) == 0;
  const bool vec = __syncthreads_and(run4);
  const int nq = P.n_active / 4, R = T / s;

  for (int atom = blockIdx.x; atom < P.n_atoms; atom += gridDim.x) {
    __syncthreads();
    for (int i = tid; i < s * r4(P.agg_dim); i += NT) aggp_s[i] = 0.f;
    for (int t0 = 0; t0 < P.D; t0 += T) {
      const long row0 = (long)atom * P.D + t0;
      const int rows = min(T, P.D - t0);
      __syncthreads();
      load_block(sh + row0 * P.f, rows * P.f, [&](int i, float v) {
        const int e = i / P.f;
        sh_s[e * SHP + i - e * P.f] = v;
      });
      for (int i = tid; i < rows * (SHP - P.f); i += NT) {
        const int e = i / (SHP - P.f);
        sh_s[e * SHP + P.f + i - e * (SHP - P.f)] = 0.f;
      }
      const float* wrow = weff + row0 * P.wn;
      if (vec) {
        for (int i = tid; i < rows * nq; i += 4 * NT) {
          float4 v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = i + k * NT, e = j / nq;
            if (j < rows * nq)
              v[k] = __ldcs(reinterpret_cast<const float4*>(
                  wrow + (long)e * P.wn + src_s[4 * (j - e * nq)]));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = i + k * NT, e = j / nq;
            if (j < rows * nq)
              *reinterpret_cast<float4*>(w_s + e * nap + 4 * (j - e * nq)) =
                  v[k];
          }
        }
      } else {
        for (int i = tid; i < rows * P.n_active; i += NT) {
          const int e = i / P.n_active, c = i - e * P.n_active;
          w_s[e * nap + c] = __ldcs(wrow + (long)e * P.wn + src_s[c]);
        }
      }
      __syncthreads();
      const float* xr = xg + row0 * P.d1;
      for (int j = tid; j < P.n_active * s; j += NT) {
        const int c = j % P.n_active, g = j / P.n_active;
        const int e0 = g * R, e1 = min(e0 + R, rows);
        if (e0 >= e1) continue;
        const int ii = __ldg(P.col_ins + c);
        const int* I = ins_s + ii * I_STRIDE;
        const int u = c - I[I_COL0];
        float* aggp = aggp_s + g * r4(P.agg_dim);
        switch (shape_key(I)) {
#define EXTW_FWD_CASE(A, B, C)                                              \
          case A * 16 + B * 4 + C:                                          \
            fwd_cg<A, B, C>(P, I, u, c, sc_s[ii], xr, sh_s, w_s, nap, e0,   \
                            e1, aggp);                                      \
            break;
          CG_SHAPES(EXTW_FWD_CASE)
#undef EXTW_FWD_CASE
        }
      }
    }
    __syncthreads();
    // the row groups' partial aggregates, summed in a fixed order
    for (int i = tid; i < P.agg_dim; i += NT) {
      float a = aggp_s[i];
      for (int g = 1; g < s; ++g) a += aggp_s[g * r4(P.agg_dim) + i];
      aggp_s[i] = a;
    }
    for (int i = tid; i < P.d_out; i += NT) out_s[i] = 0.f;
    __syncthreads();
    // per-atom self-interaction 2 over the aggregate
    for (int g = 0; g < P.n_grp; ++g) {
      const int* Gr = P.grp + g * G_STRIDE;
      const int K = Gr[G_K], mo = Gr[G_MO], n = Gr[G_DIM3] * mo;
      const float alpha = P.grp_alpha[g];
      const float* W = si2w + Gr[G_WOFF];
      const float* a = aggp_s + Gr[G_AGG];
      for (int t = tid; t < n; t += NT) {
        const int p = t / mo, o = t - p * mo;
        const float* ap = a + p * K;
        float acc = 0.f;
        for (int r = 0; r < K; ++r)
          acc = fmaf(ap[r], __ldg(W + (long)r * mo + o), acc);
        out_s[Gr[G_OUT] + p * mo + o] = acc * alpha;
      }
    }
    __syncthreads();
    for (int i = tid; i < P.d_out; i += NT)
      __stcs(out + (long)atom * P.d_out + i, out_s[i]);
  }
}

int launch_extw_fwd(const float* xg, const float* sh, const float* weff,
                    const float* si2w, const Plan& P, int T, int s,
                    float* out, void* stream) {
  const size_t smem = 4 * (size_t)extw_fwd_words(P, T, s);
  cudaError_t err = reserve_smem(fused_conv_extw_fwd_kernel, smem,
                                 Reserved<false, 0, 3>::bytes);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0) {
    int grid = 0;
    err = persistent_grid(fused_conv_extw_fwd_kernel, smem, P.n_atoms, &grid);
    if (err != cudaSuccess) return (int)err;
    fused_conv_extw_fwd_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        xg, sh, weff, si2w, P, T, s, out);
  }
  return (int)cudaGetLastError();
}
#endif  // FUSED_CONV_EXTW

// the edge pair's plan: the C entries get one "atom" per row (D = 1); the
// backward takes tiles of TE rows as its atoms, the last one cut at n_rows,
// and the forward walks tiles of its own rows over n_rows (edge_fwd_tiles)
// on the grid this sizes
Plan edge_tiles(Plan P) {
  const long rows = P.n_rows;
  P.D = TE;
  P.n_atoms = (int)((rows + TE - 1) / TE);
  P.n_rows = rows;
  return P;
}

}  // namespace

#if !FUSED_CONV_EXTW
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
// arithmetic): T, s, nap, cq and the dynamic shared bytes; mode 0 the dense
// pair, 1 the geometry-fused pair, 2 the edge pair
extern "C" int fused_conv_geom_shape(int bwd, int mode, PLAN_ARGS,
                                     int* out) {
  const Plan P = PLAN_CALL;
  const Shape S = geom_shape(P, bwd != 0, mode);
  out[0] = S.T; out[1] = S.s; out[2] = S.nap; out[3] = S.cq;
  out[4] = (int)(4 * words(P, S, bwd != 0, mode));
  return 0;
}

// the compiled kernel a layer launches: registers, local bytes a thread,
// blocks an SM and dynamic shared bytes (on the current device)
extern "C" int fused_conv_geom_resources(int bwd, int mode, PLAN_ARGS,
                                         int* out) {
  const Plan P = PLAN_CALL;
  if (mode == K_EDGE) return resources_of<K_EDGE>(P, bwd != 0, out);
  return mode == K_GEOM ? resources_of<K_GEOM>(P, bwd != 0, out)
                        : resources_of<K_DENSE>(P, bwd != 0, out);
}

extern "C" int fused_conv_geom_fwd(const float* xg, const float* vec,
                                   const float* ms, const float* w0,
                                   const float* w1, const float* w2,
                                   const float* si2w, PLAN_ARGS, GEOM_ARGS,
                                   float* out, void* stream) {
  return launch_fwd<K_GEOM>(xg, vec, ms, w0, w1, w2, si2w, PLAN_CALL,
                            GEOM_CALL, out, stream);
}

extern "C" int fused_conv_geom_bwd(const float* g, const float* xg,
                                   const float* vec, const float* ms,
                                   const float* w0, const float* w1,
                                   const float* w1t, const float* w2,
                                   const float* w2t, const float* si2wt,
                                   PLAN_ARGS, GEOM_ARGS, float* dxg,
                                   float* dvec, void* stream) {
  return launch_bwd_nsh<K_GEOM>(g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt,
                                PLAN_CALL, GEOM_CALL, dxg, dvec, stream);
}

// the dense pair: kernels 1-2's C entries, their arguments unchanged
extern "C" int fused_conv_fwd(const float* xg, const float* sh,
                              const float* emb, const float* ms,
                              const float* w0, const float* w1,
                              const float* w2, const float* si2w,
                              PLAN_ARGS, float* out, void* stream) {
  const Dense R = {sh, emb, nullptr, nullptr};
  return launch_fwd<K_DENSE>(xg, nullptr, ms, w0, w1, w2, si2w, PLAN_CALL, R,
                             out, stream);
}

extern "C" int fused_conv_bwd(const float* g, const float* xg,
                              const float* sh, const float* emb,
                              const float* ms, const float* w0,
                              const float* w1, const float* w1t,
                              const float* w2, const float* w2t,
                              const float* si2wt, PLAN_ARGS, float* dxg,
                              float* dsh, float* demb, void* stream) {
  const Dense R = {sh, emb, dsh, demb};
  return launch_bwd_nsh<K_DENSE>(g, xg, nullptr, ms, w0, w1, w1t, w2, w2t,
                                 si2wt, PLAN_CALL, R, dxg, nullptr, stream);
}

// the edge pair (agg_d = 0): kernels 1-2's edge-row C entries, their
// arguments unchanged (one "atom" of one row per input row)
extern "C" int fused_conv_edge_fwd(const float* xg, const float* sh,
                                   const float* emb, const float* ms,
                                   const float* w0, const float* w1,
                                   const float* w2, const float* si2w,
                                   PLAN_ARGS, float* out, void* stream) {
  const Plan P = PLAN_CALL;
  if (P.D != 1) return (int)cudaErrorInvalidValue;
  const Dense R = {sh, emb, nullptr, nullptr};
  return launch_fwd<K_EDGE>(xg, nullptr, ms, w0, w1, w2, si2w, edge_tiles(P),
                            R, out, stream);
}

extern "C" int fused_conv_edge_bwd(const float* g, const float* xg,
                                   const float* sh, const float* emb,
                                   const float* ms, const float* w0,
                                   const float* w1, const float* w1t,
                                   const float* w2, const float* w2t,
                                   const float* si2wt, PLAN_ARGS, float* dxg,
                                   float* dsh, float* demb, void* stream) {
  const Plan P = PLAN_CALL;
  if (P.D != 1) return (int)cudaErrorInvalidValue;
  const Dense R = {sh, emb, dsh, demb};
  return launch_bwd_nsh<K_EDGE>(g, xg, nullptr, ms, w0, w1, w1t, w2, w2t,
                                si2wt, edge_tiles(P), R, dxg, nullptr,
                                stream);
}
#endif  // !FUSED_CONV_EXTW

#if FUSED_CONV_EXTW
// the external-weight backward (row 8): T and the shared words as the
// caller planned them (ops/fused_conv_geom.py::extw_tile, extw_words),
// refused unless they are this file's (extw_tile, extw_words)
extern "C" int fused_conv_extw_bwd(const float* g, const float* xg,
                                   const float* sh, const float* weff,
                                   const float* si2wt, PLAN_ARGS, int T,
                                   int words, float* dxg, float* dsh,
                                   float* dweff, void* stream) {
  const Plan P = PLAN_CALL;
  if (P.f > SHP || T != extw_tile(P) || words != extw_words(P, T))
    return (int)cudaErrorInvalidValue;
  if (P.f <= 4)
    return launch_extw_bwd<4>(g, xg, sh, weff, si2wt, P, T, dxg, dsh, dweff,
                              stream);
  if (P.f <= 9)
    return launch_extw_bwd<9>(g, xg, sh, weff, si2wt, P, T, dxg, dsh, dweff,
                              stream);
  return launch_extw_bwd<16>(g, xg, sh, weff, si2wt, P, T, dxg, dsh, dweff,
                             stream);
}

// the external-weight forward (row 7): T, the row groups s and the shared
// words as the caller planned them (ops/fused_conv_geom.py::extw_fwd_shape,
// extw_fwd_words), refused unless they are this file's
extern "C" int fused_conv_extw_fwd(const float* xg, const float* sh,
                                   const float* weff, const float* si2w,
                                   PLAN_ARGS, int T, int s, int words,
                                   float* out, void* stream) {
  const Plan P = PLAN_CALL;
  int T_own = 0, s_own = 0;
  extw_fwd_shape(P, &T_own, &s_own);
  if (P.f > SHP || T_own == 0 || T != T_own || s != s_own
      || words != extw_fwd_words(P, T, s))
    return (int)cudaErrorInvalidValue;
  return launch_extw_fwd(xg, sh, weff, si2w, P, T, s, out, stream);
}

// the forward a layer launches: registers, local bytes a thread, blocks an
// SM and dynamic shared bytes (on the current device)
extern "C" int fused_conv_extw_fwd_resources(PLAN_ARGS, int* out) {
  const Plan P = PLAN_CALL;
  int T = 0, s = 0;
  extw_fwd_shape(P, &T, &s);
  if (P.f > SHP || T == 0) return (int)cudaErrorInvalidValue;
  return resources(fused_conv_extw_fwd_kernel,
                   4 * (size_t)extw_fwd_words(P, T, s),
                   Reserved<false, 0, 3>::bytes, out);
}

// the backward a layer launches: registers, local bytes a thread, blocks an
// SM and dynamic shared bytes (on the current device)
extern "C" int fused_conv_extw_resources(PLAN_ARGS, int* out) {
  const Plan P = PLAN_CALL;
  const int T = extw_tile(P);
  if (P.f > SHP || T == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)extw_words(P, T);
  if (P.f <= 4)
    return resources(fused_conv_extw_bwd_kernel<4>, smem,
                     Reserved<true, 4, 3>::bytes, out);
  if (P.f <= 9)
    return resources(fused_conv_extw_bwd_kernel<9>, smem,
                     Reserved<true, 9, 3>::bytes, out);
  return resources(fused_conv_extw_bwd_kernel<16>, smem,
                   Reserved<true, 16, 3>::bytes, out);
}
#endif  // FUSED_CONV_EXTW
