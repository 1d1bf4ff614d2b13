// Fused convolution block on the dense neighbor grid, forward and force
// backward, for NVIDIA Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_fwd      <- make_fused_conv(agg_d > 0).fwd_kernel_cm
//                          (_cm_fwd_core, _cg_acc_cm, _mlp_forward)
//   fused_conv_bwd      <- make_fused_conv(agg_d > 0).bwd_kernel_cm
//                          (_cm_bwd_core, _act_grad)
//   fused_conv_geom_fwd <- make_fused_conv(agg_d > 0, geom).fwd_kernel_geom
//                          (_geom_fm, _sh_rows_fm, _mlp_fm, _cm_fwd_core)
//   fused_conv_geom_bwd <- make_fused_conv(agg_d > 0, geom).bwd_kernel_geom
//                          (the same, _cm_bwd_core and the geometry VJP)
//
// Per grid row e of atom i (row i*D + k is atom i's k-th neighbor):
//   w[e]  = MLP(emb[e]) * ms[e]            radial MLP nb -> 64 -> 64 -> wn
//   A_i   = sum_e w[e] (x) CG(xg[e], sh[e]) uvu tensor product, summed over
//                                          the atom's D rows
//   y[i]  = si2(A_i)                       self-interaction 2 per atom
// The backward takes the node cotangent g[i], forms gm = si2^T g[i] ONCE
// per atom (the D rows share it), recomputes the MLP and returns dxg,
// dsh and demb; weights and the mask scale get no gradient.
//
// What bounds it on this card: arithmetic. A mid layer (d1 = 480, 576
// live MLP columns) does ~41k multiply-adds of radial MLP and ~4.3k of
// CG per row against ~2 kB of input per row, i.e. ~40 flop/byte, far
// above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/byte; the
// MLP output layer (64 x 576 per row) is ~85% of the work.
//
// What this simple design does about it: one block owns one atom, so the
// D-row sum stays in shared memory with no atomics and no second pass,
// and the per-atom si2 (forward) and si2^T g (backward) run once per
// atom instead of once per row. A thread owns one live MLP output column
// (instruction, channel): it keeps that column of w2 in 64 registers
// (read once per tile, coalesced: w2 is (64, wn) row-major and lanes take
// consecutive columns -- the whole w2 would not fit in shared memory),
// so the MLP output layer is register-blocked over the tile's rows and
// its input (the hidden row) is a shared-memory broadcast; the backward's
// dw @ w2^T is register-blocked the same way over the tile's rows. The
// CG tables live in shared memory. Instructions no si2 path reads are
// never computed, and rows with ms == 0 (grid pads) are skipped.
// Everything is CUDA-core fp32 FMA: no TF32, no tensor cores yet
// (wgmma/3xTF32 for the MLP is the next step).
//
// The kernels are table-driven over the layer's plan (built by
// ops/fused_conv.py from _tp_plan / _si2_groups), so one source serves
// every layer (irreps up to l = 3).
//
// The geometry-fused pair takes the raw edge vector instead of sh and emb:
//   r      = sqrt(|v|^2 + 1e-30)
//   emb_n  = (2/rc) sin(c_n r)/r * env(r)       env: polynomial or XPLOR
//   sh     = component-normalised real SH of v/r (a table of monomial terms)
// computed per row tile into the shared-memory rows the MLP and the CG read,
// so emb and sh never exist in global memory. Its backward keeps dsh and
// demb of the tile in shared memory and folds them into dvec by the
// geometry VJP written out by hand:
//   dvec = (sum_n demb_n d emb_n/dr) v/r + (I - u u^T) (dsh . dY/du) / r
// It is bound like the plain pair (the geometry is ~1 % of a mid layer's
// arithmetic); what it saves is the (E, 17) round trip through global memory
// and the PyTorch passes that would produce sh, emb and their VJPs. sinf,
// cosf, sqrtf and powf are the accurate versions (c_n r reaches 8 pi).

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;       // radial MLP hidden width
constexpr int NT = 256;     // threads per block
constexpr int RT_F = 32;    // forward rows per tile
constexpr int RT_B = 8;     // backward rows per tile
constexpr int MAXD = 8;     // offsets per key in an instruction record
constexpr int KQ = NT / H;  // column groups of the backward's dw @ w2^T

// instruction record (int32), one per live instruction
enum {
  I_XOFF = 0, I_MUL, I_SHOFF, I_WOFF, I_DIM1, I_DIM2, I_DIM3, I_AGG, I_K,
  I_COL0, I_POFF, I_NOFF = I_POFF + MAXD, I_MOFF = I_NOFF + MAXD,
  I_STRIDE = I_MOFF + MAXD
};
// si2 group record: K rows, mo outputs, components, output offset,
// offset in the aggregate buffer, offset in the flat si2 weights
enum { G_K = 0, G_MO, G_DIM3, G_OUT, G_AGG, G_WOFF, G_STRIDE };
// x entry record: offset, mul, dim, number of live users, first user
enum { X_OFF = 0, X_MUL, X_DIM, X_NINS, X_INS0, X_STRIDE };

struct Plan {
  const int* ins;        // n_ins * I_STRIDE
  const int* col_ins;    // n_active: live column -> instruction
  const int* col_w;      // n_active: live column -> MLP output column
  const int* nz_idx;     // m | n << 8 | p << 16
  const float* nz_coef;  // CG coefficient (path normalisation folded in)
  const int* grp;        // n_grp * G_STRIDE
  const float* grp_alpha;
  const int* xent;       // n_xent * X_STRIDE
  const int* xins;       // live instructions per x entry
  int n_atoms, D, d1, f, nb, wn, d_out;
  int n_ins, n_active, n_grp, n_xent, agg_dim, n_nz;
  int act;               // 0 silu, 1 tanh
  float act_cst, s0, s1, s2;   // normalize2mom constant, 1/sqrt(fan-in)
};

// words of shared memory the instruction and CG tables take
__host__ __device__ inline int table_words(const Plan& P) {
  return P.n_ins * I_STRIDE + 2 * P.n_nz;
}

// copy the instruction and CG tables into shared memory (not synced)
__device__ __forceinline__ void load_tables(const Plan& P, int* ins_s,
                                            int* nzi_s, float* nzc_s) {
  for (int i = threadIdx.x; i < P.n_ins * I_STRIDE; i += NT)
    ins_s[i] = P.ins[i];
  for (int i = threadIdx.x; i < P.n_nz; i += NT) {
    nzi_s[i] = P.nz_idx[i];
    nzc_s[i] = P.nz_coef[i];
  }
}

__device__ __forceinline__ float act_f(float x, int act) {
  if (act == 0) return x / (1.f + expf(-x));
  return tanhf(x);
}

__device__ __forceinline__ float act_df(float x, int act) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-x));
    return s + x * s * (1.f - s);
  }
  const float t = tanhf(x);
  return 1.f - t * t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// hidden layers of the radial MLP for `rows` rows: h0, h1 (and the
// activation derivatives when da0/da1 are given). Ends synchronised.
__device__ void mlp_hidden(const Plan& P, int rows, const float* emb_s,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1, float* h0_s,
                           float* h1_s, float* da0_s, float* da1_s) {
  for (int i = threadIdx.x; i < rows * H; i += NT) {
    const int e = i / H, j = i - e * H;
    float s = 0.f;
    for (int b = 0; b < P.nb; ++b)
      s = fmaf(emb_s[e * P.nb + b], __ldg(w0 + b * H + j), s);
    s *= P.s0;
    h0_s[i] = act_f(s, P.act) * P.act_cst;
    if (da0_s) da0_s[i] = act_df(s, P.act) * P.act_cst;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * H; i += NT) {
    const int e = i / H, j = i - e * H;
    const float* hr = h0_s + e * H;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < H; ++k) s = fmaf(hr[k], __ldg(w1 + k * H + j), s);
    s *= P.s1;
    h1_s[i] = act_f(s, P.act) * P.act_cst;
    if (da1_s) da1_s[i] = act_df(s, P.act) * P.act_cst;
  }
  __syncthreads();
}

__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          long row0, int rows, int width) {
  const float* s = src + row0 * width;
  for (int i = threadIdx.x; i < rows * width; i += NT) dst[i] = s[i];
}

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

__device__ __forceinline__ float ipow(float x, int k) {   // k <= 3
  float r = 1.f;
  for (int i = 0; i < k; ++i) r *= x;
  return r;
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

// emb and sh rows of a tile from its edge vectors, into shared memory:
// one thread per (row, basis function or SH component). Not synced.
__device__ void geom_rows_fwd(const Plan& P, const Geom& G, int rows,
                              const float* vec_s, float* emb_s,
                              float* sh_s) {
  const int per = P.nb + P.f;
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
    if (k < P.nb) {
      const Radial R = radial_of(G, x, y, z);
      emb_s[e * P.nb + k] = sinf(__ldg(G.coeffs + k) * R.r)
                            * ((2.f / G.cutoff) * R.inv_r * R.env);
    } else {
      const int j = k - P.nb;
      float ux = x, uy = y, uz = z;
      if (G.normalize) {
        const float inv_r = 1.f / sqrtf(x * x + y * y + z * z + 1e-30f);
        ux *= inv_r; uy *= inv_r; uz *= inv_r;
      }
      float s = 0.f;
      const int t1 = __ldg(G.sh_off + j + 1);
      for (int t = __ldg(G.sh_off + j); t < t1; ++t) {
        const int id = __ldg(G.sh_idx + t);
        s = fmaf(__ldg(G.sh_coef + t),
                 ipow(ux, id & 15) * ipow(uy, (id >> 4) & 15)
                     * ipow(uz, (id >> 8) & 15), s);
      }
      sh_s[e * P.f + j] = s;
    }
  }
}

// geometry VJP of a tile: (demb, dsh) rows in shared memory -> dvec rows in
// global memory, one warp per row, lanes over the basis functions and the
// SH terms. Rows with ms == 0 get zeros.
__device__ void geom_rows_bwd(const Plan& P, const Geom& G, int rows,
                              long row0, const float* vec_s,
                              const float* ms_s, const float* demb_s,
                              const float* dsh_s, float* __restrict__ dvec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < rows; e += NT / 32) {
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
    const Radial R = radial_of(G, x, y, z);
    float ux = x, uy = y, uz = z;
    if (G.normalize) { ux *= R.inv_r; uy *= R.inv_r; uz *= R.inv_r; }
    float gr = 0.f, gx = 0.f, gy = 0.f, gz = 0.f;
    if (ms_s[e] != 0.f) {
      // d emb_n / dr = (2/rc) [(c cos(cr)/r - sin(cr)/r^2) env
      //                        + sin(cr)/r env']
      for (int n = lane; n < P.nb; n += 32) {
        const float c = __ldg(G.coeffs + n);
        const float s = sinf(c * R.r), co = cosf(c * R.r);
        const float d = (2.f / G.cutoff)
                        * ((c * co - s * R.inv_r) * R.inv_r * R.env
                           + s * R.inv_r * R.denv);
        gr = fmaf(demb_s[e * P.nb + n], d, gr);
      }
      // gu = sum_j dsh_j dY_j/du, term by term
      for (int t = lane; t < G.n_terms; t += 32) {
        const int id = __ldg(G.sh_idx + t);
        const int a = id & 15, b = (id >> 4) & 15, c = (id >> 8) & 15;
        const float gj = dsh_s[e * P.f + (id >> 12)] * __ldg(G.sh_coef + t);
        if (a) gx = fmaf(gj, a * ipow(ux, a - 1) * ipow(uy, b) * ipow(uz, c),
                         gx);
        if (b) gy = fmaf(gj, b * ipow(ux, a) * ipow(uy, b - 1) * ipow(uz, c),
                         gy);
        if (c) gz = fmaf(gj, c * ipow(ux, a) * ipow(uy, b) * ipow(uz, c - 1),
                         gz);
      }
    }
    gr = warp_sum(gr); gx = warp_sum(gx); gy = warp_sum(gy);
    gz = warp_sum(gz);
    if (lane == 0) {
      float dx = gx, dy = gy, dz = gz;
      if (G.normalize) {     // u = v/r: du/dv = (I - u u^T)/r
        const float dot = ux * gx + uy * gy + uz * gz;
        dx = (gx - ux * dot) * R.inv_r;
        dy = (gy - uy * dot) * R.inv_r;
        dz = (gz - uz * dot) * R.inv_r;
      }
      // dr/dv = v/r
      float* o = dvec + (row0 + e) * 3;
      o[0] = fmaf(gr, x * R.inv_r, dx);
      o[1] = fmaf(gr, y * R.inv_r, dy);
      o[2] = fmaf(gr, z * R.inv_r, dz);
    }
  }
}

// forward of one atom's block. GEOM: sh and emb are not read; the tile's rows
// are computed from vec into the same shared-memory rows.
template <bool GEOM>
__device__ __forceinline__ void fwd_body(const float* __restrict__ xg,
                                         const float* __restrict__ sh,
                                         const float* __restrict__ emb,
                                         const float* __restrict__ vec,
                                         const float* __restrict__ ms,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ si2w,
                                         const Plan& P, const Geom& G,
                                         float* __restrict__ out) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  float* x_s = smem + table_words(P);    // RT_F * d1
  float* sh_s = x_s + RT_F * P.d1;       // RT_F * f
  float* emb_s = sh_s + RT_F * P.f;      // RT_F * nb
  float* ms_s = emb_s + RT_F * P.nb;     // RT_F
  float* h0_s = ms_s + RT_F;             // RT_F * H
  float* h1_s = h0_s + RT_F * H;         // RT_F * H
  float* agg_s = h1_s + RT_F * H;        // agg_dim
  float* out_s = agg_s + P.agg_dim;      // d_out
  float* vec_s = out_s + P.d_out;        // RT_F * 3 (GEOM only)

  const int atom = blockIdx.x;
  const int tid = threadIdx.x;
  load_tables(P, ins_s, nzi_s, nzc_s);
  for (int i = tid; i < P.agg_dim; i += NT) agg_s[i] = 0.f;

  for (int t0 = 0; t0 < P.D; t0 += RT_F) {
    const int rows = min(RT_F, P.D - t0);
    const long row0 = (long)atom * P.D + t0;
    __syncthreads();
    load_rows(x_s, xg, row0, rows, P.d1);
    load_rows(ms_s, ms, row0, rows, 1);
    if constexpr (GEOM) {
      load_rows(vec_s, vec, row0, rows, 3);
      __syncthreads();
      geom_rows_fwd(P, G, rows, vec_s, emb_s, sh_s);
    } else {
      load_rows(sh_s, sh, row0, rows, P.f);
      load_rows(emb_s, emb, row0, rows, P.nb);
    }
    __syncthreads();
    mlp_hidden(P, rows, emb_s, w0, w1, h0_s, h1_s, nullptr, nullptr);

    for (int c = tid; c < P.n_active; c += NT) {
      const int* I = ins_s + P.col_ins[c] * I_STRIDE;
      const int u = c - I[I_COL0];
      const int mul = I[I_MUL], K = I[I_K], d3 = I[I_DIM3];
      const int col = P.col_w[c];
      float wc[H];
#pragma unroll
      for (int k = 0; k < H; ++k) wc[k] = __ldg(w2 + (long)k * P.wn + col);
      const float* xb = x_s + I[I_XOFF] + u;
      const float* sb = sh_s + I[I_SHOFF];
      float* ab = agg_s + I[I_AGG] + u;
      for (int e = 0; e < rows; ++e) {
        const float m_e = ms_s[e];
        if (m_e == 0.f) continue;          // grid pad row: no message
        const float* hr = h1_s + e * H;
        float w = 0.f;
#pragma unroll
        for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
        w *= P.s2 * m_e;
        const float* xr = xb + e * P.d1;
        const float* sr = sb + e * P.f;
        for (int p = 0; p < d3; ++p) {
          float s = 0.f;
          const int q1 = I[I_POFF + p + 1];
          for (int q = I[I_POFF + p]; q < q1; ++q) {
            const int id = nzi_s[q];
            s = fmaf(nzc_s[q] * xr[(id & 0xff) * mul], sr[(id >> 8) & 0xff],
                     s);
          }
          ab[p * K] += w * s;
        }
      }
    }
  }
  __syncthreads();

  // per-atom self-interaction 2 over the aggregated messages
  for (int i = tid; i < P.d_out; i += NT) out_s[i] = 0.f;
  __syncthreads();
  for (int g = 0; g < P.n_grp; ++g) {
    const int* G = P.grp + g * G_STRIDE;
    const int K = G[G_K], mo = G[G_MO], n = G[G_DIM3] * mo;
    const float alpha = P.grp_alpha[g];
    const float* W = si2w + G[G_WOFF];
    const float* a = agg_s + G[G_AGG];
    for (int t = tid; t < n; t += NT) {
      const int p = t / mo, o = t - p * mo;
      const float* ap = a + p * K;
      float s = 0.f;
      for (int r = 0; r < K; ++r)
        s = fmaf(ap[r], __ldg(W + (long)r * mo + o), s);
      out_s[G[G_OUT] + p * mo + o] = s * alpha;
    }
  }
  __syncthreads();
  for (int i = tid; i < P.d_out; i += NT)
    out[(long)atom * P.d_out + i] = out_s[i];
}

__global__ void __launch_bounds__(NT)
fused_conv_fwd_kernel(const float* __restrict__ xg,
                      const float* __restrict__ sh,
                      const float* __restrict__ emb,
                      const float* __restrict__ ms,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ w2,
                      const float* __restrict__ si2w, Plan P,
                      float* __restrict__ out) {
  fwd_body<false>(xg, sh, emb, nullptr, ms, w0, w1, w2, si2w, P, Geom{}, out);
}

__global__ void __launch_bounds__(NT)
fused_conv_geom_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ vec,
                           const float* __restrict__ ms,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2,
                           const float* __restrict__ si2w, Plan P, Geom G,
                           float* __restrict__ out) {
  fwd_body<true>(xg, nullptr, nullptr, vec, ms, w0, w1, w2, si2w, P, G, out);
}

// backward of one atom's block. GEOM: the tile's dsh and demb rows stay in
// shared memory and leave as dvec through the geometry VJP.
template <bool GEOM>
__device__ __forceinline__ void bwd_body(const float* __restrict__ gout,
                                         const float* __restrict__ xg,
                                         const float* __restrict__ sh,
                                         const float* __restrict__ emb,
                                         const float* __restrict__ vec,
                                         const float* __restrict__ ms,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ w1t,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ w2t,
                                         const float* __restrict__ si2wt,
                                         const Plan& P, const Geom& G,
                                         float* __restrict__ dxg,
                                         float* __restrict__ dsh,
                                         float* __restrict__ demb,
                                         float* __restrict__ dvec) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  float* g_s = smem + table_words(P);        // d_out
  float* gm_s = g_s + P.d_out;               // agg_dim: si2^T g
  float* x_s = gm_s + P.agg_dim;             // RT_B * d1
  float* sh_s = x_s + RT_B * P.d1;           // RT_B * f
  float* emb_s = sh_s + RT_B * P.f;          // RT_B * nb
  float* ms_s = emb_s + RT_B * P.nb;         // RT_B
  float* h0_s = ms_s + RT_B;                 // RT_B * H (then dpre0)
  float* h1_s = h0_s + RT_B * H;             // RT_B * H (then dpre1)
  float* da0_s = h1_s + RT_B * H;            // RT_B * H
  float* da1_s = da0_s + RT_B * H;           // RT_B * H
  float* red_s = da1_s + RT_B * H;           // KQ * RT_B * H
  float* weff_s = red_s + KQ * RT_B * H;     // RT_B * n_active
  float* dw_s = weff_s + RT_B * P.n_active;  // RT_B * n_active
  float* vec_s = dw_s + RT_B * P.n_active;   // RT_B * 3 (GEOM only)
  float* dsh_s = vec_s + RT_B * 3;           // RT_B * f (GEOM only)
  float* demb_s = dsh_s + RT_B * P.f;        // RT_B * nb (GEOM only)

  const int atom = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  load_tables(P, ins_s, nzi_s, nzc_s);
  for (int i = tid; i < P.d_out; i += NT)
    g_s[i] = gout[(long)atom * P.d_out + i];
  __syncthreads();
  // message cotangent, once per atom: gm[p][r] = alpha * sum_o W[r,o] g[p,o]
  for (int g = 0; g < P.n_grp; ++g) {
    const int* G = P.grp + g * G_STRIDE;
    const int K = G[G_K], mo = G[G_MO], n = G[G_DIM3] * K;
    const float alpha = P.grp_alpha[g];
    const float* WT = si2wt + G[G_WOFF];   // (mo, K)
    for (int t = tid; t < n; t += NT) {
      const int p = t / K, r = t - p * K;
      const float* gp = g_s + G[G_OUT] + p * mo;
      float s = 0.f;
      for (int o = 0; o < mo; ++o)
        s = fmaf(__ldg(WT + (long)o * K + r), gp[o], s);
      gm_s[G[G_AGG] + p * K + r] = s * alpha;
    }
  }

  for (int t0 = 0; t0 < P.D; t0 += RT_B) {
    const int rows = min(RT_B, P.D - t0);
    const long row0 = (long)atom * P.D + t0;
    __syncthreads();
    load_rows(x_s, xg, row0, rows, P.d1);
    load_rows(ms_s, ms, row0, rows, 1);
    if constexpr (GEOM) {
      load_rows(vec_s, vec, row0, rows, 3);
      __syncthreads();
      geom_rows_fwd(P, G, rows, vec_s, emb_s, sh_s);
    } else {
      load_rows(sh_s, sh, row0, rows, P.f);
      load_rows(emb_s, emb, row0, rows, P.nb);
    }
    __syncthreads();
    mlp_hidden(P, rows, emb_s, w0, w1, h0_s, h1_s, da0_s, da1_s);

    // pass A, one thread per live column: w_eff and dw_rad
    for (int c = tid; c < P.n_active; c += NT) {
      const int* I = ins_s + P.col_ins[c] * I_STRIDE;
      const int u = c - I[I_COL0];
      const int mul = I[I_MUL], K = I[I_K], d3 = I[I_DIM3];
      const int col = P.col_w[c];
      float wc[H];
#pragma unroll
      for (int k = 0; k < H; ++k) wc[k] = __ldg(w2 + (long)k * P.wn + col);
      const float* gmb = gm_s + I[I_AGG] + u;
      for (int e = 0; e < rows; ++e) {
        const float m_e = ms_s[e];
        const float* xr = x_s + e * P.d1 + I[I_XOFF] + u;
        const float* sr = sh_s + e * P.f + I[I_SHOFF];
        float w = 0.f, dwe = 0.f;
        if (m_e != 0.f) {
          const float* hr = h1_s + e * H;
#pragma unroll
          for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
          w *= P.s2 * m_e;
          for (int p = 0; p < d3; ++p) {
            float s = 0.f;
            const int q1 = I[I_POFF + p + 1];
            for (int q = I[I_POFF + p]; q < q1; ++q) {
              const int id = nzi_s[q];
              s = fmaf(nzc_s[q] * xr[(id & 0xff) * mul],
                       sr[(id >> 8) & 0xff], s);
            }
            dwe = fmaf(gmb[p * K], s, dwe);
          }
        }
        weff_s[e * P.n_active + c] = w;
        dw_s[e * P.n_active + c] = dwe * m_e;
      }
    }
    __syncthreads();

    // pass B: dxg, one thread per (row, x column), summing every live
    // instruction that reads the column's x slice
    for (int idx = tid; idx < rows * P.d1; idx += NT) {
      const int e = idx / P.d1, xc = idx - e * P.d1;
      float v = 0.f;
      for (int xe = 0; xe < P.n_xent; ++xe) {
        const int* X = P.xent + xe * X_STRIDE;
        const int rel = xc - X[X_OFF];
        const int xmul = X[X_MUL];
        if (rel < 0 || rel >= xmul * X[X_DIM]) continue;
        const int m = rel / xmul, u = rel - m * xmul;
        for (int j = 0; j < X[X_NINS]; ++j) {
          const int* I = ins_s + P.xins[X[X_INS0] + j] * I_STRIDE;
          const float we = weff_s[e * P.n_active + I[I_COL0] + u];
          const float* gmb = gm_s + I[I_AGG] + u;
          const float* sr = sh_s + e * P.f + I[I_SHOFF];
          const int K = I[I_K];
          float s = 0.f;
          const int q1 = I[I_MOFF + m + 1];
          for (int q = I[I_MOFF + m]; q < q1; ++q) {
            const int id = nzi_s[q];
            s = fmaf(nzc_s[q] * gmb[(id >> 16) * K], sr[(id >> 8) & 0xff],
                     s);
          }
          v = fmaf(s, we, v);
        }
        break;
      }
      dxg[(row0 + e) * P.d1 + xc] = v;
    }
    // pass C: dsh, one warp per (row, sh column), lanes over the
    // channels of every live instruction that reads the column
    for (int item = warp; item < rows * P.f;
         item += NT / 32) {
      const int e = item / P.f, sc = item - e * P.f;
      float v = 0.f;
      for (int i = 0; i < P.n_ins; ++i) {
        const int* I = ins_s + i * I_STRIDE;
        const int n = sc - I[I_SHOFF];
        if (n < 0 || n >= I[I_DIM2]) continue;
        const int mul = I[I_MUL], K = I[I_K];
        const int q0 = I[I_NOFF + n], q1 = I[I_NOFF + n + 1];
        const float* xb = x_s + e * P.d1 + I[I_XOFF];
        const float* gmb = gm_s + I[I_AGG];
        const float* wb = weff_s + e * P.n_active + I[I_COL0];
        for (int u = lane; u < mul; u += 32) {
          float s = 0.f;
          for (int q = q0; q < q1; ++q) {
            const int id = nzi_s[q];
            s = fmaf(nzc_s[q] * gmb[(id >> 16) * K + u],
                     xb[(id & 0xff) * mul + u], s);
          }
          v = fmaf(s, wb[u], v);
        }
      }
      v = warp_sum(v);
      if (lane == 0) {
        if constexpr (GEOM) dsh_s[item] = v;
        else dsh[(row0 + e) * P.f + sc] = v;
      }
    }
    // pass D: dh1 = dw_rad @ w2^T, register-blocked over the tile's rows:
    // thread (q, k) sums columns q, q + KQ, ... for all RT_B rows, one w2^T
    // load per RT_B multiply-adds (lanes read consecutive k: coalesced)
    {
      const int k = tid % H, q = tid / H;
      float acc[RT_B];
#pragma unroll
      for (int e = 0; e < RT_B; ++e) acc[e] = 0.f;
      for (int c = q; c < P.n_active; c += KQ) {
        const float w = __ldg(w2t + (long)P.col_w[c] * H + k);
#pragma unroll
        for (int e = 0; e < RT_B; ++e)
          acc[e] = fmaf(dw_s[e * P.n_active + c], w, acc[e]);
      }
#pragma unroll
      for (int e = 0; e < RT_B; ++e) red_s[(q * RT_B + e) * H + k] = acc[e];
    }
    __syncthreads();
    // dpre1 = dh1 * act'(pre1), into h1_s (partials summed in fixed order)
    for (int idx = tid; idx < rows * H; idx += NT) {
      const int e = idx / H, k = idx - e * H;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) s += red_s[(q * RT_B + e) * H + k];
      h1_s[idx] = s * P.s2 * da1_s[idx];
    }
    __syncthreads();
    // pass E: dpre0 = (dpre1 @ w1^T) * act'(pre0), into h0_s; w1^T is read
    // with lanes on consecutive j
    for (int idx = tid; idx < rows * H; idx += NT) {
      const int e = idx / H, j = idx - e * H;
      const float* dr = h1_s + e * H;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) s = fmaf(dr[k], __ldg(w1t + k * H + j), s);
      h0_s[idx] = s * P.s1 * da0_s[idx];
    }
    __syncthreads();
    // pass F: demb = dpre0 @ w0^T, one warp per (row, basis) output
    for (int item = warp; item < rows * P.nb;
         item += NT / 32) {
      const int e = item / P.nb, b = item - e * P.nb;
      const float* dr = h0_s + e * H;
      const float* wr = w0 + b * H;
      float s = 0.f;
      for (int j = lane; j < H; j += 32) s = fmaf(dr[j], __ldg(wr + j), s);
      s = warp_sum(s);
      if (lane == 0) {
        if constexpr (GEOM) demb_s[item] = s * P.s0;
        else demb[(row0 + e) * P.nb + b] = s * P.s0;
      }
    }
    if constexpr (GEOM) {
      __syncthreads();
      geom_rows_bwd(P, G, rows, row0, vec_s, ms_s, demb_s, dsh_s, dvec);
    }
  }
}

// The backward kernels are held to two blocks per SM (128 registers). Left
// to itself ptxas has taken 173 (this kernel) and 193 (the geom one, with
// the sinf/cosf/powf slow paths inlined): one block per SM, and 1.5-1.6x
// the time.
__global__ void __launch_bounds__(NT, 2)
fused_conv_bwd_kernel(const float* __restrict__ gout,
                      const float* __restrict__ xg,
                      const float* __restrict__ sh,
                      const float* __restrict__ emb,
                      const float* __restrict__ ms,
                      const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ w1t,
                      const float* __restrict__ w2,
                      const float* __restrict__ w2t,
                      const float* __restrict__ si2wt, Plan P,
                      float* __restrict__ dxg, float* __restrict__ dsh,
                      float* __restrict__ demb) {
  bwd_body<false>(gout, xg, sh, emb, nullptr, ms, w0, w1, w1t, w2, w2t, si2wt,
                  P, Geom{}, dxg, dsh, demb, nullptr);
}

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
                           float* __restrict__ dxg,
                           float* __restrict__ dvec) {
  bwd_body<true>(gout, xg, nullptr, nullptr, vec, ms, w0, w1, w1t, w2, w2t,
                 si2wt, P, G, dxg, nullptr, nullptr, dvec);
}

Plan make_plan(const int* ins, const int* col_ins, const int* col_w,
               const int* nz_idx, const float* nz_coef, const int* grp,
               const float* grp_alpha, const int* xent, const int* xins,
               int n_atoms, int D, int d1, int f, int nb, int wn, int d_out,
               int n_ins, int n_active, int n_grp, int n_xent, int agg_dim,
               int n_nz, int act, float act_cst, float s0, float s1,
               float s2) {
  Plan P;
  P.ins = ins; P.col_ins = col_ins; P.col_w = col_w; P.nz_idx = nz_idx;
  P.nz_coef = nz_coef; P.grp = grp; P.grp_alpha = grp_alpha;
  P.xent = xent; P.xins = xins;
  P.n_atoms = n_atoms; P.D = D; P.d1 = d1; P.f = f; P.nb = nb; P.wn = wn;
  P.d_out = d_out; P.n_ins = n_ins; P.n_active = n_active;
  P.n_grp = n_grp; P.n_xent = n_xent; P.agg_dim = agg_dim; P.n_nz = n_nz;
  P.act = act; P.act_cst = act_cst; P.s0 = s0; P.s1 = s1; P.s2 = s2;
  return P;
}

size_t fwd_smem(const Plan& P, bool geom) {
  return sizeof(float) * ((size_t)table_words(P)
                          + (size_t)RT_F * (P.d1 + P.f + P.nb + 1 + 2 * H
                                            + (geom ? 3 : 0))
                          + P.agg_dim + P.d_out);
}

size_t bwd_smem(const Plan& P, bool geom) {
  return sizeof(float) * ((size_t)table_words(P) + P.d_out + P.agg_dim
                          + (size_t)RT_B * (P.d1 + P.f + P.nb + 1
                                            + (4 + KQ) * H
                                            + 2 * P.n_active
                                            + (geom ? 3 + P.f + P.nb : 0)));
}

}  // namespace

#define PLAN_ARGS                                                          \
  const int *ins, const int *col_ins, const int *col_w, const int *nz_idx, \
      const float *nz_coef, const int *grp, const float *grp_alpha,        \
      const int *xent, const int *xins, int n_atoms, int D, int d1, int f, \
      int nb, int wn, int d_out, int n_ins, int n_active, int n_grp,       \
      int n_xent, int agg_dim, int n_nz, int act, float act_cst, float s0, \
      float s1, float s2
#define PLAN_CALL                                                          \
  make_plan(ins, col_ins, col_w, nz_idx, nz_coef, grp, grp_alpha, xent,    \
            xins, n_atoms, D, d1, f, nb, wn, d_out, n_ins, n_active,       \
            n_grp, n_xent, agg_dim, n_nz, act, act_cst, s0, s1, s2)

// raise a kernel's dynamic shared-memory limit on the current device
// only when a launch needs more than it was last given
constexpr int MAX_DEVICES = 64;
static size_t fwd_reserved[MAX_DEVICES], bwd_reserved[MAX_DEVICES],
    geom_fwd_reserved[MAX_DEVICES], geom_bwd_reserved[MAX_DEVICES];

template <typename Kernel>
static cudaError_t reserve_smem(Kernel kernel, size_t bytes,
                                size_t* reserved) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= reserved[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) reserved[dev] = bytes;
  return err;
}

extern "C" int fused_conv_fwd(const float* xg, const float* sh,
                              const float* emb, const float* ms,
                              const float* w0, const float* w1,
                              const float* w2, const float* si2w,
                              PLAN_ARGS, float* out, void* stream) {
  const Plan P = PLAN_CALL;
  const size_t smem = fwd_smem(P, false);
  const cudaError_t err =
      reserve_smem(fused_conv_fwd_kernel, smem, fwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_fwd_kernel<<<P.n_atoms, NT, smem, (cudaStream_t)stream>>>(
        xg, sh, emb, ms, w0, w1, w2, si2w, P, out);
  return (int)cudaGetLastError();
}

extern "C" int fused_conv_bwd(const float* g, const float* xg,
                              const float* sh, const float* emb,
                              const float* ms, const float* w0,
                              const float* w1, const float* w1t,
                              const float* w2, const float* w2t,
                              const float* si2wt, PLAN_ARGS, float* dxg,
                              float* dsh, float* demb, void* stream) {
  const Plan P = PLAN_CALL;
  const size_t smem = bwd_smem(P, false);
  const cudaError_t err =
      reserve_smem(fused_conv_bwd_kernel, smem, bwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_bwd_kernel<<<P.n_atoms, NT, smem, (cudaStream_t)stream>>>(
        g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2wt, P, dxg, dsh, demb);
  return (int)cudaGetLastError();
}

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

extern "C" int fused_conv_geom_fwd(const float* xg, const float* vec,
                                   const float* ms, const float* w0,
                                   const float* w1, const float* w2,
                                   const float* si2w, PLAN_ARGS, GEOM_ARGS,
                                   float* out, void* stream) {
  const Plan P = PLAN_CALL;
  const Geom G = GEOM_CALL;
  const size_t smem = fwd_smem(P, true);
  const cudaError_t err =
      reserve_smem(fused_conv_geom_fwd_kernel, smem, geom_fwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_geom_fwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        xg, vec, ms, w0, w1, w2, si2w, P, G, out);
  return (int)cudaGetLastError();
}

extern "C" int fused_conv_geom_bwd(const float* g, const float* xg,
                                   const float* vec, const float* ms,
                                   const float* w0, const float* w1,
                                   const float* w1t, const float* w2,
                                   const float* w2t, const float* si2wt,
                                   PLAN_ARGS, GEOM_ARGS, float* dxg,
                                   float* dvec, void* stream) {
  const Plan P = PLAN_CALL;
  const Geom G = GEOM_CALL;
  const size_t smem = bwd_smem(P, true);
  const cudaError_t err =
      reserve_smem(fused_conv_geom_bwd_kernel, smem, geom_bwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_geom_bwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        g, xg, vec, ms, w0, w1, w1t, w2, w2t, si2wt, P, G, dxg, dvec);
  return (int)cudaGetLastError();
}
