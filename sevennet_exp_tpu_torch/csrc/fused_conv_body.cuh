// Device bodies of the fused convolution kernels and their host-side plan
// helpers, shared by fused_conv.cu (the kernels of the model) and
// bench_pieces.cu (the same forward body with pieces stubbed, for the
// per-piece micro-benchmark). See fused_conv.cu for what the kernels
// compute and how they are laid out. fused_conv_geom.cu (the
// geometry-fused pair) takes the plan, the table layout and the small
// helpers from here, not the bodies.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;       // radial MLP hidden width
constexpr int NT = 256;     // threads per block
constexpr int RT_F = 32;    // forward rows per tile
constexpr int RT_B = 8;     // backward rows per tile
constexpr int RT_E = 8;     // edge-row forward: rows per block
constexpr int RT_EB = 4;    // edge-row backward: rows per block
constexpr int MAXD = 8;     // offsets per key in an instruction record
constexpr int KQ = NT / H;  // column groups of the backward's dw @ w2^T

// what a kernel body takes per row: sh + emb (the MLP runs in the kernel),
// or sh + ready-made weights (no MLP)
// M_EDGE takes what M_PLAIN takes and returns one row per input row (the
// plain edge list: si2 per row, no sum over rows)
constexpr int M_PLAIN = 0, M_EXTW = 2, M_EDGE = 3;

// pieces of the M_PLAIN forward that bench_pieces.cu replaces by stand-ins
// (SKIP of fwd_body; 0, every kernel of the model, runs them all):
//   S_MLP  the radial weight is emb[:, 0] * ms (no MLP)
//   S_CG   each component's CG sum is the instruction's x entry m = 0
//   S_W    the weight is computed (and tested for NaN, so that the MLP
//          stays) but not multiplied in
//   S_SI2  the aggregate goes straight to the output, truncated or padded
constexpr int S_MLP = 1, S_CG = 2, S_W = 4, S_SI2 = 8;

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
  long n_rows;           // n_atoms * D, less in the last block of M_EDGE
  int n_ins, n_active, n_grp, n_xent, agg_dim, n_nz;
  int act;               // 0 silu, 1 tanh
  float act_cst, s0, s1, s2;   // normalize2mom constant, 1/sqrt(fan-in)
};

// words of shared memory the instruction and CG tables take, rounded up so
// that what follows is aligned to 16 bytes
__host__ __device__ inline int table_words(const Plan& P) {
  return (P.n_ins * I_STRIDE + 2 * P.n_nz + 3) & ~3;
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

// forward of one atom's block. M_EXTW: no MLP; the row weights are read
// from weff. SKIP (M_PLAIN only): the S_* pieces replaced by their
// stand-ins.
template <int MODE, int SKIP = 0>
__device__ __forceinline__ void fwd_body(const float* __restrict__ xg,
                                         const float* __restrict__ sh,
                                         const float* __restrict__ emb,
                                         const float* __restrict__ ms,
                                         const float* __restrict__ weff,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ si2w,
                                         const Plan& P,
                                         float* __restrict__ out) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  constexpr bool EDGE = MODE == M_EDGE;
  constexpr int RT = EDGE ? RT_E : RT_F;     // rows per tile
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) { float* q = next_s; next_s += n; return q; };
  // M_EDGE: one aggregate per row, row-minor (entry i of row e at i * RT + e)
  const int agg_words = EDGE ? RT * P.agg_dim : P.agg_dim;
  float* agg_s = take(agg_words);
  float* out_s = take(EDGE ? 0 : P.d_out);
  float* x_s = take(RT * P.d1);
  float* sh_s = take(RT * P.f);
  float *emb_s = nullptr, *ms_s = nullptr, *h0_s = nullptr, *h1_s = nullptr;
  if constexpr (MODE != M_EXTW) {
    emb_s = take(RT * P.nb);
    ms_s = take(RT);
    h0_s = take(RT * H);
    h1_s = take(RT * H);
  }

  const int atom = blockIdx.x;
  const int tid = threadIdx.x;
  load_tables(P, ins_s, nzi_s, nzc_s);
  for (int i = tid; i < agg_words; i += NT) agg_s[i] = 0.f;

  for (int t0 = 0; t0 < P.D; t0 += RT) {
    const long row0 = (long)atom * P.D + t0;
    const int rows = (int)min((long)min(RT, P.D - t0), P.n_rows - row0);
    __syncthreads();
    load_rows(x_s, xg, row0, rows, P.d1);
    if constexpr (MODE == M_EXTW) {
      load_rows(sh_s, sh, row0, rows, P.f);
      __syncthreads();
    } else {
      load_rows(ms_s, ms, row0, rows, 1);
      load_rows(sh_s, sh, row0, rows, P.f);
      load_rows(emb_s, emb, row0, rows, P.nb);
      __syncthreads();
      if constexpr (!(SKIP & S_MLP))
        mlp_hidden(P, rows, emb_s, w0, w1, h0_s, h1_s, nullptr, nullptr);
    }

    for (int c = tid; c < P.n_active; c += NT) {
      const int* I = ins_s + P.col_ins[c] * I_STRIDE;
      const int u = c - I[I_COL0];
      const int mul = I[I_MUL], K = I[I_K], d3 = I[I_DIM3];
      const int col = P.col_w[c];
      float wc[MODE == M_EXTW ? 1 : H];
      const float* wg = nullptr;     // this column of the tile's weff rows
      float w_next = 0.f;
      if constexpr (MODE == M_EXTW) {
        wg = weff + row0 * P.wn + col;
        w_next = __ldg(wg);
      } else if constexpr (!(SKIP & S_MLP)) {
#pragma unroll
        for (int k = 0; k < H; ++k) wc[k] = __ldg(w2 + (long)k * P.wn + col);
      }
      const float* xb = x_s + I[I_XOFF] + u;
      const float* sb = sh_s + I[I_SHOFF];
      float* ab = agg_s + (I[I_AGG] + u) * (EDGE ? RT : 1);
      for (int e = 0; e < rows; ++e) {
        float w = 0.f;
        if constexpr (MODE == M_EXTW) {
          // the next row's weight is in flight while this row's CG runs
          w = w_next;
          if (e + 1 < rows) w_next = __ldg(wg + (long)(e + 1) * P.wn);
          if (w == 0.f) continue;   // pad row (or no weight): no message
        } else {
          const float m_e = ms_s[e];
          if (m_e == 0.f) continue;          // grid pad row: no message
          if constexpr (SKIP & S_MLP) {
            w = emb_s[e * P.nb] * m_e;
          } else {
            const float* hr = h1_s + e * H;
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
            w *= P.s2 * m_e;
          }
          if constexpr (SKIP & S_W) {
            if (w != w) continue;
          }
        }
        const float* xr = xb + e * P.d1;
        const float* sr = sb + e * P.f;
        for (int p = 0; p < d3; ++p) {
          float s = 0.f;
          if constexpr (SKIP & S_CG) {
            s = xr[0];
          } else {
            const int q1 = I[I_POFF + p + 1];
            for (int q = I[I_POFF + p]; q < q1; ++q) {
              const int id = nzi_s[q];
              s = fmaf(nzc_s[q] * xr[(id & 0xff) * mul], sr[(id >> 8) & 0xff],
                       s);
            }
          }
          if constexpr (EDGE) ab[p * K * RT + e] = w * s;
          else if constexpr (SKIP & S_W) ab[p * K] += s;
          else ab[p * K] += w * s;
        }
      }
    }
  }
  __syncthreads();

  if constexpr (EDGE) {
    // self-interaction 2 per row: a thread owns one output column of every
    // row of the block, so a weight is read once for RT rows
    const long row0 = (long)atom * P.D;
    const int rows = (int)min((long)P.D, P.n_rows - row0);
    // output columns that no si2 path feeds are zeros
    for (int i = tid; i < rows * P.d_out; i += NT)
      out[row0 * P.d_out + i] = 0.f;
    __syncthreads();
    for (int g = 0; g < P.n_grp; ++g) {
      const int* G = P.grp + g * G_STRIDE;
      const int K = G[G_K], mo = G[G_MO], n = G[G_DIM3] * mo;
      const float alpha = P.grp_alpha[g];
      const float* W = si2w + G[G_WOFF];
      for (int t = tid; t < n; t += NT) {
        const int p = t / mo, o = t - p * mo;
        const float4* a4 = reinterpret_cast<const float4*>(
            agg_s + (long)(G[G_AGG] + p * K) * RT);
        float acc[RT];
#pragma unroll
        for (int e = 0; e < RT; ++e) acc[e] = 0.f;
        for (int r = 0; r < K; ++r) {
          const float w = __ldg(W + (long)r * mo + o);
#pragma unroll
          for (int h = 0; h < RT / 4; ++h) {
            const float4 a = a4[r * (RT / 4) + h];
            acc[4 * h] = fmaf(a.x, w, acc[4 * h]);
            acc[4 * h + 1] = fmaf(a.y, w, acc[4 * h + 1]);
            acc[4 * h + 2] = fmaf(a.z, w, acc[4 * h + 2]);
            acc[4 * h + 3] = fmaf(a.w, w, acc[4 * h + 3]);
          }
        }
#pragma unroll
        for (int e = 0; e < RT; ++e)
          if (e < rows)
            out[(row0 + e) * P.d_out + G[G_OUT] + p * mo + o] = acc[e] * alpha;
      }
    }
    return;
  }

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
      if constexpr (SKIP & S_SI2) {
        out_s[G[G_OUT] + p * mo + o] = o < K ? ap[o] : 0.f;
        continue;
      }
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

// backward of one atom's block. M_EXTW: the row weights come from weff, the
// backward ends at dweff (no MLP to run back through); dead_w lists the
// n_dead weight columns no live instruction reads.
template <int MODE>
__device__ __forceinline__ void bwd_body(const float* __restrict__ gout,
                                         const float* __restrict__ xg,
                                         const float* __restrict__ sh,
                                         const float* __restrict__ emb,
                                         const float* __restrict__ ms,
                                         const float* __restrict__ weff,
                                         const float* __restrict__ w0,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ w1t,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ w2t,
                                         const float* __restrict__ si2wt,
                                         const Plan& P,
                                         const int* __restrict__ dead_w,
                                         int n_dead,
                                         float* __restrict__ dxg,
                                         float* __restrict__ dsh,
                                         float* __restrict__ demb,
                                         float* __restrict__ dweff) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);       // n_ins * I_STRIDE
  int* nzi_s = ins_s + P.n_ins * I_STRIDE;         // n_nz
  float* nzc_s = reinterpret_cast<float*>(nzi_s + P.n_nz);   // n_nz
  constexpr bool EDGE = MODE == M_EDGE;
  constexpr int RT = EDGE ? RT_EB : RT_B;    // rows per tile
  float* next_s = smem + table_words(P);
  auto take = [&next_s](int n) { float* q = next_s; next_s += n; return q; };
  // M_EDGE: one cotangent per row: g row-minor (entry i of row e at
  // i * RT + e), gm row by row (row e at e * agg_dim)
  float* g_s = take(EDGE ? RT * P.d_out : P.d_out);
  float* gm_s = take(EDGE ? RT * P.agg_dim : P.agg_dim);   // si2^T g
  const int gs = EDGE ? P.agg_dim : 0;       // gm stride from row to row
  float* x_s = take(RT * P.d1);
  float* sh_s = take(RT * P.f);
  float *emb_s = nullptr, *h0_s = nullptr, *h1_s = nullptr, *da0_s = nullptr,
        *da1_s = nullptr, *red_s = nullptr, *dw_s = nullptr;
  if constexpr (MODE != M_EXTW) emb_s = take(RT * P.nb);
  float* ms_s = take(RT);      // M_EXTW: 1 where a row has a nonzero weight
  if constexpr (MODE != M_EXTW) {
    h0_s = take(RT * H);                   // then dpre0
    h1_s = take(RT * H);                   // then dpre1
    da0_s = take(RT * H);
    da1_s = take(RT * H);
    red_s = take(KQ * RT * H);
  }
  float* weff_s = take(RT * P.n_active);
  if constexpr (MODE != M_EXTW) dw_s = take(RT * P.n_active);

  const int atom = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  load_tables(P, ins_s, nzi_s, nzc_s);
  if constexpr (EDGE) {
    const long r0 = (long)atom * P.D;
    for (int i = tid; i < RT * P.d_out; i += NT) {
      const int e = i / P.d_out, c = i - e * P.d_out;
      g_s[c * RT + e] =
          r0 + e < P.n_rows ? gout[(r0 + e) * P.d_out + c] : 0.f;
    }
  } else {
    for (int i = tid; i < P.d_out; i += NT)
      g_s[i] = gout[(long)atom * P.d_out + i];
  }
  __syncthreads();
  // message cotangent, once per atom: gm[p][r] = alpha * sum_o W[r,o] g[p,o]
  // (M_EDGE: once per row, a weight read once for the block's RT rows)
  if constexpr (EDGE) {
    for (int g = 0; g < P.n_grp; ++g) {
      const int* G = P.grp + g * G_STRIDE;
      const int K = G[G_K], mo = G[G_MO], n = G[G_DIM3] * K;
      const float alpha = P.grp_alpha[g];
      const float* WT = si2wt + G[G_WOFF];   // (mo, K)
      for (int t = tid; t < n; t += NT) {
        const int p = t / K, r = t - p * K;
        const float4* g4 = reinterpret_cast<const float4*>(
            g_s + (long)(G[G_OUT] + p * mo) * RT);
        float acc[RT];
#pragma unroll
        for (int e = 0; e < RT; ++e) acc[e] = 0.f;
        for (int o = 0; o < mo; ++o) {
          const float w = __ldg(WT + (long)o * K + r);
#pragma unroll
          for (int h = 0; h < RT / 4; ++h) {
            const float4 a = g4[o * (RT / 4) + h];
            acc[4 * h] = fmaf(a.x, w, acc[4 * h]);
            acc[4 * h + 1] = fmaf(a.y, w, acc[4 * h + 1]);
            acc[4 * h + 2] = fmaf(a.z, w, acc[4 * h + 2]);
            acc[4 * h + 3] = fmaf(a.w, w, acc[4 * h + 3]);
          }
        }
#pragma unroll
        for (int e = 0; e < RT; ++e)
          gm_s[e * gs + G[G_AGG] + p * K + r] = acc[e] * alpha;
      }
    }
  } else {
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
  }

  for (int t0 = 0; t0 < P.D; t0 += RT) {
    const long row0 = (long)atom * P.D + t0;
    const int rows = (int)min((long)min(RT, P.D - t0), P.n_rows - row0);
    __syncthreads();
    load_rows(x_s, xg, row0, rows, P.d1);
    if constexpr (MODE == M_EXTW) {
      load_rows(sh_s, sh, row0, rows, P.f);
      if (tid < RT) ms_s[tid] = 0.f;
      __syncthreads();
      // stage the tile's live weights, coalesced over the columns, and
      // mark the rows that have any (a benign race: every writer stores 1)
      for (int i = tid; i < rows * P.n_active; i += NT) {
        const int e = i / P.n_active, c = i - e * P.n_active;
        const float w = __ldg(weff + (row0 + e) * P.wn + P.col_w[c]);
        weff_s[i] = w;
        if (w != 0.f) ms_s[e] = 1.f;
      }
      for (int i = tid; i < rows * n_dead; i += NT) {
        const int e = i / n_dead;
        dweff[(row0 + e) * P.wn + dead_w[i - e * n_dead]] = 0.f;
      }
      __syncthreads();
    } else {
      load_rows(ms_s, ms, row0, rows, 1);
      load_rows(sh_s, sh, row0, rows, P.f);
      load_rows(emb_s, emb, row0, rows, P.nb);
      __syncthreads();
      mlp_hidden(P, rows, emb_s, w0, w1, h0_s, h1_s, da0_s, da1_s);
    }

    // pass A, one thread per live column: w_eff and dw_rad (M_EXTW: dweff,
    // straight to global memory)
    for (int c = tid; c < P.n_active; c += NT) {
      const int* I = ins_s + P.col_ins[c] * I_STRIDE;
      const int u = c - I[I_COL0];
      const int mul = I[I_MUL], K = I[I_K], d3 = I[I_DIM3];
      const int col = P.col_w[c];
      float wc[MODE == M_EXTW ? 1 : H];
      if constexpr (MODE != M_EXTW) {
#pragma unroll
        for (int k = 0; k < H; ++k) wc[k] = __ldg(w2 + (long)k * P.wn + col);
      }
      const float* gmb = gm_s + I[I_AGG] + u;
      for (int e = 0; e < rows; ++e) {
        const float m_e = ms_s[e];
        const float* xr = x_s + e * P.d1 + I[I_XOFF] + u;
        const float* sr = sh_s + e * P.f + I[I_SHOFF];
        float w = 0.f, dwe = 0.f;
        if (m_e != 0.f) {
          if constexpr (MODE != M_EXTW) {
            const float* hr = h1_s + e * H;
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
            w *= P.s2 * m_e;
          }
          for (int p = 0; p < d3; ++p) {
            float s = 0.f;
            const int q1 = I[I_POFF + p + 1];
            for (int q = I[I_POFF + p]; q < q1; ++q) {
              const int id = nzi_s[q];
              s = fmaf(nzc_s[q] * xr[(id & 0xff) * mul],
                       sr[(id >> 8) & 0xff], s);
            }
            dwe = fmaf(gmb[e * gs + p * K], s, dwe);
          }
        }
        if constexpr (MODE == M_EXTW) {
          dweff[(row0 + e) * P.wn + col] = dwe;
        } else {
          weff_s[e * P.n_active + c] = w;
          dw_s[e * P.n_active + c] = dwe * m_e;
        }
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
            s = fmaf(nzc_s[q] * gmb[e * gs + (id >> 16) * K],
                     sr[(id >> 8) & 0xff], s);
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
            s = fmaf(nzc_s[q] * gmb[e * gs + (id >> 16) * K + u],
                     xb[(id & 0xff) * mul + u], s);
          }
          v = fmaf(s, wb[u], v);
        }
      }
      v = warp_sum(v);
      if (lane == 0) dsh[(row0 + e) * P.f + sc] = v;
    }
    if constexpr (MODE == M_EXTW) continue;   // no MLP to run back through
    // pass D: dh1 = dw_rad @ w2^T, register-blocked over the tile's rows:
    // thread (q, k) sums columns q, q + KQ, ... for all RT rows, one w2^T
    // load per RT multiply-adds (lanes read consecutive k: coalesced)
    {
      const int k = tid % H, q = tid / H;
      float acc[RT];
#pragma unroll
      for (int e = 0; e < RT; ++e) acc[e] = 0.f;
      for (int c = q; c < P.n_active; c += KQ) {
        const float w = __ldg(w2t + (long)P.col_w[c] * H + k);
#pragma unroll
        for (int e = 0; e < RT; ++e)
          acc[e] = fmaf(dw_s[e * P.n_active + c], w, acc[e]);
      }
#pragma unroll
      for (int e = 0; e < RT; ++e) red_s[(q * RT + e) * H + k] = acc[e];
    }
    __syncthreads();
    // dpre1 = dh1 * act'(pre1), into h1_s (partials summed in fixed order)
    for (int idx = tid; idx < rows * H; idx += NT) {
      const int e = idx / H, k = idx - e * H;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < KQ; ++q) s += red_s[(q * RT + e) * H + k];
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
      if (lane == 0) demb[(row0 + e) * P.nb + b] = s * P.s0;
    }
  }
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
  P.n_rows = (long)n_atoms * D;
  P.n_atoms = n_atoms; P.D = D; P.d1 = d1; P.f = f; P.nb = nb; P.wn = wn;
  P.d_out = d_out; P.n_ins = n_ins; P.n_active = n_active;
  P.n_grp = n_grp; P.n_xent = n_xent; P.agg_dim = agg_dim; P.n_nz = n_nz;
  P.act = act; P.act_cst = act_cst; P.s0 = s0; P.s1 = s1; P.s2 = s2;
  return P;
}

size_t fwd_smem(const Plan& P, int mode) {
  const size_t rt = mode == M_EDGE ? RT_E : RT_F;
  return sizeof(float) * ((size_t)table_words(P)
                          + rt * (P.d1 + P.f
                                  + (mode != M_EXTW ? P.nb + 1 + 2 * H : 0))
                          + (mode == M_EDGE ? rt * P.agg_dim
                                            : P.agg_dim + P.d_out));
}

size_t bwd_smem(const Plan& P, int mode) {
  const size_t rt = mode == M_EDGE ? RT_EB : RT_B;
  return sizeof(float) * ((size_t)table_words(P)
                          + (mode == M_EDGE ? rt : 1) * (P.d_out + P.agg_dim)
                          + rt * (P.d1 + P.f + 1 + P.n_active
                                  + (mode != M_EXTW
                                         ? P.nb + (4 + KQ) * H + P.n_active
                                         : 0)));
}

// M_EDGE: P comes in as one row per block; regroup it to `rt` rows per block
Plan edge_plan(Plan P, int rt) {
  P.n_rows = (long)P.n_atoms * P.D;
  P.D = rt;
  P.n_atoms = (int)((P.n_rows + rt - 1) / rt);
  return P;
}

// raise a kernel's dynamic shared-memory limit on the current device
// only when a launch needs more than it was last given (reserved: one
// entry per device, kept by the caller per kernel)
constexpr int MAX_DEVICES = 64;


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
