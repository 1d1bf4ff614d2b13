// Fused convolution block, the independent "terms" derivation, forward and
// force backward, for NVIDIA Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_terms_fwd <- make_fused_conv(...) under set_cg_mode('terms'):
//                           fwd_kernel (_cg_acc, _mlp_forward)
//   fused_conv_terms_bwd <- the same, bwd_kernel (_act_grad)
//
// It computes what kernels 1-2 (csrc/fused_conv_geom.cu) compute and shares
// no code and no table with them: it exists to cross-check them. Per row e:
//   w[e]   = MLP(emb[e]) * ms[e]                 radial MLP nb -> 64 -> 64 -> wn
//   msg[e] = uvu tensor product of xg[e] and sh[e] weighted by w[e], laid
//            out exactly as UVUTensorProductSpec.apply returns it (entry k
//            at msg_off, component p, channel u at msg_off + p*mul + u)
//   y[i]   = si2(sum of msg over the `group` rows of output row i)
// si2 reads the flat message the way LinearSpec.apply does: the slice of
// input entry i as a (dim, mi) row-major matrix times its (mi, mo) weight.
// With group = D (the dense neighbor grid) an output row is an atom; with
// group = 1 (agg_d = 0, the plain edge list) every row has its own output.
// The backward recomputes the MLP and returns dxg, dsh, demb; weights and the
// mask scale get no gradient. Rows with ms == 0 (pads) contribute nothing and
// get zero gradients; output columns no si2 path feeds are zeros. An si2
// input entry that feeds several output entries is refused on the host
// (ops/fused_conv_terms.py, si2_unsupported): the plan keeps one path per
// input entry.
//
// What "terms" means here: on the TPU the mode is a Python-unrolled list of
// (m, n, p, c) products with the coefficients as immediates. Here the list
// sits in __constant__ memory and both kernels fold it once per row (the
// forward, into the SH) or per output row (the backward, into the message
// cotangent), so the run-time indexing of its operands is paid once per
// (row, instruction), where kernels 1-2 unroll the CG per (l1, l2, l3).
//
// What bounds it on this card: operations, like kernels 1-2 (a mid layer does
// ~37k multiply-adds of MLP output layer, ~5k of CG and, at agg_d = 0, ~107k
// of si2 per row against ~2 kB of input; the backward twice the MLP's).
//
// The forward, redesigned for this card (its first design, a block per
// atom or per 8 rows, the MLP's output layer with a load per 8
// multiply-adds, the CG term by term with two run-time-indexed shared loads
// per term and row, si2 a thread per column, ran at ~6 % of its bound):
//  - The SH is folded into the CG once per row and live instruction,
//    B_a[m][p] = sum of c sh[n] over a's terms (m, n, p, c), by items
//    (instruction, p, row) whose lanes walk a term run of the constant pool;
//    then msg_p[u] = w_a[u] sum_m B_a[m][p] x_m[u] is a dense D1 x D3
//    product per channel in registers, one instance per (l1, l3), x loaded
//    once a row and B by 16-byte broadcasts.
//  - The w pass is the backward's (w_pass: 4 columns x R rows of sums a
//    thread, one 16-byte load of w2's packed live columns per 4R
//    multiply-adds).
//  - Tiles of 16 rows (8 at agg_d = 0 where a mid layer's 16 rows of
//    messages do not fit two blocks an SM), a persistent grid.
//  - At agg_d = D each CG unit sums its row group's rows in registers and
//    adds them to the group's partial message; an atom's partials are
//    summed in a fixed order and si2 runs once per atom (the backward's gm
//    product on the path table with rows and columns swapped). At
//    agg_d = 0 si2 is a product over the tile's rows (~107k multiply-adds
//    a mid-layer row, si2_rows): a thread holds 8 rows x 4 output columns,
//    a warp reads whole rows of W by 16-byte loads, once a tile, and the
//    rows' message elements by broadcasts.
//
// The backward, redesigned for this card (its first design, table-driven
// with every operand in shared memory, 8-row tiles and one block per atom,
// ran at ~5 % of its bound; the stubbed passes of tools/bwd_passes.py showed
// where). What this design does:
//  - The CG is folded with the message cotangent. Per output row and live
//    instruction a, a thread per channel u runs a's terms from the constant
//    pool once: Q_a[m][n][u] = sum of c gm[p][u] over the terms (m, n, p, c)
//    (shared memory). Per row the backward is then a dense product in
//    registers, T_m = sum_n Q_mn sh_n and V_n = sum_m Q_mn x_m, giving
//    dw = x . T, dx_m += w T_m and dsh_n += w V_n. At agg_d = D an atom's
//    rows share gm, so Q is built once for D rows; at agg_d = 0 once a row.
//  - CG items are (x entry, row, channel): a thread loads x of its channel
//    once, runs every live instruction that reads the entry and keeps dx in
//    registers (dxg written once); dsh is kept per SH component for all
//    instructions and summed over the warp's channels once per item by
//    recursive halving (16 values, 16 shuffles). The SH operands sit at
//    l2^2 in registers, so the pair takes filters 1x0+1x1+... of l <= 3
//    (ops/fused_conv_terms.py refuses others).
//  - The two 64 x (live columns) products are register-blocked: the w pass
//    holds 4 columns x R rows of sums (one 16-byte load of the packed live
//    columns of w2 per 4R multiply-adds, the hidden rows made minor so that
//    one 16-byte shared load serves 4 rows); pass D (dw @ w2^T) holds 2
//    hidden units x 8 rows over a quarter of the columns, per 4 columns
//    four 8-byte loads of w2^T and 8 broadcast 16-byte loads of dw.
//  - Tiles of 16 rows (two an atom at D = 32) at two blocks an SM, and a
//    persistent grid (SMs x blocks an SM) walking the atoms or tiles.
//  - At agg_d = 0 gm = alpha W^T g of the tile's 8 rows is one product: a
//    thread holds 8 rows x 4 entries of sums, one 16-byte load of W^T per 32
//    multiply-adds, the rows' g row-minor.
// No atomics anywhere: results are reproducible bit for bit. CUDA-core fp32
// FMA only, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;            // radial MLP hidden width
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int TERM_POOL = 4096;  // CG terms all loaded plans may hold

// term: m | n << 8 | p << 16, and its coefficient
__constant__ int c_idx[TERM_POOL];
__constant__ float c_coef[TERM_POOL];

// the layer's launch: the CG units (the plan's slices: live instruction,
// first of its 32 channels), the si2 paths' alphas, the shapes
struct Args {
  const int* slices;        // n_slices * 2: live instruction, first channel
  const float* path_alpha;  // n_paths
  int n_slices, n_live, n_paths;   // units; live MLP columns; si2 paths
  long n_rows;
  int group;                // input rows per output row
  int d1, f, nb, d_out;
  int act;                  // 0 silu, 1 tanh, 2 ssp
  float act_cst, s0, s1, s2;
};

// ssp(x) = softplus(x) - ln 2 (the shifted softplus), its derivative the
// sigmoid
__device__ __forceinline__ float act_f(float x, int act) {
  if (act == 0) return x / (1.f + expf(-x));
  if (act == 2)
    return fmaxf(x, 0.f) + logf(1.f + expf(-fabsf(x)))
           - 0.693147180559945309f;
  return tanhf(x);
}

__device__ __forceinline__ float act_df(float x, int act) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-x));
    return s + x * s * (1.f - s);
  }
  if (act == 2) return 1.f / (1.f + expf(-x));
  const float t = tanhf(x);
  return 1.f - t * t;
}

// ---------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------

constexpr int SHS = 16;      // sh row stride in shared memory (f <= 16)
constexpr int KS = 4;        // pass D: parts of the live columns

// backward instruction record (int32), live instructions in plan order: x
// offset, mul, l1, l2 (the SH block sits at l2^2), first live column, offset
// in the compact message cotangent, offset of Q, backward terms [TB0, TB1)
// of the pool
enum {
  B_XOFF = 0, B_MUL, B_L1, B_L2, B_COL0, B_CM, B_Q, B_TB0, B_TB1, B_STRIDE
};
// x entry (i1 class) record: first CG item, lanes a row takes (32, or mul
// when mul is not a multiple of 32), channel groups of `lanes` a row, x
// offset, mul, l1, users, first user in the user list
enum {
  X_START = 0, X_LANES, X_GROUPS, X_XOFF, X_MUL, X_L1, X_NU, X_U0, X_STRIDE
};
// si2 path record: offset of its input entry in the compact message, mi,
// mo, components, offset in the output row, offset in the flat W^T
enum { G_CIN = 0, G_MI, G_MO, G_DIM, G_OUT, G_W, G_STRIDE };

struct BArgs {
  const int* bins;      // n_bins * B_STRIDE
  const int* xcls;      // n_x * X_STRIDE
  const int* users;     // n_users: the live instructions of each x entry
  const int* gpaths;    // n_paths * G_STRIDE
  int n_bins, n_x, n_users;
  int n_msg;            // live message elements (the compact cotangent)
  int n_q;              // words of Q
  int nls;              // live columns rounded up to 4 (row stride of w)
  int n_items;          // CG items of one tile (AGG) or one row
  int T, R;             // rows per tile; rows per item of the w pass
};

// word offsets of the backward's shared buffers (host and device)
struct BLay {
  int bins, xcls, users, gp, g, gm, q, w, h0, h1, dshp, d0, d1, sh, emb, ms,
      dsh, total;
};

__host__ __device__ inline int r4i(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int maxi(int a, int b) { return a > b ? a : b; }

// AGG: g and gm are one output row's; else g (row-minor, c * T + e) shares
// w's words (it is consumed before the w pass) and gm holds T rows. The
// pass-D partials take the words of h0, h1 and the dsh partials.
__host__ __device__ inline BLay bwd_layout(const Args& A, const BArgs& B,
                                           bool agg) {
  const int T = B.T, tcg = agg ? T : 1;
  BLay L;
  int o = 0;
  L.bins = o; o += r4i(B.n_bins * B_STRIDE);
  L.xcls = o; o += r4i(B.n_x * X_STRIDE);
  L.users = o; o += r4i(B.n_users);
  L.gp = o; o += r4i(A.n_paths * G_STRIDE);
  if (agg) {
    L.g = o; o += r4i(A.d_out);
    L.w = o; o += T * B.nls;
  } else {
    L.g = L.w = o; o += maxi(T * B.nls, T * r4i(A.d_out));
  }
  L.gm = o; o += r4i((agg ? 1 : T) * B.n_msg);
  L.q = o; o += r4i(B.n_q);
  L.h0 = o; L.h1 = o + H * T; L.dshp = o + 2 * H * T;
  o += maxi(2 * H * T + NW * tcg * SHS, KS * H * T);
  L.d0 = o; o += H * T;
  L.d1 = o; o += H * T;
  L.sh = o; o += T * SHS;
  L.emb = o; o += r4i(A.nb * T);
  L.ms = o; o += r4i(T);
  L.dsh = o; o += agg ? T * SHS : 0;   // else each row's dsh is stored
  L.total = o;
  return L;
}

// gm = alpha W^T g of rows [0, groups * RB) of a tile, handed to
// put(row, entry, value) (the compact cotangent; the forward's si2 per atom
// with the path table's rows and columns swapped: see terms_fwd_kernel). A
// unit is (path, row group, component q, 4 consecutive entries r); its o
// range is cut into L parts (L a power of two, at most 8, so that a part is
// about OC o) run by L neighbouring lanes and summed by an xor butterfly,
// so that no path's long o range runs on a few threads alone. Per o one 16-byte load of W^T (row o: mi entries;
// single guarded loads where rows are not 16-byte aligned) and RB rows of g
// (row-minor, stride ts; 16-byte loads with RB a multiple of 4). Each
// path's lanes start on a warp, so a warp is one path. Not synced.
constexpr int OC = 32;

__device__ __forceinline__ int gm_lanes(int mo) {
  const int np = (mo + OC - 1) / OC;
  return np > 4 ? 8 : np > 2 ? 4 : np;
}

template <int RB, typename Put>
__device__ void gm_product(const Args& A, const int* gp, const float* gT,
                           int ts, int groups, Put put,
                           const float* __restrict__ si2wt) {
  const bool al = (reinterpret_cast<size_t>(si2wt) & 15) == 0;
  const int lane = threadIdx.x & 31;
  // lanes of a path: its units times L, rounded up to a warp
  auto n_slots = [&](const int* G) {
    return (G[G_DIM] * ((G[G_MI] + 3) / 4) * groups * gm_lanes(G[G_MO])
            + 31) & ~31;
  };
  int total = 0;
  for (int pth = 0; pth < A.n_paths; ++pth) total += n_slots(gp + pth * G_STRIDE);
  for (int s0 = threadIdx.x & ~31; s0 < total; s0 += NT) {
    int pth = 0, base = 0;
    while (s0 >= base + n_slots(gp + pth * G_STRIDE)) {
      base += n_slots(gp + pth * G_STRIDE);
      ++pth;
    }
    const int* G = gp + pth * G_STRIDE;
    const int mi = G[G_MI], mo = G[G_MO], dim = G[G_DIM];
    const int L = gm_lanes(mo), nr4 = (mi + 3) / 4;
    const int slot = s0 + lane - base, j = slot % L;
    int unit = slot / L;
    const bool on = unit < dim * nr4 * groups;
    const int r = 4 * (unit % nr4);
    unit /= nr4;
    const int q = unit % dim, rg = unit / dim;
    const int len = (mo + L - 1) / L;
    const int o0 = on ? j * len : 0, o1 = on ? min(mo, o0 + len) : 0;
    const bool vec = al && ((G[G_W] | mi) & 3) == 0;
    const float* W = si2wt + G[G_W] + r;
    const float* gq = gT + (G[G_OUT] + q * mo) * ts + rg * RB;
    float acc[RB][4];
#pragma unroll
    for (int e = 0; e < RB; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[e][t] = 0.f;
#pragma unroll 4
    for (int o = o0; o < o1; ++o) {
      float4 w4;
      if (vec) {
        w4 = __ldg(reinterpret_cast<const float4*>(W + (long)o * mi));
      } else {
        const float* wr = W + (long)o * mi;
        w4 = make_float4(__ldg(wr), r + 1 < mi ? __ldg(wr + 1) : 0.f,
                         r + 2 < mi ? __ldg(wr + 2) : 0.f,
                         r + 3 < mi ? __ldg(wr + 3) : 0.f);
      }
      float a[RB];
      if constexpr (RB % 4 == 0) {
#pragma unroll
        for (int h = 0; h < RB / 4; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(gq + o * ts + 4 * h);
          a[4 * h] = v.x; a[4 * h + 1] = v.y;
          a[4 * h + 2] = v.z; a[4 * h + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < RB; ++e) a[e] = gq[o * ts + e];
      }
#pragma unroll
      for (int e = 0; e < RB; ++e) {
        acc[e][0] = fmaf(a[e], w4.x, acc[e][0]);
        acc[e][1] = fmaf(a[e], w4.y, acc[e][1]);
        acc[e][2] = fmaf(a[e], w4.z, acc[e][2]);
        acc[e][3] = fmaf(a[e], w4.w, acc[e][3]);
      }
    }
    for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
      for (int e = 0; e < RB; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc[e][t] += __shfl_xor_sync(0xffffffffu, acc[e][t], off);
    if (on && j == 0) {
      const float alpha = __ldg(A.path_alpha + pth);
      const int c = G[G_CIN] + q * mi + r;
#pragma unroll
      for (int e = 0; e < RB; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (r + t < mi) put(rg * RB + e, c + t, acc[e][t] * alpha);
    }
  }
}

// Q[a][m][n][u] = sum over instruction a's terms (m, n, p, c) of
// c gm[cm + p mul + u]: the CG folded with the message cotangent, so that
// per row T_m = sum_n Q_mn sh_n and V_n = sum_m Q_mn x_m; one thread per
// live column (instruction, channel), its terms from the constant pool.
// Ends synchronised.
__device__ void build_q(const Args& A, const BArgs& B, const int* bins,
                        const float* gm, float* q_s) {
  for (int i = threadIdx.x; i < A.n_live; i += NT) {
    int a = 0;
    while (a + 1 < B.n_bins && bins[(a + 1) * B_STRIDE + B_COL0] <= i) ++a;
    const int* Bi = bins + a * B_STRIDE;
    const int mul = Bi[B_MUL], u = i - Bi[B_COL0];
    const int d2 = 2 * Bi[B_L2] + 1, nq = (2 * Bi[B_L1] + 1) * d2;
    float* q = q_s + Bi[B_Q] + u;
    for (int k = 0; k < nq; ++k) q[k * mul] = 0.f;
    const float* g = gm + Bi[B_CM] + u;
    const int t1 = Bi[B_TB1];
    for (int t = Bi[B_TB0]; t < t1; ++t) {
      const int id = c_idx[t];
      const int m = id & 0xff, n = (id >> 8) & 0xff, p = (id >> 16) & 0xff;
      q[(m * d2 + n) * mul] =
          fmaf(c_coef[t], g[p * mul], q[(m * d2 + n) * mul]);
    }
  }
  __syncthreads();
}

// one user instruction of an x entry at (row, channel u), from registers:
// T_m = sum_n Q_mn sh_n, V_n = sum_m Q_mn x_m; dw = x . T (times ms, in
// place of w), dx += w T, dsh at l2^2 + n += w V
template <int L1, int L2>
__device__ __forceinline__ void cg_user(const int* Bi, int u,
                                        const float* q_s, const float* shr,
                                        float* wr, float m_e,
                                        const float (&x)[2 * L1 + 1],
                                        float (&dx)[2 * L1 + 1],
                                        float (&dsh)[SHS]) {
  constexpr int D1 = 2 * L1 + 1, D2 = 2 * L2 + 1;
  const int mul = Bi[B_MUL], c = Bi[B_COL0] + u;
  const float* q = q_s + Bi[B_Q] + u;
  float sv[D2], v[D2], t[D1];
#pragma unroll
  for (int n = 0; n < D2; ++n) {
    sv[n] = shr[L2 * L2 + n];
    v[n] = 0.f;
  }
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    float tm = 0.f;
#pragma unroll
    for (int n = 0; n < D2; ++n) {
      const float qv = q[(m * D2 + n) * mul];
      tm = fmaf(qv, sv[n], tm);
      v[n] = fmaf(qv, x[m], v[n]);
    }
    t[m] = tm;
  }
  const float w = wr[c];
  float dw = 0.f;
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    dw = fmaf(x[m], t[m], dw);
    dx[m] = fmaf(w, t[m], dx[m]);
  }
#pragma unroll
  for (int n = 0; n < D2; ++n)
    dsh[L2 * L2 + n] = fmaf(w, v[n], dsh[L2 * L2 + n]);
  wr[c] = dw * m_e;
}

// one CG item: channel u of x entry X on one row, every live instruction
// that reads the entry; x and dx stay in registers, dxg is written once.
// A pad row (m_e == 0) writes zeros and loads nothing.
template <int L1>
__device__ __forceinline__ void cg_item(const int* X, const int* bins,
                                        const int* users, const float* q_s,
                                        const float* shr, float* wr,
                                        float m_e,
                                        const float* __restrict__ xrow,
                                        float* __restrict__ dxrow, int u,
                                        float (&dsh)[SHS]) {
  constexpr int D1 = 2 * L1 + 1;
  const int mul = X[X_MUL], nu = X[X_NU];
  const int* us = users + X[X_U0];
  float x[D1], dx[D1];
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    x[m] = m_e != 0.f ? __ldcs(xrow + m * mul + u) : 0.f;
    dx[m] = 0.f;
  }
  for (int j = 0; j < nu; ++j) {
    const int* Bi = bins + us[j] * B_STRIDE;
    if (m_e == 0.f) {
      wr[Bi[B_COL0] + u] = 0.f;
      continue;
    }
    switch (Bi[B_L2]) {
      case 0: cg_user<L1, 0>(Bi, u, q_s, shr, wr, m_e, x, dx, dsh); break;
      case 1: cg_user<L1, 1>(Bi, u, q_s, shr, wr, m_e, x, dx, dsh); break;
      case 2: cg_user<L1, 2>(Bi, u, q_s, shr, wr, m_e, x, dx, dsh); break;
      default: cg_user<L1, 3>(Bi, u, q_s, shr, wr, m_e, x, dx, dsh); break;
    }
  }
#pragma unroll
  for (int m = 0; m < D1; ++m) __stcs(dxrow + m * mul + u, dx[m]);
}

// the sum of v[0..15] over a warp by recursive halving: each step hands
// half of the values to the partner lane, so lane l ends with the total of
// value sum_index(l) (lanes l and l ^ 1 alike)
__device__ __forceinline__ float warp_sum16(float (&v)[SHS], int lane) {
#pragma unroll
  for (int o = 16, h = 8; o > 1; o >>= 1, h >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < h) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

__device__ __forceinline__ int sum_index(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4
         + ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
}

// The CG backward of `tcg` rows (AGG: the tile's, `rows` of them valid;
// else the one row e1, tcg = 1): items (x entry, row, channel) in x-entry
// ranges padded to whole warps, so a warp of 32-lane items is one row; dsh
// summed over its lanes into the warp's partial row (lane by lane when an
// entry's mul is not a multiple of 32). Not synced.
__device__ void cg_pass(const Args& A, const BArgs& B, const int* xcls,
                        const int* bins, const int* users, const float* q_s,
                        const float* sh_s, float* w_s, const float* ms_s,
                        float* dshp, int tcg, int rows, int e1, long row0,
                        const float* __restrict__ xg,
                        float* __restrict__ dxg) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j0 = warp * 32; j0 < B.n_items; j0 += NT) {
    int k = 0;
    while (k + 1 < B.n_x && xcls[(k + 1) * X_STRIDE + X_START] <= j0) ++k;
    const int* X = xcls + k * X_STRIDE;
    const int lanes = X[X_LANES], per_row = lanes * X[X_GROUPS];
    const int loc = j0 + lane - X[X_START];
    const int e = loc / per_row, rem = loc - e * per_row;
    const int u = rem;                    // group * lanes + lane in group
    const bool valid = e < rows;
    float dsh[SHS];
#pragma unroll
    for (int n = 0; n < SHS; ++n) dsh[n] = 0.f;
    if (valid) {
      const int er = tcg == 1 ? e1 : e;
      const long row = row0 + er;
      const float* xrow = xg + row * A.d1 + X[X_XOFF];
      float* dxrow = dxg + row * A.d1 + X[X_XOFF];
      const float* shr = sh_s + er * SHS;
      float* wr = w_s + er * B.nls;
      const float m_e = ms_s[er];
      switch (X[X_L1]) {
        case 0: cg_item<0>(X, bins, users, q_s, shr, wr, m_e, xrow, dxrow, u,
                           dsh); break;
        case 1: cg_item<1>(X, bins, users, q_s, shr, wr, m_e, xrow, dxrow, u,
                           dsh); break;
        case 2: cg_item<2>(X, bins, users, q_s, shr, wr, m_e, xrow, dxrow, u,
                           dsh); break;
        default: cg_item<3>(X, bins, users, q_s, shr, wr, m_e, xrow, dxrow,
                            u, dsh); break;
      }
    }
    float* dp = dshp + (warp * tcg + (tcg == 1 ? 0 : e)) * SHS;
    if (lanes == 32) {
      const float tot = warp_sum16(dsh, lane);
      if (valid && !(lane & 1)) dp[sum_index(lane)] += tot;
    } else {
      for (int l = 0; l < 32; ++l) {
        if (lane == l && valid) {
#pragma unroll
          for (int n = 0; n < SHS; ++n) dp[n] += dsh[n];
        }
        __syncwarp();
      }
    }
  }
}

// the radial weights w[e][c] = s2 ms[e] sum_k h1[k][e] w2l[k][c] of a tile
// into w_s (row e at e * nls), per item (4 live columns, R rows): R x 4
// sums in registers, per k one 16-byte load of w2l (the live columns of w2,
// packed) and R / 4 16-byte loads of h1 (row-minor). Not synced.
template <int R>
__device__ void w_pass(const Args& A, int nls, int T, const float* h1T,
                       const float* ms_s, const float* __restrict__ w2l,
                       float* w_s) {
  const int nq = nls / 4, items = nq * (T / R);
  const float4* w4p = reinterpret_cast<const float4*>(w2l);
  for (int it = threadIdx.x; it < items; it += NT) {
    const int cq = it % nq, rg = it / nq;
    const float* hp = h1T + rg * R;
    float acc[R][4];
#pragma unroll
    for (int e = 0; e < R; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[e][t] = 0.f;
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 w = __ldg(w4p + k * nq + cq);
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const float4 h = *reinterpret_cast<const float4*>(hp + k * T + 4 * i);
        const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* a = acc[4 * i + j];
          a[0] = fmaf(hv[j], w.x, a[0]);
          a[1] = fmaf(hv[j], w.y, a[1]);
          a[2] = fmaf(hv[j], w.z, a[2]);
          a[3] = fmaf(hv[j], w.w, a[3]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int er = rg * R + e;
      const float sc = A.s2 * ms_s[er];
      *reinterpret_cast<float4*>(w_s + er * nls + 4 * cq) = make_float4(
          acc[e][0] * sc, acc[e][1] * sc, acc[e][2] * sc, acc[e][3] * sc);
    }
  }
}

// pass D: dh1 = dw @ w2^T over the live columns in KS parts, into
// part[(ks T + e) H + k]; item (two k, 8 rows, part): per 4 columns four
// 8-byte loads of w2l^T and 8 broadcast 16-byte loads of dw. Not synced.
__device__ void pass_d(const BArgs& B, int T, const float* w_s,
                       const float* __restrict__ w2lt, float* part) {
  const int nq = B.nls / 4, per = (nq + KS - 1) / KS, nrg = T / 8;
  for (int it = threadIdx.x; it < 32 * nrg * KS; it += NT) {
    const int kp = it & 31, rg = (it >> 5) % nrg, ks = (it >> 5) / nrg;
    const int c0 = 4 * ks * per, c1 = min(4 * (ks + 1) * per, B.nls);
    const float* dr = w_s + rg * 8 * B.nls;
    float a0[8], a1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a0[e] = a1[e] = 0.f;
#pragma unroll 1
    for (int c = c0; c < c1; c += 4) {
      float2 wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wv[i] = __ldg(reinterpret_cast<const float2*>(w2lt + (c + i) * H)
                      + kp);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float4 d =
            *reinterpret_cast<const float4*>(dr + e * B.nls + c);
        a0[e] = fmaf(d.x, wv[0].x, a0[e]);
        a1[e] = fmaf(d.x, wv[0].y, a1[e]);
        a0[e] = fmaf(d.y, wv[1].x, a0[e]);
        a1[e] = fmaf(d.y, wv[1].y, a1[e]);
        a0[e] = fmaf(d.z, wv[2].x, a0[e]);
        a1[e] = fmaf(d.z, wv[2].y, a1[e]);
        a0[e] = fmaf(d.w, wv[3].x, a0[e]);
        a1[e] = fmaf(d.w, wv[3].y, a1[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      *reinterpret_cast<float2*>(part + (ks * T + rg * 8 + e) * H + 2 * kp) =
          make_float2(a0[e], a1[e]);
  }
}

// rows [row0, row0 + n) of dxg, dsh and demb as zeros (a tile of pads)
__device__ void zero_rows(const Args& A, long row0, int n, float* dxg,
                          float* dsh, float* demb) {
  for (int i = threadIdx.x; i < n * A.d1; i += NT) dxg[row0 * A.d1 + i] = 0.f;
  for (int i = threadIdx.x; i < n * A.f; i += NT) dsh[row0 * A.f + i] = 0.f;
  for (int i = threadIdx.x; i < n * A.nb; i += NT) demb[row0 * A.nb + i] = 0.f;
}

// AGG: a block walks output rows (atoms) persistently: per atom g, gm and
// Q once, then the atom's `group` rows in tiles of T. Not AGG (group = 1):
// tiles of T edge rows, gm per row by the product over the tile, Q and the
// CG row by row. Per tile: the staged rows, the hidden layers, the w pass,
// the CG (dxg, dw in place of w, dsh), pass D, passes E and F, the stores.
template <bool AGG>
__global__ void __launch_bounds__(NT, 2)
terms_bwd_kernel(const float* __restrict__ gout,
                 const float* __restrict__ xg, const float* __restrict__ sh,
                 const float* __restrict__ emb, const float* __restrict__ ms,
                 const float* __restrict__ w0, const float* __restrict__ w1,
                 const float* __restrict__ w1t,
                 const float* __restrict__ w2l,
                 const float* __restrict__ w2lt,
                 const float* __restrict__ si2wt, Args A, BArgs B,
                 float* __restrict__ dxg, float* __restrict__ dsh,
                 float* __restrict__ demb) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const BLay L = bwd_layout(A, B, AGG);
  int* bins = reinterpret_cast<int*>(sm + L.bins);
  int* xcls = reinterpret_cast<int*>(sm + L.xcls);
  int* users = reinterpret_cast<int*>(sm + L.users);
  int* gp = reinterpret_cast<int*>(sm + L.gp);
  float *g_s = sm + L.g, *gm_s = sm + L.gm, *q_s = sm + L.q, *w_s = sm + L.w;
  float *h0T = sm + L.h0, *h1T = sm + L.h1, *dshp = sm + L.dshp;
  float *d0T = sm + L.d0, *d1T = sm + L.d1, *sh_s = sm + L.sh;
  float *embT = sm + L.emb, *ms_s = sm + L.ms, *dsh_s = sm + L.dsh;
  float* part = h0T;                 // pass-D partials over h0, h1, dshp
  const int tid = threadIdx.x, T = B.T;
  for (int i = tid; i < B.n_bins * B_STRIDE; i += NT) bins[i] = B.bins[i];
  for (int i = tid; i < B.n_x * X_STRIDE; i += NT) xcls[i] = B.xcls[i];
  for (int i = tid; i < B.n_users; i += NT) users[i] = B.users[i];
  for (int i = tid; i < A.n_paths * G_STRIDE; i += NT) gp[i] = B.gpaths[i];

  const long n_work = AGG ? A.n_rows / A.group : (A.n_rows + T - 1) / T;
  for (long wk = blockIdx.x; wk < n_work; wk += gridDim.x) {
    __syncthreads();
    if constexpr (AGG) {
      // the atom's message cotangent and Q, once for its rows
      for (int i = tid; i < A.d_out; i += NT) g_s[i] = gout[wk * A.d_out + i];
      __syncthreads();
      gm_product<1>(A, gp, g_s, 1, 1,
                    [&](int, int c, float v) { gm_s[c] = v; }, si2wt);
      __syncthreads();
      build_q(A, B, bins, gm_s, q_s);
    }
    for (int t0 = 0; t0 < A.group; t0 += T) {
      const long row0 = AGG ? wk * A.group + t0 : wk * T;
      const int rows = (int)min((long)T, AGG ? (long)(A.group - t0)
                                             : A.n_rows - row0);
      __syncthreads();
      for (int i = tid; i < T; i += NT)
        ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      if (!__syncthreads_or(tid < rows && ms_s[tid] != 0.f)) {
        zero_rows(A, row0, rows, dxg, dsh, demb);
        continue;
      }
      if constexpr (!AGG) {
        // the rows' cotangents, row-minor, and gm per row
        for (int i = tid; i < T * A.d_out; i += NT) {
          const int e = i / A.d_out, c = i - e * A.d_out;
          g_s[c * T + e] = e < rows ? gout[(row0 + e) * A.d_out + c] : 0.f;
        }
        __syncthreads();
        gm_product<8>(A, gp, g_s, T, T / 8,
                      [&](int e, int c, float v) {
                        gm_s[(long)e * B.n_msg + c] = v;
                      }, si2wt);
      }
      for (int i = tid; i < T * SHS; i += NT) {
        const int e = i / SHS, j = i - e * SHS;
        sh_s[i] = e < rows && j < A.f ? sh[(row0 + e) * A.f + j] : 0.f;
      }
      for (int i = tid; i < A.nb * T; i += NT) {
        const int b = i / T, e = i - b * T;
        embT[i] = e < rows ? emb[(row0 + e) * A.nb + b] : 0.f;
      }
      __syncthreads();
      // the hidden layers, row-minor, with the derivatives times cst
      for (int i = tid; i < H * T; i += NT) {
        const int j = i / T, e = i - j * T;
        float s = 0.f;
        for (int b = 0; b < A.nb; ++b)
          s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);
        s *= A.s0;
        h0T[i] = act_f(s, A.act) * A.act_cst;
        d0T[i] = act_df(s, A.act) * A.act_cst;
      }
      __syncthreads();
      for (int i = tid; i < H * (T / 4); i += NT) {
        const int j = i % H, e0 = (i / H) * 4;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);
          const float wv = __ldg(w1 + k * H + j);
          a[0] = fmaf(h.x, wv, a[0]); a[1] = fmaf(h.y, wv, a[1]);
          a[2] = fmaf(h.z, wv, a[2]); a[3] = fmaf(h.w, wv, a[3]);
        }
        float o[4], d[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float s = a[r] * A.s1;
          o[r] = act_f(s, A.act) * A.act_cst;
          d[r] = act_df(s, A.act) * A.act_cst;
        }
        *reinterpret_cast<float4*>(h1T + j * T + e0) =
            make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(d1T + j * T + e0) =
            make_float4(d[0], d[1], d[2], d[3]);
      }
      __syncthreads();
      switch (B.R) {
        case 4: w_pass<4>(A, B.nls, T, h1T, ms_s, w2l, w_s); break;
        case 8: w_pass<8>(A, B.nls, T, h1T, ms_s, w2l, w_s); break;
        default: w_pass<16>(A, B.nls, T, h1T, ms_s, w2l, w_s); break;
      }
      __syncthreads();
      if constexpr (AGG) {
        for (int i = tid; i < NW * T * SHS; i += NT) dshp[i] = 0.f;
        __syncthreads();
        cg_pass(A, B, xcls, bins, users, q_s, sh_s, w_s, ms_s, dshp, T, rows,
                0, row0, xg, dxg);
        __syncthreads();
        for (int i = tid; i < T * SHS; i += NT) {
          float s = 0.f;
          for (int w = 0; w < NW; ++w) s += dshp[w * T * SHS + i];
          dsh_s[i] = s;
        }
      } else {
        // Q and the CG row by row: Q takes one row's words
        for (int e = 0; e < rows; ++e) {
          if (ms_s[e] == 0.f) {              // a pad row: zeros
            for (int i = tid; i < A.d1; i += NT)
              dxg[(row0 + e) * A.d1 + i] = 0.f;
            for (int i = tid; i < A.f; i += NT) dsh[(row0 + e) * A.f + i] = 0.f;
            continue;
          }
          for (int i = tid; i < NW * SHS; i += NT) dshp[i] = 0.f;
          build_q(A, B, bins, gm_s + (long)e * B.n_msg, q_s);
          cg_pass(A, B, xcls, bins, users, q_s, sh_s, w_s, ms_s, dshp, 1, 1,
                  e, row0, xg, dxg);
          __syncthreads();
          for (int i = tid; i < A.f; i += NT) {
            float s = 0.f;
            for (int w = 0; w < NW; ++w) s += dshp[w * SHS + i];
            dsh[(row0 + e) * A.f + i] = s;
          }
          __syncthreads();
        }
      }
      __syncthreads();
      pass_d(B, T, w_s, w2lt, part);
      __syncthreads();
      // dpre1 = dh1 * s2 * act'(pre1), in place of the derivative
      for (int i = tid; i < H * T; i += NT) {
        const int e = i / H, k = i - e * H;
        float s = 0.f;
#pragma unroll
        for (int p = 0; p < KS; ++p) s += part[(p * T + e) * H + k];
        d1T[k * T + e] *= s * A.s2;
      }
      __syncthreads();
      // pass E: dpre0 = (dpre1 @ w1^T) * s1 * act'(pre0), in place of the
      // derivative; item (j, 4 rows)
      for (int i = tid; i < H * (T / 4); i += NT) {
        const int j = i % H, e0 = (i / H) * 4;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 p = *reinterpret_cast<const float4*>(d1T + k * T + e0);
          const float wv = __ldg(w1t + k * H + j);
          a[0] = fmaf(p.x, wv, a[0]); a[1] = fmaf(p.y, wv, a[1]);
          a[2] = fmaf(p.z, wv, a[2]); a[3] = fmaf(p.w, wv, a[3]);
        }
        float4 d = *reinterpret_cast<const float4*>(d0T + j * T + e0);
        d.x *= a[0] * A.s1; d.y *= a[1] * A.s1;
        d.z *= a[2] * A.s1; d.w *= a[3] * A.s1;
        *reinterpret_cast<float4*>(d0T + j * T + e0) = d;
      }
      __syncthreads();
      // pass F: demb = s0 dpre0 @ w0^T; AGG: the rows' dsh
      for (int i = tid; i < rows * A.nb; i += NT) {
        const int e = i / A.nb, b = i - e * A.nb;
        float s = 0.f;
#pragma unroll 8
        for (int j = 0; j < H; ++j)
          s = fmaf(d0T[j * T + e], __ldg(w0 + b * H + j), s);
        demb[(row0 + e) * A.nb + b] = s * A.s0;
      }
      if constexpr (AGG) {
        for (int i = tid; i < rows * A.f; i += NT) {
          const int e = i / A.f, j = i - e * A.f;
          dsh[(row0 + e) * A.f + j] =
              ms_s[e] != 0.f ? dsh_s[e * SHS + j] : 0.f;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------

// forward instruction record (int32), live instructions in plan order: x
// offset, mul, l1, l3, offset of its block in a row's folded CG B, first
// live column, offset in the compact message
enum { F_XOFF = 0, F_MUL, F_L1, F_L3, F_B, F_COL0, F_CM, F_STRIDE };
// fold entry (instruction, output component p): offset of B[0][p] in a
// row's B, the stride of m (D3 rounded up to 4) and D1, the instruction's
// SH offset, its terms of component p, [T0, T1) of the pool
enum { O_B = 0, O_D3, O_D1, O_SH, O_T0, O_T1, O_STRIDE };

struct FArgs {
  const int* fins;      // n_fins * F_STRIDE
  const int* folds;     // n_folds * O_STRIDE
  const int* fpaths;    // n_paths * G_STRIDE: the si2 paths, rows and
                        // columns swapped (see terms_fwd_kernel)
  const int* unfed;     // n_unfed output columns no path writes
  int n_fins, n_folds, n_unfed;
  int n_msg;            // live message elements (the compact message)
  int nB;               // words of a row's folded CG
  int nls;              // live columns rounded up to 4 (row stride of w)
  int T, R, s;          // rows per tile; rows per w-pass item; CG row groups
};

// word offsets of the forward's shared buffers (host and device)
struct FLay {
  int fins, folds, units, fp, sh, emb, ms, h0, h1, w, b, msg, total;
};

// AGG: the message is the output row's, one partial sum per CG row group;
// else the tile's rows' messages, row-minor (element c of row e at c T + e)
__host__ __device__ inline FLay fwd_layout(const Args& A, const FArgs& F,
                                           bool agg) {
  const int T = F.T;
  FLay L;
  int o = 0;
  L.fins = o; o += r4i(F.n_fins * F_STRIDE);
  L.folds = o; o += r4i(F.n_folds * O_STRIDE);
  L.units = o; o += r4i(2 * A.n_slices);
  L.fp = o; o += r4i(A.n_paths * G_STRIDE);
  L.sh = o; o += T * SHS;
  L.emb = o; o += r4i(A.nb * T);
  L.ms = o; o += r4i(T);
  L.h0 = o; o += H * T;
  L.h1 = o; o += H * T;
  L.w = o; o += T * F.nls;
  L.b = o; o += T * F.nB;
  L.msg = o; o += agg ? F.s * r4i(F.n_msg) : T * F.n_msg;
  L.total = o;
  return L;
}

// the hidden layers of a staged tile, row-minor (h[k][e] at k T + e): h0
// a thread per (hidden unit, row), h1 per (hidden unit, 4 rows) from
// 16-byte loads of h0. Ends synchronised.
__device__ void hidden_fwd(const Args& A, int T, const float* embT,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1, float* h0T,
                           float* h1T) {
  for (int i = threadIdx.x; i < H * T; i += NT) {
    const int j = i / T, e = i - j * T;
    float s = 0.f;
    for (int b = 0; b < A.nb; ++b)
      s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);
    h0T[i] = act_f(s * A.s0, A.act) * A.act_cst;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H * (T / 4); i += NT) {
    const int j = i % H, e0 = (i / H) * 4;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);
      const float wv = __ldg(w1 + k * H + j);
      a[0] = fmaf(h.x, wv, a[0]); a[1] = fmaf(h.y, wv, a[1]);
      a[2] = fmaf(h.z, wv, a[2]); a[3] = fmaf(h.w, wv, a[3]);
    }
    *reinterpret_cast<float4*>(h1T + j * T + e0) = make_float4(
        act_f(a[0] * A.s1, A.act) * A.act_cst,
        act_f(a[1] * A.s1, A.act) * A.act_cst,
        act_f(a[2] * A.s1, A.act) * A.act_cst,
        act_f(a[3] * A.s1, A.act) * A.act_cst);
  }
  __syncthreads();
}

// The SH folded into the CG, per row e and live instruction a:
//   B[e][a][m][p] = sum over a's terms (m, n, p, c) of c sh[e][n]
// (row e's B at e * nB). An item is (fold entry (a, p), row), rows fastest,
// so the lanes of a warp walk at most two term runs of the constant pool.
// Not synced.
__device__ void fold_sh(const FArgs& F, const int* folds, int T,
                        const float* sh_s, float* b_s) {
  for (int i = threadIdx.x; i < F.n_folds * T; i += NT) {
    const int f = i / T, e = i - f * T;
    const int* O = folds + f * O_STRIDE;
    const int d3 = O[O_D3], d1 = O[O_D1], t1 = O[O_T1];
    float* b = b_s + e * F.nB + O[O_B];
    const float* s = sh_s + e * SHS + O[O_SH];
    for (int m = 0; m < d1; ++m) b[m * d3] = 0.f;
    for (int t = O[O_T0]; t < t1; ++t) {
      const int id = c_idx[t];
      const int m = id & 0xff, n = (id >> 8) & 0xff;
      b[m * d3] = fmaf(c_coef[t], s[n], b[m * d3]);
    }
  }
}

// The CG of one unit (instruction, channel u) over rows [e0, e1) of a tile
// (`rows` of them real), a dense D1 x D3 product a row from registers: x of
// four rows loaded together (past the tile's real rows, its last one's),
// B of a row (its rows m padded to D3P, a multiple of 4) by 16-byte
// broadcasts, msg_p = w sum_m B[m][p] x_m. AGG: summed over the rows into
// the row group's partial message (msg); else each row's message, four
// rows to a 16-byte store (msg row-minor, stride T). A pad row (w = 0)
// sends exact zeros whatever its x.
template <bool AGG, int L1, int L3>
__device__ __forceinline__ void cg_fwd(const int* Fi, int u, int e0, int e1,
                                       int rows, int T, int d1, int nB,
                                       int nls, const float* b_s,
                                       const float* w_s,
                                       const float* __restrict__ xrow,
                                       float* msg) {
  constexpr int D1 = 2 * L1 + 1, D3 = 2 * L3 + 1, D3P = (D3 + 3) & ~3;
  const int mul = Fi[F_MUL], c = Fi[F_COL0] + u;
  const float* xb = xrow + Fi[F_XOFF] + u;
  const float* bb = b_s + Fi[F_B];
  // component p of the unit's message at mb + p * pstride
  float* mb = msg + (AGG ? Fi[F_CM] + u : (long)(Fi[F_CM] + u) * T);
  const long pstride = AGG ? mul : (long)mul * T;
  float acc[D3];
#pragma unroll
  for (int p = 0; p < D3; ++p) acc[p] = 0.f;
  for (int e4 = e0; e4 < e1; e4 += 4) {
    float x[4][D1];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long er = min(e4 + j, rows - 1);
#pragma unroll
      for (int m = 0; m < D1; ++m) x[j][m] = __ldg(xb + er * d1 + m * mul);
    }
    float v[D3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e4 + j;
      const float w = w_s[e * nls + c];
      const float* br = bb + e * nB;
      float s[D3];
#pragma unroll
      for (int p = 0; p < D3; ++p) s[p] = 0.f;
#pragma unroll
      for (int m = 0; m < D1; ++m) {
#pragma unroll
        for (int k = 0; k < D3P / 4; ++k) {
          const float4 q =
              *reinterpret_cast<const float4*>(br + m * D3P + 4 * k);
          const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * k + i < D3)
              s[4 * k + i] = fmaf(qv[i], x[j][m], s[4 * k + i]);
        }
      }
#pragma unroll
      for (int p = 0; p < D3; ++p) {
        const float t = w != 0.f ? w * s[p] : 0.f;
        if constexpr (AGG) acc[p] += t;
        else v[p][j] = t;
      }
    }
    if constexpr (!AGG) {
#pragma unroll
      for (int p = 0; p < D3; ++p)
        *reinterpret_cast<float4*>(mb + p * pstride + e4) =
            make_float4(v[p][0], v[p][1], v[p][2], v[p][3]);
    }
  }
  if constexpr (AGG) {
#pragma unroll
    for (int p = 0; p < D3; ++p) mb[p * pstride] += acc[p];
  }
}

// The CG pass of a tile: items (unit, row group), a unit being 32 channels
// of one live instruction (the plan's slices) on a warp, a row group T / s
// rows. AGG: row group g adds into partial message g. Not synced.
template <bool AGG>
__device__ void cg_fwd_pass(const Args& A, const FArgs& F, const int* fins,
                            const int* units, const float* b_s,
                            const float* w_s, const float* __restrict__ xg,
                            long row0, int rows, float* msg) {
  const int lane = threadIdx.x & 31, T = F.T, R = T / F.s;
  const int msw = r4i(F.n_msg);
  for (int j0 = threadIdx.x & ~31; j0 < 32 * A.n_slices * F.s; j0 += NT) {
    const int unit = (j0 >> 5) % A.n_slices, g = (j0 >> 5) / A.n_slices;
    const int* Fi = fins + units[2 * unit] * F_STRIDE;
    const int u = units[2 * unit + 1] + lane;
    if (u >= Fi[F_MUL]) continue;
    const int e0 = g * R, e1 = e0 + R;
    float* m = AGG ? msg + g * msw : msg;
    const float* xrow = xg + row0 * A.d1;
    switch (Fi[F_L1] * 4 + Fi[F_L3]) {
#define TERMS_FWD_CASE(a, c)                                                \
      case a * 4 + c:                                                       \
        cg_fwd<AGG, a, c>(Fi, u, e0, e1, rows, T, A.d1, F.nB, F.nls, b_s,   \
                          w_s, xrow, m);                                    \
        break;
#define TERMS_FWD_L1(a) TERMS_FWD_CASE(a, 0) TERMS_FWD_CASE(a, 1)           \
      TERMS_FWD_CASE(a, 2) TERMS_FWD_CASE(a, 3)
      TERMS_FWD_L1(0) TERMS_FWD_L1(1) TERMS_FWD_L1(2) TERMS_FWD_L1(3)
#undef TERMS_FWD_L1
#undef TERMS_FWD_CASE
    }
  }
}

// si2 of a tile's rows at agg_d = 0, y = alpha M W per path and component
// q: a thread holds RB rows x 4 output columns, reading per reduction index
// k one 16-byte load of W's row k (row-major mi x mo) and the RB rows' k-th
// message elements by 16-byte broadcasts (msgT row-minor, stride T). Lanes
// run over the column groups so that a warp reads whole rows of W: C lanes
// (the path's groups of 4 columns, rounded up to a power of two in
// [8, 32], halved for every path while the tile has fewer warp units than
// the block has warps, down to 8) by 32 / C parts of k interleaved (part j
// takes k = j mod 32/C, so the warp's rows are consecutive), the parts
// summed by an xor butterfly. Warp units (path, q, row block, column block) back to back.
// Each output column a path writes goes through put(row, column, value)
// once. Not synced.
__device__ __forceinline__ int si2_lanes(int mo, int shift) {
  const int nc4 = (mo + 3) / 4;
  const int c = nc4 > 16 ? 32 : nc4 > 8 ? 16 : 8;
  return c >> shift > 8 ? c >> shift : 8;
}

template <int RB, typename Put>
__device__ void si2_rows(const Args& A, const int* fp, const float* msgT,
                         int T, Put put, const float* __restrict__ si2w) {
  const bool al = (reinterpret_cast<size_t>(si2w) & 15) == 0;
  const int lane = threadIdx.x & 31, nrb = T / RB;
  // warp units of a path: components x row blocks x column blocks
  int shift = 0, total = 0;
  auto n_units = [&](const int* G) {
    const int C = si2_lanes(G[G_MI], shift);
    return G[G_DIM] * nrb * (((G[G_MI] + 3) / 4 + C - 1) / C);
  };
  for (;; ++shift) {
    total = 0;
    for (int pth = 0; pth < A.n_paths; ++pth)
      total += n_units(fp + pth * G_STRIDE);
    if (total >= NW || shift == 2) break;
  }
  for (int w0 = threadIdx.x >> 5; w0 < total; w0 += NW) {
    int pth = 0, base = 0;
    while (w0 >= base + n_units(fp + pth * G_STRIDE)) {
      base += n_units(fp + pth * G_STRIDE);
      ++pth;
    }
    // the swapped path record: output offset, mo, mi, components, message
    // offset, weights
    const int* G = fp + pth * G_STRIDE;
    const int mo = G[G_MI], mi = G[G_MO], C = si2_lanes(mo, shift);
    const int KS = 32 / C;
    const int ncb = ((mo + 3) / 4 + C - 1) / C;
    int u = w0 - base;
    const int cb = u % ncb;
    u /= ncb;
    const int rb = u % nrb, q = u / nrb;
    const int j = lane / C, c = 4 * (cb * C + lane % C);
    const bool on = c < mo;
    const bool vec = al && ((G[G_W] | mo) & 3) == 0;
    const float* W = si2w + G[G_W] + c;
    const float* mq = msgT + (long)(G[G_OUT] + q * mi) * T + rb * RB;
    float acc[RB][4];
#pragma unroll
    for (int e = 0; e < RB; ++e)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[e][t] = 0.f;
    if (on) {
#pragma unroll 4
      for (int k = j; k < mi; k += KS) {
        float4 w4;
        const float* wr = W + (long)k * mo;
        if (vec) {
          w4 = __ldg(reinterpret_cast<const float4*>(wr));
        } else {
          w4 = make_float4(__ldg(wr), c + 1 < mo ? __ldg(wr + 1) : 0.f,
                           c + 2 < mo ? __ldg(wr + 2) : 0.f,
                           c + 3 < mo ? __ldg(wr + 3) : 0.f);
        }
#pragma unroll
        for (int h = 0; h < RB / 4; ++h) {
          const float4 a =
              *reinterpret_cast<const float4*>(mq + (long)k * T + 4 * h);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * h + i][0] = fmaf(av[i], w4.x, acc[4 * h + i][0]);
            acc[4 * h + i][1] = fmaf(av[i], w4.y, acc[4 * h + i][1]);
            acc[4 * h + i][2] = fmaf(av[i], w4.z, acc[4 * h + i][2]);
            acc[4 * h + i][3] = fmaf(av[i], w4.w, acc[4 * h + i][3]);
          }
        }
      }
    }
    for (int off = C; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < RB; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          acc[e][t] += __shfl_xor_sync(0xffffffffu, acc[e][t], off);
    if (on && j == 0) {
      const float alpha = __ldg(A.path_alpha + pth);
      const int oc = G[G_CIN] + q * mo + c;
#pragma unroll
      for (int e = 0; e < RB; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (c + t < mo) put(rb * RB + e, oc + t, acc[e][t] * alpha);
    }
  }
}

// AGG: a block walks output rows (atoms) persistently: per atom the partial
// messages zeroed, its `group` rows in tiles of T, then the partials summed
// in a fixed order and si2 once. Not AGG (group = 1): tiles of T edge rows,
// si2 as a product over the tile's rows. Per tile: the staged rows, the
// hidden layers, the w pass (w_pass, as the backward's) and the SH fold,
// the CG. si2 reads the path table with rows and columns swapped (fpaths:
// output offset, mo, mi, components, compact message offset, weights): out
// = alpha M W per component, once an atom by gm_product, or per tile by
// si2_rows.
template <bool AGG>
__global__ void __launch_bounds__(NT, 2)
terms_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ sh,
                 const float* __restrict__ emb, const float* __restrict__ ms,
                 const float* __restrict__ w0, const float* __restrict__ w1,
                 const float* __restrict__ w2l,
                 const float* __restrict__ si2w, Args A, FArgs F,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const FLay L = fwd_layout(A, F, AGG);
  int* fins = reinterpret_cast<int*>(sm + L.fins);
  int* folds = reinterpret_cast<int*>(sm + L.folds);
  int* units = reinterpret_cast<int*>(sm + L.units);
  int* fp = reinterpret_cast<int*>(sm + L.fp);
  float *sh_s = sm + L.sh, *embT = sm + L.emb, *ms_s = sm + L.ms;
  float *h0T = sm + L.h0, *h1T = sm + L.h1, *w_s = sm + L.w;
  float *b_s = sm + L.b, *msg_s = sm + L.msg;
  const int tid = threadIdx.x, T = F.T, msw = r4i(F.n_msg);
  for (int i = tid; i < F.n_fins * F_STRIDE; i += NT) fins[i] = F.fins[i];
  for (int i = tid; i < F.n_folds * O_STRIDE; i += NT) folds[i] = F.folds[i];
  for (int i = tid; i < 2 * A.n_slices; i += NT) units[i] = A.slices[i];
  for (int i = tid; i < A.n_paths * G_STRIDE; i += NT) fp[i] = F.fpaths[i];

  const long n_work = AGG ? A.n_rows / A.group : (A.n_rows + T - 1) / T;
  for (long wk = blockIdx.x; wk < n_work; wk += gridDim.x) {
    __syncthreads();
    if constexpr (AGG)
      for (int i = tid; i < F.s * msw; i += NT) msg_s[i] = 0.f;
    for (int t0 = 0; t0 < A.group; t0 += T) {
      const long row0 = AGG ? wk * A.group + t0 : wk * T;
      const int rows = (int)min((long)T, AGG ? (long)(A.group - t0)
                                             : A.n_rows - row0);
      __syncthreads();
      for (int i = tid; i < T; i += NT)
        ms_s[i] = i < rows ? ms[row0 + i] : 0.f;
      if (!__syncthreads_or(tid < rows && ms_s[tid] != 0.f)) {
        if constexpr (!AGG)       // a tile of pads: zero rows
          for (int i = tid; i < rows * A.d_out; i += NT)
            __stcs(out + row0 * A.d_out + i, 0.f);
        continue;
      }
      for (int i = tid; i < T * SHS; i += NT) {
        const int e = i / SHS, j = i - e * SHS;
        sh_s[i] = e < rows && j < A.f ? sh[(row0 + e) * A.f + j] : 0.f;
      }
      for (int i = tid; i < A.nb * T; i += NT) {
        const int b = i / T, e = i - b * T;
        embT[i] = e < rows ? emb[(row0 + e) * A.nb + b] : 0.f;
      }
      __syncthreads();
      hidden_fwd(A, T, embT, w0, w1, h0T, h1T);
      switch (F.R) {
        case 4: w_pass<4>(A, F.nls, T, h1T, ms_s, w2l, w_s); break;
        case 8: w_pass<8>(A, F.nls, T, h1T, ms_s, w2l, w_s); break;
        default: w_pass<16>(A, F.nls, T, h1T, ms_s, w2l, w_s); break;
      }
      fold_sh(F, folds, T, sh_s, b_s);
      __syncthreads();
      cg_fwd_pass<AGG>(A, F, fins, units, b_s, w_s, xg, row0, rows, msg_s);
      if constexpr (!AGG) {
        // si2 per row over the tile; the columns no path writes are zeros
        __syncthreads();
        si2_rows<8>(A, fp, msg_s, T,
                    [&](int e, int c, float v) {
                      if (e < rows) __stcs(out + (row0 + e) * A.d_out + c, v);
                    }, si2w);
        for (int i = tid; i < rows * F.n_unfed; i += NT) {
          const int e = i / F.n_unfed, c = __ldg(F.unfed + i - e * F.n_unfed);
          __stcs(out + (row0 + e) * A.d_out + c, 0.f);
        }
      }
    }
    if constexpr (AGG) {
      // the row groups' partial messages, summed in a fixed order; si2 once
      __syncthreads();
      for (int i = tid; i < F.n_msg; i += NT) {
        float v = msg_s[i];
        for (int g = 1; g < F.s; ++g) v += msg_s[g * msw + i];
        msg_s[i] = v;
      }
      __syncthreads();
      gm_product<1>(A, fp, msg_s, 1, 1,
                    [&](int, int c, float v) {
                      __stcs(out + wk * A.d_out + c, v);
                    }, si2w);
      for (int i = tid; i < F.n_unfed; i += NT)
        __stcs(out + wk * A.d_out + __ldg(F.unfed + i), 0.f);
    }
  }
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// persistent grid: the SMs times the blocks that fit on one, at most `work`
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, long work,
                            int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) return err;
  const long fit = sms * per_sm > 1 ? sms * per_sm : 1;
  *grid = (int)(work < fit ? work : fit);
  return cudaSuccess;
}

}  // namespace

#define TERMS_ARGS                                                          \
  const int *slices, const float *path_alpha, int n_slices, int n_live,    \
      int n_paths, long n_rows, int agg_d, int d1, int f, int nb,           \
      int d_out, int act, float act_cst, float s0, float s1, float s2

static Args make_args(TERMS_ARGS) {
  Args A;
  A.slices = slices; A.path_alpha = path_alpha;
  A.n_slices = n_slices; A.n_live = n_live; A.n_paths = n_paths;
  A.n_rows = n_rows; A.group = agg_d > 0 ? agg_d : 1;
  A.d1 = d1; A.f = f; A.nb = nb; A.d_out = d_out;
  A.act = act; A.act_cst = act_cst; A.s0 = s0; A.s1 = s1; A.s2 = s2;
  return A;
}
#define TERMS_CALL                                                          \
  make_args(slices, path_alpha, n_slices, n_live, n_paths, n_rows, agg_d,   \
            d1, f, nb, d_out, act, act_cst, s0, s1, s2)

#define TERMS_BWD_ARGS                                                      \
  const int *bins, const int *xcls, const int *users, const int *gpaths,    \
      int n_bins, int n_x, int n_users, int n_msg, int n_q, int nls,        \
      int n_items, int T, int R, int words

static BArgs make_bargs(TERMS_BWD_ARGS) {
  BArgs B;
  B.bins = bins; B.xcls = xcls; B.users = users; B.gpaths = gpaths;
  B.n_bins = n_bins; B.n_x = n_x; B.n_users = n_users; B.n_msg = n_msg;
  B.n_q = n_q; B.nls = nls; B.n_items = n_items; B.T = T; B.R = R;
  (void)words;
  return B;
}

// the plan's launch numbers as the kernel reads them: tiles of 8 or 16
// rows, w-pass items of 4, 8 or 16 rows dividing the tile, SH blocks within
// 16 words, and the caller's shared words equal to the kernel's layout
static bool bwd_plan_ok(const Args& A, const BArgs& B, bool agg, int words) {
  return (B.T == 8 || B.T == 16) && (B.R == 4 || B.R == 8 || B.R == 16)
         && B.T % B.R == 0 && A.f <= SHS && B.nls % 4 == 0
         && B.nls >= A.n_live && words == bwd_layout(A, B, agg).total;
}

// copy n terms of a plan into the constant pool at `offset` (host arrays)
extern "C" int fused_conv_terms_upload(int offset, int n, const int* idx,
                                       const float* coef) {
  if (offset < 0 || n < 0 || offset + n > TERM_POOL)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaMemcpyToSymbol(c_idx, idx, n * sizeof(int),
                                       offset * sizeof(int));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_coef, coef, n * sizeof(float),
                                 offset * sizeof(float));
}

extern "C" int fused_conv_terms_pool_size() { return TERM_POOL; }

#define TERMS_FWD_ARGS                                                      \
  const int *fins, const int *folds, const int *fpaths, const int *unfed,   \
      int n_fins, int n_folds, int n_unfed, int n_msg, int nB, int nls,     \
      int T, int R, int s, int words

static FArgs make_fargs(TERMS_FWD_ARGS) {
  FArgs F;
  F.fins = fins; F.folds = folds; F.fpaths = fpaths; F.unfed = unfed;
  F.n_fins = n_fins; F.n_folds = n_folds; F.n_unfed = n_unfed;
  F.n_msg = n_msg; F.nB = nB; F.nls = nls; F.T = T; F.R = R; F.s = s;
  (void)words;
  return F;
}

// the forward plan's launch numbers as the kernel reads them: tiles of 8
// or 16 rows, w-pass items of 4, 8 or 16 rows and CG row groups of at
// least 4 rows dividing the tile, 16-byte B rows, SH within 16 words, and
// the caller's shared words equal to the kernel's layout
static bool fwd_plan_ok(const Args& A, const FArgs& F, bool agg, int words) {
  return (F.T == 8 || F.T == 16) && (F.R == 4 || F.R == 8 || F.R == 16)
         && F.T % F.R == 0 && (F.s == 1 || F.s == 2 || F.s == 4)
         && F.T % (4 * F.s) == 0 && A.f <= SHS && F.nls % 4 == 0
         && F.nls >= A.n_live && F.nB % 4 == 0
         && words == fwd_layout(A, F, agg).total;
}

extern "C" int fused_conv_terms_fwd(const float* xg, const float* sh,
                                    const float* emb, const float* ms,
                                    const float* w0, const float* w1,
                                    const float* w2l, const float* si2w,
                                    TERMS_ARGS, TERMS_FWD_ARGS, float* out,
                                    void* stream) {
  const Args A = TERMS_CALL;
  const FArgs F = make_fargs(fins, folds, fpaths, unfed, n_fins, n_folds,
                             n_unfed, n_msg, nB, nls, T, R, s, words);
  const bool agg = agg_d > 0;
  if (!fwd_plan_ok(A, F, agg, words)) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)words;
  const cudaError_t err =
      agg ? reserve_smem(terms_fwd_kernel<true>, smem)
          : reserve_smem(terms_fwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    const long work = agg ? n_rows / agg_d : (n_rows + T - 1) / T;
    int grid = 0;
    const cudaError_t e2 =
        agg ? persistent_grid(terms_fwd_kernel<true>, smem, work, &grid)
            : persistent_grid(terms_fwd_kernel<false>, smem, work, &grid);
    if (e2 != cudaSuccess) return (int)e2;
    if (agg)
      terms_fwd_kernel<true><<<grid, NT, smem, (cudaStream_t)stream>>>(
          xg, sh, emb, ms, w0, w1, w2l, si2w, A, F, out);
    else
      terms_fwd_kernel<false><<<grid, NT, smem, (cudaStream_t)stream>>>(
          xg, sh, emb, ms, w0, w1, w2l, si2w, A, F, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int fused_conv_terms_bwd(const float* g, const float* xg,
                                    const float* sh, const float* emb,
                                    const float* ms, const float* w0,
                                    const float* w1, const float* w1t,
                                    const float* w2l, const float* w2lt,
                                    const float* si2wt, TERMS_ARGS,
                                    TERMS_BWD_ARGS, float* dxg, float* dsh,
                                    float* demb, void* stream) {
  const Args A = TERMS_CALL;
  const BArgs B = make_bargs(bins, xcls, users, gpaths, n_bins, n_x, n_users,
                             n_msg, n_q, nls, n_items, T, R, words);
  const bool agg = agg_d > 0;
  if (!bwd_plan_ok(A, B, agg, words)) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)words;
  const cudaError_t err =
      agg ? reserve_smem(terms_bwd_kernel<true>, smem)
          : reserve_smem(terms_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    const long work = agg ? n_rows / agg_d : (n_rows + T - 1) / T;
    int grid = 0;
    const cudaError_t e2 =
        agg ? persistent_grid(terms_bwd_kernel<true>, smem, work, &grid)
            : persistent_grid(terms_bwd_kernel<false>, smem, work, &grid);
    if (e2 != cudaSuccess) return (int)e2;
    if (agg)
      terms_bwd_kernel<true><<<grid, NT, smem, (cudaStream_t)stream>>>(
          g, xg, sh, emb, ms, w0, w1, w1t, w2l, w2lt, si2wt, A, B, dxg, dsh,
          demb);
    else
      terms_bwd_kernel<false><<<grid, NT, smem, (cudaStream_t)stream>>>(
          g, xg, sh, emb, ms, w0, w1, w1t, w2l, w2lt, si2wt, A, B, dxg, dsh,
          demb);
  }
  return (int)cudaGetLastError();
}

// registers, local bytes a thread, blocks an SM of a kernel instance at
// `smem` shared bytes (on the current device)
template <typename Kernel>
static int resources(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  cudaError_t err = reserve_smem(kernel, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs; out[1] = (int)a.localSizeBytes; out[2] = per_sm;
  return 0;
}

// the backward / forward instance a plan launches at `words` shared words
extern "C" int fused_conv_terms_bwd_resources(int agg, int words, int* out) {
  const size_t smem = 4 * (size_t)words;
  return agg ? resources(terms_bwd_kernel<true>, smem, out)
             : resources(terms_bwd_kernel<false>, smem, out);
}

extern "C" int fused_conv_terms_fwd_resources(int agg, int words, int* out) {
  const size_t smem = 4 * (size_t)words;
  return agg ? resources(terms_fwd_kernel<true>, smem, out)
             : resources(terms_fwd_kernel<false>, smem, out);
}
