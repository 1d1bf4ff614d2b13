// Fused convolution block, the independent "terms" derivation, forward and
// force backward, for NVIDIA Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_terms_fwd <- make_fused_conv(...) under set_cg_mode('terms'):
//                           fwd_kernel (_cg_acc, _mlp_forward)
//   fused_conv_terms_bwd <- the same, bwd_kernel (_act_grad)
//
// It computes what csrc/fused_conv.cu's kernels 1-2 compute and shares no
// code and no table with them: it exists to cross-check them. Per row e:
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
// get zero gradients; output columns no si2 path feeds are zeros.
//
// What "terms" means here: on the TPU the mode is a Python-unrolled list of
// (m, n, p, c) products with the coefficients as immediates. Here the list
// sits in __constant__ memory: lanes run over the channel u of ONE
// instruction, so a warp reads every term at one address (a broadcast from
// the constant cache) and spends no shared-memory bandwidth on tables,
// where kernels 1-2 pay four shared-memory table loads per multiply-add.
//
// What bounds it on this card: operations, like kernels 1-2 (a mid layer does
// ~41k multiply-adds of MLP and ~4.3k of CG per row against ~2 kB of input;
// the backward twice the MLP's).
//
// The forward, the first design: the MLP's output for a tile of 8 rows is
// staged in shared memory (a thread owns an output column and reads its 64
// weights once per tile, 8 rows per weight); a thread owns one (instruction,
// channel) and sums the tile's rows in registers, so the sum over an atom's
// rows needs no atomics.
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
constexpr int RT = 8;            // forward rows per tile
constexpr int TERM_POOL = 4096;  // CG terms all loaded plans may hold

// instruction record (int32), live instructions only
enum {
  I_XOFF = 0, I_MUL, I_SHOFF, I_WOFF, I_MSGOFF, I_DIM3,
  I_TF0, I_TF1,   // forward terms [TF0, TF1) of the pool, sorted by p
  I_TB0, I_TB1,   // backward terms, sorted by n
  I_STRIDE
};
// si2 path record: offset of the input entry in the message, mi, mo,
// components, offset in the output row, offset in the flat weights
enum { P_IN = 0, P_MI, P_MO, P_DIM, P_OUT, P_W, P_STRIDE };

// term: m | n << 8 | p << 16, and its coefficient
__constant__ int c_idx[TERM_POOL];
__constant__ float c_coef[TERM_POOL];

struct Args {
  const int* ins;           // n_ins * I_STRIDE
  const int* slices;        // n_slices * 2: instruction, first channel
  const int* live_cols;     // n_live MLP output columns a live instruction reads
  const int* paths;         // n_paths * P_STRIDE
  const float* path_alpha;  // n_paths
  const int* col_path;      // d_out: path that writes the column, or -1
  const int* msg_path;      // d_msg: path that reads the element, or -1
  int n_ins, n_slices, n_live, n_paths;
  long n_rows;
  int group;                // input rows per output row
  int d1, f, nb, wn, d_msg, d_out;
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

__host__ __device__ inline int table_words(const Args& A) {
  return (A.n_ins * I_STRIDE + 2 * A.n_slices + 3) & ~3;
}

// the buffers of one tile of RT rows (floats)
struct Tile {
  float* x;     // RT * d1
  float* sh;    // RT * f
  float* emb;   // RT * nb
  float* ms;    // RT
  float* h0;    // RT * H
  float* h1;    // RT * H
  float* w;     // RT * wn
};

__host__ __device__ inline int tile_words(const Args& A) {
  return RT * (A.d1 + A.f + A.nb + 1 + 2 * H + A.wn);
}

__device__ __forceinline__ Tile carve_tile(const Args& A, float* p) {
  Tile T;
  T.x = p; p += RT * A.d1;
  T.sh = p; p += RT * A.f;
  T.emb = p; p += RT * A.nb;
  T.ms = p; p += RT;
  T.h0 = p; p += RT * H;
  T.h1 = p; p += RT * H;
  T.w = p;
  return T;
}

__device__ __forceinline__ void load_tables(const Args& A, int* ins_s,
                                            int* sl_s) {
  for (int i = threadIdx.x; i < A.n_ins * I_STRIDE; i += NT)
    ins_s[i] = A.ins[i];
  for (int i = threadIdx.x; i < 2 * A.n_slices; i += NT)
    sl_s[i] = A.slices[i];
}

// stage `rows` rows starting at r0 (not synced)
__device__ __forceinline__ void stage_tile(const Args& A, const Tile& T,
                                           long r0, int rows,
                                           const float* __restrict__ xg,
                                           const float* __restrict__ sh,
                                           const float* __restrict__ emb,
                                           const float* __restrict__ ms) {
  const float* xs = xg + r0 * A.d1;
  for (int i = threadIdx.x; i < rows * A.d1; i += NT) T.x[i] = xs[i];
  const float* ss = sh + r0 * A.f;
  for (int i = threadIdx.x; i < rows * A.f; i += NT) T.sh[i] = ss[i];
  const float* es = emb + r0 * A.nb;
  for (int i = threadIdx.x; i < rows * A.nb; i += NT) T.emb[i] = es[i];
  for (int i = threadIdx.x; i < RT; i += NT)
    T.ms[i] = i < rows ? ms[r0 + i] : 0.f;
}

// radial MLP of a staged tile: h0, h1 (and the activations' derivatives
// times the normalisation constant when d0/d1 are given), then
// w = (h1 @ w2) * s2 * ms in the live columns. Ends synchronised.
__device__ void mlp_tile(const Args& A, const Tile& T, int rows,
                         const float* __restrict__ w0,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2, float* d0, float* d1) {
  for (int i = threadIdx.x; i < RT * H; i += NT) {
    const int r = i / H, j = i - r * H;
    float h = 0.f, d = 0.f;
    if (r < rows) {
      float s = 0.f;
      for (int b = 0; b < A.nb; ++b)
        s = fmaf(T.emb[r * A.nb + b], __ldg(w0 + b * H + j), s);
      s *= A.s0;
      h = act_f(s, A.act) * A.act_cst;
      d = act_df(s, A.act) * A.act_cst;
    }
    T.h0[i] = h;
    if (d0) d0[i] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RT * H; i += NT) {
    const int r = i / H, j = i - r * H;
    float h = 0.f, d = 0.f;
    if (r < rows) {
      const float* hr = T.h0 + r * H;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) s = fmaf(hr[k], __ldg(w1 + k * H + j), s);
      s *= A.s1;
      h = act_f(s, A.act) * A.act_cst;
      d = act_df(s, A.act) * A.act_cst;
    }
    T.h1[i] = h;
    if (d1) d1[i] = d;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < A.n_live; i += NT) {
    const int c = __ldg(A.live_cols + i);
    float acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = 0.f;
    for (int k = 0; k < H; ++k) {
      const float wv = __ldg(w2 + (size_t)k * A.wn + c);
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = fmaf(T.h1[r * H + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) T.w[r * A.wn + c] = acc[r] * A.s2 * T.ms[r];
  }
  __syncthreads();
}

// AGG: a block owns one output row and walks its `group` input rows tile by
// tile, one message buffer. Not AGG (group = 1): a block owns RT rows, one
// message buffer each.
template <bool AGG>
__global__ void __launch_bounds__(NT)
terms_fwd_kernel(const float* __restrict__ xg, const float* __restrict__ sh,
                 const float* __restrict__ emb, const float* __restrict__ ms,
                 const float* __restrict__ w0, const float* __restrict__ w1,
                 const float* __restrict__ w2, const float* __restrict__ si2w,
                 Args A, float* __restrict__ out) {
  constexpr int NS = AGG ? 1 : RT;      // message buffers
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);
  int* sl_s = ins_s + A.n_ins * I_STRIDE;
  float* p = smem + table_words(A);
  const Tile T = carve_tile(A, p);
  float* msg_s = p + tile_words(A);     // NS * d_msg
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  long row_begin, row_end, out_row0;
  if (AGG) {
    row_begin = (long)blockIdx.x * A.group;
    row_end = row_begin + A.group;
    out_row0 = blockIdx.x;
  } else {
    row_begin = (long)blockIdx.x * RT;
    row_end = row_begin + RT < A.n_rows ? row_begin + RT : A.n_rows;
    out_row0 = row_begin;
  }
  const int n_slots = AGG ? 1 : (int)(row_end - row_begin);

  load_tables(A, ins_s, sl_s);
  for (int i = threadIdx.x; i < NS * A.d_msg; i += NT) msg_s[i] = 0.f;
  __syncthreads();

  for (long r0 = row_begin; r0 < row_end; r0 += RT) {
    const int rows = row_end - r0 < RT ? (int)(row_end - r0) : RT;
    stage_tile(A, T, r0, rows, xg, sh, emb, ms);
    __syncthreads();
    mlp_tile(A, T, rows, w0, w1, w2, nullptr, nullptr);
    // CG: a warp takes 32 channels of one instruction at a time; a thread
    // sums its channel over the tile's rows
    for (int s = warp; s < A.n_slices; s += NW) {
      const int* I = ins_s + sl_s[2 * s] * I_STRIDE;
      const int u = sl_s[2 * s + 1] + lane;
      const int mul = I[I_MUL];
      if (u >= mul) continue;
      const int xo = I[I_XOFF] + u, so = I[I_SHOFF], wo = I[I_WOFF] + u;
      float* me = msg_s + I[I_MSGOFF] + u;
      int t = I[I_TF0];
      const int t1 = I[I_TF1];
      for (int pc = 0; pc < I[I_DIM3]; ++pc) {
        int te = t;
        while (te < t1 && ((c_idx[te] >> 16) & 0xff) == pc) ++te;
        float tot = 0.f;
        for (int r = 0; r < rows; ++r) {
          if (T.ms[r] == 0.f) continue;
          const float* xr = T.x + r * A.d1 + xo;
          const float* sr = T.sh + r * A.f + so;
          float acc = 0.f;
          for (int tt = t; tt < te; ++tt) {
            const int id = c_idx[tt];
            acc = fmaf(c_coef[tt] * xr[(id & 0xff) * mul],
                       sr[(id >> 8) & 0xff], acc);
          }
          const float v = acc * T.w[r * A.wn + wo];
          if (AGG) tot += v;
          else me[(size_t)r * A.d_msg + pc * mul] = v;
        }
        if (AGG) me[pc * mul] += tot;
        t = te;
      }
    }
    __syncthreads();
  }

  // si2: a thread owns one output column; the message elements it needs are
  // the same for neighbouring columns (a broadcast), the weights coalesced
  for (int c = threadIdx.x; c < A.d_out; c += NT) {
    const int pth = __ldg(A.col_path + c);
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
    float alpha = 0.f;
    if (pth >= 0) {
      const int* P = A.paths + pth * P_STRIDE;
      const int mi = __ldg(P + P_MI), mo = __ldg(P + P_MO);
      const int rel = c - __ldg(P + P_OUT);
      const int q = rel / mo, o = rel - q * mo;
      const float* W = si2w + __ldg(P + P_W) + o;
      const float* m = msg_s + __ldg(P + P_IN) + q * mi;
      alpha = __ldg(A.path_alpha + pth);
      for (int r = 0; r < mi; ++r) {
        const float wv = __ldg(W + (size_t)r * mo);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          acc[s] = fmaf(m[(size_t)s * A.d_msg + r], wv, acc[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s < n_slots) out[(out_row0 + s) * A.d_out + c] = acc[s] * alpha;
  }
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

// gm = alpha W^T g of rows [0, groups * RB) of a tile into the compact
// cotangent (row e at e * n_msg). A unit is (path, row group, component q,
// 4 consecutive entries r); its o range is cut into L parts (L a power of
// two, at most 8, so that a part is about OC o) run by L neighbouring lanes
// and summed by an xor butterfly, so that no path's long o range runs on a
// few threads alone. Per o one 16-byte load of W^T (row o: mi entries;
// single guarded loads where rows are not 16-byte aligned) and RB rows of g
// (row-minor, stride ts; 16-byte loads with RB a multiple of 4). Each
// path's lanes start on a warp, so a warp is one path. Not synced.
constexpr int OC = 32;

__device__ __forceinline__ int gm_lanes(int mo) {
  const int np = (mo + OC - 1) / OC;
  return np > 4 ? 8 : np > 2 ? 4 : np;
}

template <int RB>
__device__ void gm_product(const Args& A, const int* gp, const float* gT,
                           int ts, int groups, float* gm, int n_msg,
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
      float* out = gm + (long)rg * RB * n_msg + G[G_CIN] + q * mi + r;
#pragma unroll
      for (int e = 0; e < RB; ++e)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (r + t < mi) out[(long)e * n_msg + t] = acc[e][t] * alpha;
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
__device__ void w_pass(const Args& A, const BArgs& B, int T,
                       const float* h1T, const float* ms_s,
                       const float* __restrict__ w2l, float* w_s) {
  const int nq = B.nls / 4, items = nq * (T / R);
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
      *reinterpret_cast<float4*>(w_s + er * B.nls + 4 * cq) = make_float4(
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
      gm_product<1>(A, gp, g_s, 1, 1, gm_s, B.n_msg, si2wt);
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
        gm_product<8>(A, gp, g_s, T, T / 8, gm_s, B.n_msg, si2wt);
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
        case 4: w_pass<4>(A, B, T, h1T, ms_s, w2l, w_s); break;
        case 8: w_pass<8>(A, B, T, h1T, ms_s, w2l, w_s); break;
        default: w_pass<16>(A, B, T, h1T, ms_s, w2l, w_s); break;
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

size_t fwd_smem(const Args& A, bool agg) {
  return sizeof(float) * ((size_t)table_words(A) + tile_words(A)
                          + (size_t)(agg ? 1 : RT) * A.d_msg);
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
  const int *ins, const int *slices, const int *live_cols, const int *paths, \
      const float *path_alpha, const int *col_path, const int *msg_path,    \
      int n_ins, int n_slices, int n_live, int n_paths, long n_rows,        \
      int agg_d, int d1, int f, int nb, int wn, int d_msg, int d_out,       \
      int act, float act_cst, float s0, float s1, float s2

static Args make_args(TERMS_ARGS) {
  Args A;
  A.ins = ins; A.slices = slices; A.live_cols = live_cols; A.paths = paths;
  A.path_alpha = path_alpha; A.col_path = col_path; A.msg_path = msg_path;
  A.n_ins = n_ins; A.n_slices = n_slices; A.n_live = n_live;
  A.n_paths = n_paths; A.n_rows = n_rows; A.group = agg_d > 0 ? agg_d : 1;
  A.d1 = d1; A.f = f; A.nb = nb; A.wn = wn; A.d_msg = d_msg; A.d_out = d_out;
  A.act = act; A.act_cst = act_cst; A.s0 = s0; A.s1 = s1; A.s2 = s2;
  return A;
}
#define TERMS_CALL                                                          \
  make_args(ins, slices, live_cols, paths, path_alpha, col_path, msg_path,  \
            n_ins, n_slices, n_live, n_paths, n_rows, agg_d, d1, f, nb, wn, \
            d_msg, d_out, act, act_cst, s0, s1, s2)

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

extern "C" int fused_conv_terms_fwd(const float* xg, const float* sh,
                                    const float* emb, const float* ms,
                                    const float* w0, const float* w1,
                                    const float* w2, const float* si2w,
                                    TERMS_ARGS, float* out, void* stream) {
  const Args A = TERMS_CALL;
  const bool agg = agg_d > 0;
  const size_t smem = fwd_smem(A, agg);
  const cudaError_t err =
      agg ? reserve_smem(terms_fwd_kernel<true>, smem)
          : reserve_smem(terms_fwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    if (agg)
      terms_fwd_kernel<true>
          <<<(unsigned)(n_rows / agg_d), NT, smem, (cudaStream_t)stream>>>(
              xg, sh, emb, ms, w0, w1, w2, si2w, A, out);
    else
      terms_fwd_kernel<false>
          <<<(unsigned)((n_rows + RT - 1) / RT), NT, smem,
             (cudaStream_t)stream>>>(xg, sh, emb, ms, w0, w1, w2, si2w, A,
                                     out);
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

// the backward instance a plan launches: registers, local bytes a thread,
// blocks an SM at `words` shared words (on the current device)
extern "C" int fused_conv_terms_bwd_resources(int agg, int words, int* out) {
  cudaFuncAttributes a;
  int per_sm = 0;
  const size_t smem = 4 * (size_t)words;
  cudaError_t err = agg ? reserve_smem(terms_bwd_kernel<true>, smem)
                        : reserve_smem(terms_bwd_kernel<false>, smem);
  if (err == cudaSuccess)
    err = agg ? cudaFuncGetAttributes(&a, terms_bwd_kernel<true>)
              : cudaFuncGetAttributes(&a, terms_bwd_kernel<false>);
  if (err == cudaSuccess)
    err = agg ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, terms_bwd_kernel<true>, NT, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, terms_bwd_kernel<false>, NT, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs; out[1] = (int)a.localSizeBytes; out[2] = per_sm;
  return 0;
}
