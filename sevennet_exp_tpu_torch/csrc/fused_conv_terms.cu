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
// ~41k multiply-adds of MLP and ~4.3k of CG per row against ~2 kB of input).
// What this simple design does about it: the MLP's output for a tile of 8
// rows is staged in shared memory (a thread owns an output column and reads
// its 64 weights once per tile, 8 rows per weight); forward, a thread owns
// one (instruction, channel) and sums the tile's rows in registers, so the
// sum over an atom's rows needs no atomics; backward, a warp owns one row,
// keeps dx of the row in shared memory, dw in a register and reduces dsh over
// the lanes by shuffles. No atomics anywhere: results are reproducible bit
// for bit. CUDA-core fp32 FMA only, no TF32.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;            // radial MLP hidden width
constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int RT = 8;            // rows per tile (= NW: backward, warp = row)
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  float* h0;    // RT * H   (backward: later d pre0)
  float* h1;    // RT * H   (backward: later d pre1)
  float* w;     // RT * wn  (backward: later dw_rad)
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

template <bool AGG>
__global__ void __launch_bounds__(NT)
terms_bwd_kernel(const float* __restrict__ gout,
                 const float* __restrict__ xg, const float* __restrict__ sh,
                 const float* __restrict__ emb, const float* __restrict__ ms,
                 const float* __restrict__ w0, const float* __restrict__ w1,
                 const float* __restrict__ w1t, const float* __restrict__ w2,
                 const float* __restrict__ w2t,
                 const float* __restrict__ si2wt, Args A,
                 float* __restrict__ dxg, float* __restrict__ dsh,
                 float* __restrict__ demb) {
  constexpr int NS = AGG ? 1 : RT;
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);
  int* sl_s = ins_s + A.n_ins * I_STRIDE;
  float* p = smem + table_words(A);
  const Tile T = carve_tile(A, p);
  p += tile_words(A);
  float* d0_s = p; p += RT * H;         // act'(pre0) * cst
  float* d1_s = p; p += RT * H;         // act'(pre1) * cst
  float* dx_s = p; p += RT * A.d1;
  float* dsh_s = p; p += RT * A.f;
  float* g_s = p; p += NS * A.d_out;    // output cotangents
  float* gm_s = p;                      // NS * d_msg message cotangents
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
  for (int i = threadIdx.x; i < NS * A.d_out; i += NT) {
    const int s = i / A.d_out, c = i - s * A.d_out;
    g_s[i] = s < n_slots ? gout[(out_row0 + s) * A.d_out + c] : 0.f;
  }
  __syncthreads();
  // message cotangent gm = si2^T g, once per output row: a thread owns one
  // message element; transposed weights make its reads coalesced
  for (int i = threadIdx.x; i < A.d_msg; i += NT) {
    const int pth = __ldg(A.msg_path + i);
    float acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = 0.f;
    float alpha = 0.f;
    if (pth >= 0) {
      const int* P = A.paths + pth * P_STRIDE;
      const int mi = __ldg(P + P_MI), mo = __ldg(P + P_MO);
      const int rel = i - __ldg(P + P_IN);
      const int q = rel / mi, r = rel - q * mi;
      const float* Wt = si2wt + __ldg(P + P_W) + r;
      const float* g = g_s + __ldg(P + P_OUT) + q * mo;
      alpha = __ldg(A.path_alpha + pth);
      for (int o = 0; o < mo; ++o) {
        const float wv = __ldg(Wt + (size_t)o * mi);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          acc[s] = fmaf(g[s * A.d_out + o], wv, acc[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) gm_s[(size_t)s * A.d_msg + i] = acc[s] * alpha;
  }
  __syncthreads();

  for (long r0 = row_begin; r0 < row_end; r0 += RT) {
    const int rows = row_end - r0 < RT ? (int)(row_end - r0) : RT;
    stage_tile(A, T, r0, rows, xg, sh, emb, ms);
    for (int i = threadIdx.x; i < RT * A.d1; i += NT) dx_s[i] = 0.f;
    for (int i = threadIdx.x; i < RT * A.f; i += NT) dsh_s[i] = 0.f;
    __syncthreads();
    mlp_tile(A, T, rows, w0, w1, w2, d0_s, d1_s);

    // CG backward: warp = row. dw of a channel stays in a register and
    // replaces the row's weight in T.w as dw_rad = dw_eff * ms
    {
      const int r = warp;
      const bool live = r < rows && T.ms[r] != 0.f;
      const float* gm = gm_s + (AGG ? 0 : (size_t)r * A.d_msg);
      float* wr = T.w + r * A.wn;
      if (live) {
        const float msr = T.ms[r];
        for (int s = 0; s < A.n_slices; ++s) {
          const int* I = ins_s + sl_s[2 * s] * I_STRIDE;
          const int u = sl_s[2 * s + 1] + lane;
          const int mul = I[I_MUL];
          const bool on = u < mul;
          const float wv = on ? wr[I[I_WOFF] + u] : 0.f;
          const float* xe = T.x + r * A.d1 + I[I_XOFF] + u;
          float* dxe = dx_s + r * A.d1 + I[I_XOFF] + u;
          const float* se = T.sh + r * A.f + I[I_SHOFF];
          const float* ge = gm + I[I_MSGOFF] + u;
          float dwv = 0.f;
          int t = I[I_TB0];
          const int t1 = I[I_TB1];
          while (t < t1) {      // one group of terms per filter component n
            const int n = (c_idx[t] >> 8) & 0xff;
            float sn = 0.f;
            for (; t < t1 && ((c_idx[t] >> 8) & 0xff) == n; ++t) {
              if (!on) continue;
              const int id = c_idx[t];
              const int m = id & 0xff, pc = (id >> 16) & 0xff;
              const float gc = ge[pc * mul] * c_coef[t];
              const float x = xe[m * mul];
              dxe[m * mul] = fmaf(gc * wv, se[n], dxe[m * mul]);
              dwv = fmaf(gc * x, se[n], dwv);
              sn = fmaf(gc, x, sn);
            }
            sn = warp_sum(sn * wv);
            if (lane == 0) dsh_s[r * A.f + I[I_SHOFF] + n] += sn;
          }
          if (on) wr[I[I_WOFF] + u] = dwv * msr;
        }
      } else {
        for (int i = lane; i < A.n_live; i += 32)
          wr[__ldg(A.live_cols + i)] = 0.f;
      }
    }
    __syncthreads();

    // MLP backward. dh1 = dw_rad @ w2^T over the live columns: a thread owns
    // one hidden unit k for two of the tile's rows
    {
      const int k = threadIdx.x & (H - 1), rg = threadIdx.x / H;   // rg < 4
      float a0 = 0.f, a1 = 0.f;
      const float* wa = T.w + rg * A.wn;
      const float* wb = T.w + (rg + NT / H) * A.wn;
      for (int i = 0; i < A.n_live; ++i) {
        const int c = __ldg(A.live_cols + i);
        const float wv = __ldg(w2t + (size_t)c * H + k);
        a0 = fmaf(wa[c], wv, a0);
        a1 = fmaf(wb[c], wv, a1);
      }
      // d pre1 over h1's buffer (h1 is not needed any more)
      T.h1[rg * H + k] = a0 * A.s2 * d1_s[rg * H + k];
      T.h1[(rg + NT / H) * H + k] = a1 * A.s2 * d1_s[(rg + NT / H) * H + k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RT * H; i += NT) {
      const int r = i / H, j = i - r * H;
      const float* dp = T.h1 + r * H;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) s = fmaf(dp[k], __ldg(w1t + k * H + j), s);
      T.h0[i] = s * A.s1 * d0_s[i];       // d pre0 over h0's buffer
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * A.nb; i += NT) {
      const int r = i / A.nb, b = i - r * A.nb;
      const float* dp = T.h0 + r * H;
      float s = 0.f;
      for (int j = 0; j < H; ++j) s = fmaf(dp[j], __ldg(w0 + b * H + j), s);
      demb[(r0 + r) * A.nb + b] = s * A.s0;
    }
    float* dxo = dxg + r0 * A.d1;
    for (int i = threadIdx.x; i < rows * A.d1; i += NT) dxo[i] = dx_s[i];
    float* dso = dsh + r0 * A.f;
    for (int i = threadIdx.x; i < rows * A.f; i += NT) dso[i] = dsh_s[i];
    __syncthreads();
  }
}

size_t fwd_smem(const Args& A, bool agg) {
  return sizeof(float) * ((size_t)table_words(A) + tile_words(A)
                          + (size_t)(agg ? 1 : RT) * A.d_msg);
}

size_t bwd_smem(const Args& A, bool agg) {
  const size_t ns = agg ? 1 : RT;
  return sizeof(float) * ((size_t)table_words(A) + tile_words(A)
                          + 2 * RT * H + (size_t)RT * (A.d1 + A.f)
                          + ns * (A.d_out + A.d_msg));
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
                                    const float* w2, const float* w2t,
                                    const float* si2wt, TERMS_ARGS,
                                    float* dxg, float* dsh, float* demb,
                                    void* stream) {
  const Args A = TERMS_CALL;
  const bool agg = agg_d > 0;
  const size_t smem = bwd_smem(A, agg);
  const cudaError_t err =
      agg ? reserve_smem(terms_bwd_kernel<true>, smem)
          : reserve_smem(terms_bwd_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    if (agg)
      terms_bwd_kernel<true>
          <<<(unsigned)(n_rows / agg_d), NT, smem, (cudaStream_t)stream>>>(
              g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2wt, A, dxg, dsh,
              demb);
    else
      terms_bwd_kernel<false>
          <<<(unsigned)((n_rows + RT - 1) / RT), NT, smem,
             (cudaStream_t)stream>>>(g, xg, sh, emb, ms, w0, w1, w1t, w2,
                                     w2t, si2wt, A, dxg, dsh, demb);
  }
  return (int)cudaGetLastError();
}
