// Bare uvu tensor product per edge row, forward and backward, for NVIDIA
// Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_tp.py:
//   fused_tp_fwd <- make_fused_tp(spec)._fwd_kernel
//   fused_tp_bwd <- make_fused_tp(spec)._bwd_kernel
//
// Per row e and instruction k (input entry x of multiplicity mul, filter
// entry sh of multiplicity 1, output entry of the same multiplicity):
//   out[e, out_off + p*mul + u] = w[e, w_off + u]
//                                 * sum_{(m,n,p,c)} c x[e, x_off + m*mul + u]
//                                                     sh[e, sh_off + n]
// No radial MLP, no sum over rows, no self-interaction. The backward
// returns dxg, dsh (a sum over the channels u) and dw, all per row.
//
// What bounds it on this card: bytes. A mid layer of 7net-0 reads 480 + 9 +
// 960 floats and writes 3,136 per row for ~1.4k multiply-adds: 0.15 flop
// per byte against a ridge of 20. So the design moves each byte once.
//
// Forward: a warp owns one row; it stages the row's x and sh in shared
// memory (x is read by several instructions), reads each weight and writes
// each output once, 32 consecutive channels per warp access. The "terms"
// of the TPU kernel -- a Python-unrolled list of (m, n, p, c) products --
// are a table in __constant__ memory here: all lanes of a warp work on the
// same instruction, so every table read is a broadcast.
//
// Backward (the VJP; it reads 2x the forward's inputs and the cotangent):
// its first form walked the same term table per (instruction, 32 channels)
// with dx read-modified-written in shared memory per term, g re-read per
// term and one warp reduction of dsh per (slice, sh component): 11.5 % of
// its byte bound at a mid layer, 87 % of it the term loop, where each
// term's g load waited on the constant read of its index. Now:
//   - the CG terms are compiled in per (l1, l2, l3) (csrc/cg_patterns.cuh,
//     l <= 3), times one scale per instruction (its path normalisation),
//     behind one warp-uniform switch per step, each body fully unrolled;
//   - a step is (x entry, 64 channels, instruction), ordered by x entry,
//     then channels, then instruction (ops/fused_tp.py::bwd_tables); a lane
//     owns channels u0 + lane and u0 + 32 + lane: it reads x once an entry,
//     w and g once an instruction, sh once a row; dx stays in registers
//     across the entry's instructions and is written once, coalesced; dw is
//     written once; dsh is summed in registers over the row's steps and
//     reduced by one warp sum per component a row;
//   - what is left is a stream of small loads with little CG work on each
//     (~7 terms a lane a step at a mid layer), held by the instructions a
//     step more than by bytes: per-lane loads one step ahead in registers
//     left the mid layers at half their byte bound. So the operands go
//     through shared memory after all: each warp keeps a ring of 3 stages,
//     the next 2 steps' x, g and w copied in by cp.async as 16-byte runs of
//     4 channels (a quarter of the copy instructions of per-channel loads;
//     across rows too: at a row's end the next row's first steps are in
//     flight), and registers hold only the step being computed; two
//     channels a lane halve the steps of entries of 64 channels or more.
//     The grid is persistent: the blocks the card holds at once.
// Instances by the sh components a lane holds (1, 4, 9, 16: a lane keeps sh
// entry l2's components in slots l2^2 .. l2^2 + 2 l2, wherever the entry
// sits in sh), the largest l of an x or output entry (0..3) and the
// channels a copy: runs of 4 (16-byte cp.async) or, where an x multiplicity
// is not a multiple of 4 or g, xg or w is not 16-byte aligned, single
// channels (4-byte cp.async), chosen per launch. The sh slots are read from
// shared memory where used: a register for them cost the instance the
// checkpoint runs its third block an SM. A spec outside these instances (an
// l above 3, two sh entries of one l, an sh entry of multiplicity above 1)
// runs the first form's table-driven body, fused_tp_bwd_table_kernel, which
// takes any spec. No atomics anywhere, so results are reproducible bit for
// bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "cg_patterns.cuh"
#include "launch_util.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NW = NT / 32;      // warps per block = rows per block
constexpr int TERM_POOL = 4096;  // CG terms all loaded plans may hold

// instruction record (int32)
enum {
  I_XOFF = 0, I_MUL, I_SHOFF, I_WOFF, I_OUTOFF, I_DIM3,
  I_TF0, I_TF1,   // forward terms [TF0, TF1) of the pool, sorted by p
  I_TB0, I_TB1,   // backward terms, sorted by n
  I_STRIDE
};

// term: m | n << 8 | p << 16, and its coefficient
__constant__ int c_idx[TERM_POOL];
__constant__ float c_coef[TERM_POOL];

struct Args {
  const int* ins;      // n_ins * I_STRIDE
  const int* slices;   // n_slices * 2: instruction, first channel
  int n_ins, n_slices;
  long n_rows;
  int d1, f, wn, d3;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// forward shared memory: the tables, then per warp a row of x and of sh
__host__ __device__ inline int table_words(const Args& A) {
  return (A.n_ins * I_STRIDE + 2 * A.n_slices + 3) & ~3;
}

__device__ __forceinline__ void load_tables(const Args& A, int* ins_s,
                                            int* sl_s) {
  for (int i = threadIdx.x; i < A.n_ins * I_STRIDE; i += NT)
    ins_s[i] = A.ins[i];
  for (int i = threadIdx.x; i < 2 * A.n_slices; i += NT)
    sl_s[i] = A.slices[i];
}

__global__ void __launch_bounds__(NT)
fused_tp_fwd_kernel(const float* __restrict__ xg,
                    const float* __restrict__ sh,
                    const float* __restrict__ w, Args A,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);
  int* sl_s = ins_s + A.n_ins * I_STRIDE;
  float* rows_s = smem + table_words(A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* x_s = rows_s + warp * (A.d1 + A.f);
  float* sh_s = x_s + A.d1;
  load_tables(A, ins_s, sl_s);
  const long row = (long)blockIdx.x * NW + warp;
  if (row < A.n_rows) {
    const float* xr = xg + row * A.d1;
    const float* sr = sh + row * A.f;
    for (int i = lane; i < A.d1; i += 32) x_s[i] = xr[i];
    for (int i = lane; i < A.f; i += 32) sh_s[i] = sr[i];
  }
  __syncthreads();
  if (row >= A.n_rows) return;
  const float* wr = w + row * A.wn;
  float* orow = out + row * A.d3;
  for (int s = 0; s < A.n_slices; ++s) {
    const int* I = ins_s + sl_s[2 * s] * I_STRIDE;
    const int u = sl_s[2 * s + 1] + lane;
    const int mul = I[I_MUL];
    if (u >= mul) continue;
    const float wv = wr[I[I_WOFF] + u];
    const float* xe = x_s + I[I_XOFF] + u;
    const float* se = sh_s + I[I_SHOFF];
    float* oe = orow + I[I_OUTOFF] + u;
    int t = I[I_TF0];
    const int t1 = I[I_TF1];
    for (int p = 0; p < I[I_DIM3]; ++p) {
      float acc = 0.f;
      for (; t < t1 && ((c_idx[t] >> 16) & 0xff) == p; ++t) {
        const int id = c_idx[t];
        acc = fmaf(c_coef[t] * xe[(id & 0xff) * mul], se[(id >> 8) & 0xff],
                   acc);
      }
      oe[p * mul] = acc * wv;
    }
  }
}

// the backward's table-driven body (its first form), for the specs the
// step instances do not take: per (instruction, 32 channels) slice, the
// n-sorted terms of the instruction record walked at run time; a lane keeps
// dw of its channel in a register, adds dx into the warp's own shared-memory
// row (only that lane ever touches that element) and dsh is reduced over
// the lanes by shuffles
__global__ void __launch_bounds__(NT)
fused_tp_bwd_table_kernel(const float* __restrict__ g,
                          const float* __restrict__ xg,
                          const float* __restrict__ sh,
                          const float* __restrict__ w, Args A,
                          float* __restrict__ dxg, float* __restrict__ dsh,
                          float* __restrict__ dw) {
  extern __shared__ float smem[];
  int* ins_s = reinterpret_cast<int*>(smem);
  int* sl_s = ins_s + A.n_ins * I_STRIDE;
  float* rows_s = smem + table_words(A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* x_s = rows_s + warp * 2 * (A.d1 + A.f);
  float* sh_s = x_s + A.d1;
  float* dx_s = sh_s + A.f;
  float* dsh_s = dx_s + A.d1;
  load_tables(A, ins_s, sl_s);
  const long row = (long)blockIdx.x * NW + warp;
  if (row < A.n_rows) {
    const float* xr = xg + row * A.d1;
    const float* sr = sh + row * A.f;
    for (int i = lane; i < A.d1; i += 32) { x_s[i] = xr[i]; dx_s[i] = 0.f; }
    for (int i = lane; i < A.f; i += 32) { sh_s[i] = sr[i]; dsh_s[i] = 0.f; }
  }
  __syncthreads();
  if (row >= A.n_rows) return;
  const float* wr = w + row * A.wn;
  const float* grow = g + row * A.d3;
  float* dwr = dw + row * A.wn;
  for (int s = 0; s < A.n_slices; ++s) {
    const int* I = ins_s + sl_s[2 * s] * I_STRIDE;
    const int u = sl_s[2 * s + 1] + lane;
    const int mul = I[I_MUL];
    const bool on = u < mul;
    const float wv = on ? wr[I[I_WOFF] + u] : 0.f;
    const float* xe = x_s + I[I_XOFF] + u;
    float* dxe = dx_s + I[I_XOFF] + u;
    const float* se = sh_s + I[I_SHOFF];
    const float* ge = grow + I[I_OUTOFF] + u;
    float dwv = 0.f;
    int t = I[I_TB0];
    const int t1 = I[I_TB1];
    while (t < t1) {          // one group of terms per filter component n
      const int n = (c_idx[t] >> 8) & 0xff;
      float sn = 0.f;
      for (; t < t1 && ((c_idx[t] >> 8) & 0xff) == n; ++t) {
        if (!on) continue;
        const int id = c_idx[t];
        const int m = id & 0xff, p = (id >> 16) & 0xff;
        const float gc = __ldg(ge + p * mul) * c_coef[t];
        const float x = xe[m * mul];
        dxe[m * mul] = fmaf(gc * wv, se[n], dxe[m * mul]);
        dwv = fmaf(gc * x, se[n], dwv);
        sn = fmaf(gc, x, sn);
      }
      sn = warp_sum(sn * wv);
      if (lane == 0) dsh_s[I[I_SHOFF] + n] += sn;
    }
    // an instruction without terms leaves its weight columns at zero
    if (on) dwr[I[I_WOFF] + u] = dwv;
  }
  __syncwarp();
  float* dxr = dxg + row * A.d1;
  float* dsr = dsh + row * A.f;
  for (int i = lane; i < A.d1; i += 32) dxr[i] = dx_s[i];
  for (int i = lane; i < A.f; i += 32) dsr[i] = dsh_s[i];
}

// ---------------------------------------------------------------------
// backward: steps of (x entry, 64 channels, instruction), CG at compile time
// ---------------------------------------------------------------------

// step record (int32), ops/fused_tp.py::bwd_tables: one row's steps in the
// order a warp runs them, by x entry, then block of 64 channels, then the
// instructions that read the entry (an entry no instruction reads is one
// step of key NO_INS, which writes its dx as zeros)
enum {
  S_XOFF = 0, S_MUL, S_U0, S_D1, S_KEY, S_WOFF, S_OUTOFF, S_SCALE, S_FLAGS,
  S_STRIDE
};
enum { F_FIRST = 1, F_LAST = 2 };   // the first / last step of an x item
constexpr int NO_INS = -1;
constexpr int NTB = 256;            // backward: threads per block
constexpr int NWB = NTB / 32;
constexpr int CH = 2;               // channels a lane: u0 + lane, + 32
constexpr int SC = CH * 32;         // channels a step
constexpr int KST = 3;              // stages of a warp's ring: 2 steps ahead

struct BwdArgs {
  const int* steps;
  const int* slots;    // per sh column: its slot l2^2 + n in a lane's sh
  int n_steps;
  long n_rows;
  int d1, f, wn, d3;
};

// the step records, then the f sh slots (at most 16), in shared memory
__host__ __device__ inline int bwd_table_ints(int n_steps) {
  return (n_steps * S_STRIDE + 16 + 3) & ~3;
}

// 16 (a 16-byte aligned run of 4 channels) or 4 (one channel) bytes into
// shared memory; zeros where `on` is false
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(on ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool on) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(on ? 4 : 0));
}

// `rows` rows of a step's SC channels, u0 .. u0 + SC - 1 (row stride mul in
// memory, SC in the stage), copied by the warp in runs of V channels;
// zeros past the entry's multiplicity (`any`: a valid address for them)
template <int V>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          const float* any, int rows,
                                          int mul, int u0, int lane) {
  constexpr int Q = SC / V;           // runs a row
  for (int k = lane; k < rows * Q; k += 32) {
    const int m = k / Q, q = k % Q;
    const bool on = u0 + V * q < mul;
    const float* at = on ? src + m * mul + V * q : any;
    if constexpr (V == 4)
      cp_async16(dst + m * SC + V * q, at, on);
    else
      cp_async4(dst + m * SC + V * q, at, on);
  }
}

// one ring stage of a warp: a step's x rows and g rows (component-major,
// SC channels each), its w and the row's sh
template <int DM>
struct Stage {
  static constexpr int X = 0, G = DM * SC, W = 2 * DM * SC,
                       SH = (2 * DM + 1) * SC, FLOATS = SH + 16;
  static_assert(FLOATS % 4 == 0, "stages stay 16-byte aligned");
};

// copy the operands of one step on row r into a stage: sh at a row's first
// step (lane < f: its column, into its slot), x at an item's first step,
// the instruction's weights and cotangent; zeros past the entry's
// multiplicity. The lanes copy consecutive runs of RUN channels (RUN = 4
// where every multiplicity is a multiple of 4 and g, xg and w are 16-byte
// aligned: the launcher checks).
template <int DM, int RUN>
__device__ __forceinline__ void fetch_step(
    const int* S, const int* slot_s, long r, bool row_start, int lane,
    const BwdArgs& A, const float* __restrict__ g,
    const float* __restrict__ xg, const float* __restrict__ sh,
    const float* __restrict__ w, float* st) {
  using T = Stage<DM>;
  const int key = S[S_KEY], mul = S[S_MUL], u0 = S[S_U0];
  if (row_start && lane < A.f)
    cp_async4(st + T::SH + slot_s[lane], sh + r * A.f + lane, true);
  if (key != NO_INS) {
    if (S[S_FLAGS] & F_FIRST)
      copy_rows<RUN>(st + T::X, xg + r * A.d1 + S[S_XOFF] + u0, xg,
                     S[S_D1], mul, u0, lane);
    const int d3 = 2 * (key & 3) + 1;
    copy_rows<RUN>(st + T::G, g + r * A.d3 + S[S_OUTOFF] + u0, g, d3, mul,
                   u0, lane);
    copy_rows<RUN>(st + T::W, w + r * A.wn + S[S_WOFF] + u0, w, 1, mul, u0,
                   lane);
  }
  asm volatile("cp.async.commit_group;");
}

// one instruction on one channel: with gm = scale g (the instruction's path
// normalisation against the pattern's), T_m = sum c gm_p sh_n and
// V_n = sum c gm_p x_m over its terms; dw = x . T, dx += w T, dsh += w V
template <int NSH, int DM, int L1, int L2, int L3>
__device__ __forceinline__ void bwd_step(float sc, float wv,
                                         const float (&gv)[DM],
                                         const float (&xv)[DM],
                                         const float (&sv)[NSH],
                                         float (&dx)[DM], float (&dsa)[NSH],
                                         float& dwv) {
  constexpr int D1 = 2 * L1 + 1, D2 = 2 * L2 + 1, D3 = 2 * L3 + 1;
  float gm[D3], t[D1], v[D2];
#pragma unroll
  for (int p = 0; p < D3; ++p) gm[p] = gv[p] * sc;
#pragma unroll
  for (int m = 0; m < D1; ++m) t[m] = 0.f;
#pragma unroll
  for (int n = 0; n < D2; ++n) v[n] = 0.f;
  CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
    const float gg = cf * gm[decltype(p)::value];
    t[decltype(m)::value] = fmaf(gg, sv[L2 * L2 + decltype(n)::value],
                                 t[decltype(m)::value]);
    v[decltype(n)::value] = fmaf(gg, xv[decltype(m)::value],
                                 v[decltype(n)::value]);
  });
  float d = 0.f;
#pragma unroll
  for (int m = 0; m < D1; ++m) {
    d = fmaf(xv[m], t[m], d);
    dx[m] = fmaf(wv, t[m], dx[m]);
  }
#pragma unroll
  for (int n = 0; n < D2; ++n)
    dsa[L2 * L2 + n] = fmaf(wv, v[n], dsa[L2 * L2 + n]);
  dwv = d;
}

// NSH: sh slots a lane holds (1, 4, 9, 16: sh entry l2 in slots l2^2 ..);
// LM: the largest l of an x entry or an output entry; RUN: channels a copy
// (4 or 1). A warp owns a row at a time (rows warp, warp + all warps, ...)
// and walks its steps; its ring holds the operands of the next KST - 1
// steps (across rows too) in flight.
template <int NSH, int LM, int RUN>
__global__ void __launch_bounds__(NTB)
fused_tp_bwd_kernel(const float* __restrict__ g,
                    const float* __restrict__ xg,
                    const float* __restrict__ sh,
                    const float* __restrict__ w, BwdArgs A,
                    float* __restrict__ dxg, float* __restrict__ dsh,
                    float* __restrict__ dw) {
  constexpr int DM = 2 * LM + 1;
  using T = Stage<DM>;
  extern __shared__ __align__(16) int st_s[];
  const int* slot_s = st_s + A.n_steps * S_STRIDE;
  float* ring = reinterpret_cast<float*>(st_s + bwd_table_ints(A.n_steps))
                + (threadIdx.x >> 5) * KST * T::FLOATS;
  const int lane = threadIdx.x & 31;
  // the sh slots no column fills stay zero in every stage
  for (int i = lane; i < KST * 16; i += 32)
    ring[(i / 16) * T::FLOATS + T::SH + i % 16] = 0.f;
  for (int i = threadIdx.x; i < A.n_steps * S_STRIDE; i += NTB)
    st_s[i] = A.steps[i];
  if (threadIdx.x < A.f) st_s[A.n_steps * S_STRIDE + threadIdx.x] =
      A.slots[threadIdx.x];
  __syncthreads();
  const long n_warps = (long)gridDim.x * NWB;
  long row = (long)blockIdx.x * NWB + (threadIdx.x >> 5);
  if (row >= A.n_rows) return;
  long frow = row;                 // the next step to fetch: (frow, fs)
  int fs = 0;
  auto issue = [&](int k) {        // into stage k % KST, or an empty group
    if (frow < A.n_rows) {
      fetch_step<DM, RUN>(st_s + fs * S_STRIDE, slot_s, frow, fs == 0, lane,
                          A, g, xg, sh, w, ring + (k % KST) * T::FLOATS);
      if (++fs == A.n_steps) {
        fs = 0;
        frow += n_warps;
      }
    } else {
      asm volatile("cp.async.commit_group;");
    }
  };
  for (int k = 0; k < KST - 1; ++k) issue(k);
  float sv[NSH], xv[CH][DM], gv[CH][DM], wv[CH];
  float dx[CH][DM], dsa[NSH];
#pragma unroll
  for (int n = 0; n < NSH; ++n) dsa[n] = 0.f;
  int s = 0;
  for (int k = 0;; ++k) {
    // step k has landed (this lane's copies, then every lane's), and every
    // lane is done with stage k - 1, which the next fetch overwrites
    asm volatile("cp.async.wait_group %0;" :: "n"(KST - 2) : "memory");
    __syncwarp();
    issue(k + KST - 1);
    const float* st = ring + (k % KST) * T::FLOATS;
    const int* S = st_s + s * S_STRIDE;
    const long r = row;
    const int flags = S[S_FLAGS], key = S[S_KEY], mul = S[S_MUL];
    if (s == 0) {
#pragma unroll
      for (int n = 0; n < NSH; ++n) sv[n] = st[T::SH + n];
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (flags & F_FIRST) {
#pragma unroll
        for (int m = 0; m < DM; ++m) {
          xv[c][m] = st[T::X + m * SC + 32 * c + lane];
          dx[c][m] = 0.f;
        }
      }
#pragma unroll
      for (int p = 0; p < DM; ++p) gv[c][p] = st[T::G + p * SC + 32 * c + lane];
      wv[c] = st[T::W + 32 * c + lane];
    }
    const bool row_end = s == A.n_steps - 1;
    if (row_end) {
      s = 0;
      row += n_warps;
    } else {
      ++s;
    }
    const float sc = __int_as_float(S[S_SCALE]);
    float dwv[CH];
    switch (key) {
#define TP_BWD_CASE(a, b, c)                                                \
      case a * 16 + b * 4 + c:                                              \
        if constexpr (a <= LM && c <= LM && (b + 1) * (b + 1) <= NSH) {     \
          _Pragma("unroll")                                                 \
          for (int h = 0; h < CH; ++h)                                      \
            bwd_step<NSH, DM, a, b, c>(sc, wv[h], gv[h], xv[h], sv, dx[h],  \
                                       dsa, dwv[h]);                        \
        }                                                                   \
        break;
      CG_SHAPES(TP_BWD_CASE)
#undef TP_BWD_CASE
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = S[S_U0] + 32 * c + lane;
      if (u >= mul) continue;
      if (key != NO_INS) dw[r * A.wn + S[S_WOFF] + u] = dwv[c];
      if (flags & F_LAST) {
        float* dr = dxg + r * A.d1 + S[S_XOFF] + u;
#pragma unroll
        for (int m = 0; m < DM; ++m)
          if (m < S[S_D1]) dr[m * mul] = dx[c][m];
      }
    }
    if (row_end) {           // the row's dsh: one warp sum per slot
      const int slot = lane < A.f ? slot_s[lane] : -1;
      float mine = 0.f;
#pragma unroll
      for (int n = 0; n < NSH; ++n) {
        const float t = warp_sum(dsa[n]);
        if (slot == n) mine = t;
        dsa[n] = 0.f;
      }
      if (lane < A.f) dsh[r * A.f + lane] = mine;
      if (row >= A.n_rows) break;
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

Args make_args(const int* ins, const int* slices, int n_ins, int n_slices,
               long n_rows, int d1, int f, int wn, int d3) {
  Args A;
  A.ins = ins; A.slices = slices; A.n_ins = n_ins; A.n_slices = n_slices;
  A.n_rows = n_rows; A.d1 = d1; A.f = f; A.wn = wn; A.d3 = d3;
  return A;
}

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int NSH, int LM, int RUN>
cudaError_t launch_bwd(const float* g, const float* xg, const float* sh,
                       const float* w, const BwdArgs& A, float* dxg,
                       float* dsh, float* dw, cudaStream_t stream) {
  static launch_util::Resident resident;    // this instance's, per device
  auto kernel = fused_tp_bwd_kernel<NSH, LM, RUN>;
  const size_t smem = sizeof(int) * (size_t)bwd_table_ints(A.n_steps) +
                      sizeof(float) * NWB * KST * Stage<2 * LM + 1>::FLOATS;
  if (A.n_rows <= 0) return cudaSuccess;
  unsigned blocks = 0;
  const cudaError_t err = launch_util::persistent_grid(
      kernel, NTB, smem, (A.n_rows + NWB - 1) / NWB, resident, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, NTB, smem, stream>>>(g, xg, sh, w, A, dxg, dsh, dw);
  return cudaGetLastError();
}

}  // namespace

// copy n terms of a plan into the constant pool at `offset` (host arrays)
extern "C" int fused_tp_upload(int offset, int n, const int* idx,
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

extern "C" int fused_tp_pool_size() { return TERM_POOL; }

extern "C" int fused_tp_fwd(const float* xg, const float* sh, const float* w,
                            const int* ins, const int* slices, int n_ins,
                            int n_slices, long n_rows, int d1, int f, int wn,
                            int d3, float* out, void* stream) {
  const Args A = make_args(ins, slices, n_ins, n_slices, n_rows, d1, f, wn,
                           d3);
  const size_t smem =
      sizeof(float) * ((size_t)table_words(A) + (size_t)NW * (d1 + f));
  const cudaError_t err = reserve_smem(fused_tp_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + NW - 1) / NW);
    fused_tp_fwd_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(
        xg, sh, w, A, out);
  }
  return (int)cudaGetLastError();
}

// the table-driven backward: the forward's instruction records and slices,
// their n-sorted terms in the constant pool; any spec
extern "C" int fused_tp_bwd_table(const float* g, const float* xg,
                                  const float* sh, const float* w,
                                  const int* ins, const int* slices,
                                  int n_ins, int n_slices, long n_rows,
                                  int d1, int f, int wn, int d3, float* dxg,
                                  float* dsh, float* dw, void* stream) {
  const Args A = make_args(ins, slices, n_ins, n_slices, n_rows, d1, f, wn,
                           d3);
  const size_t smem =
      sizeof(float) * ((size_t)table_words(A) + (size_t)NW * 2 * (d1 + f));
  const cudaError_t err = reserve_smem(fused_tp_bwd_table_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + NW - 1) / NW);
    fused_tp_bwd_table_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(
        g, xg, sh, w, A, dxg, dsh, dw);
  }
  return (int)cudaGetLastError();
}

// steps: n_steps records of S_STRIDE ints, slots: f ints
// (ops/fused_tp.py::bwd_tables); nsh in {1, 4, 9, 16} with every slot
// below nsh and f <= 16, lm in 0..3; run 4 only where every x multiplicity
// is a multiple of 4 (1 otherwise), lowered to 1 here where g, xg or w is
// not 16-byte aligned
extern "C" int fused_tp_bwd(const float* g, const float* xg, const float* sh,
                            const float* w, const int* steps,
                            const int* slots, int n_steps, int nsh, int lm,
                            int run, long n_rows, int d1, int f, int wn,
                            int d3, float* dxg, float* dsh, float* dw,
                            void* stream) {
  if (n_steps < 1 || f > nsh || lm < 0 || lm > 3 || (run != 1 && run != 4))
    return (int)cudaErrorInvalidValue;
  BwdArgs A;
  A.steps = steps; A.slots = slots; A.n_steps = n_steps; A.n_rows = n_rows;
  A.d1 = d1; A.f = f; A.wn = wn; A.d3 = d3;
  const uintptr_t bases = (uintptr_t)g | (uintptr_t)xg | (uintptr_t)w;
  const bool runs = run == 4 && bases % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define TP_BWD_LM(N, L)                                                      \
  case L:                                                                    \
    return (int)(runs ? launch_bwd<N, L, 4>(g, xg, sh, w, A, dxg, dsh, dw,  \
                                            st)                             \
                      : launch_bwd<N, L, 1>(g, xg, sh, w, A, dxg, dsh, dw,  \
                                            st));
#define TP_BWD_NSH(N)                                                        \
  case N:                                                                    \
    switch (lm) {                                                            \
      TP_BWD_LM(N, 0) TP_BWD_LM(N, 1) TP_BWD_LM(N, 2) TP_BWD_LM(N, 3)        \
    }                                                                        \
    break;
  switch (nsh) {
    TP_BWD_NSH(1) TP_BWD_NSH(4) TP_BWD_NSH(9) TP_BWD_NSH(16)
  }
#undef TP_BWD_NSH
#undef TP_BWD_LM
  return (int)cudaErrorInvalidValue;
}
