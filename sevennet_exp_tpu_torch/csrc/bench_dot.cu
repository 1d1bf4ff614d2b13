// Small-matmul cost law on NVIDIA Hopper (sm_90a): out[g] = C^T Z[g] for
// G slices Z[g] (K, N), C (K, M), fp32 out -- in fp32 on the CUDA cores, or
// with the inputs rounded to bf16 in the kernel and multiplied on the
// tensor cores with fp32 accumulation.
//
// Replaces the TPU kernel of tools/bench_dot.py (bench(K, M, N, dtype), run
// through pl.pallas_call over a grid of G steps: dot_general of C and one
// Z slice per step, bf16 inputs cast inside the kernel).
//
// What bounds them: bytes for the CG-sized shapes (K, M <= 64 and the
// (8, 128) / (128, 8) pair: at most ~8 multiply-adds per byte moved, under
// fp32's ridge of ~10), operations for K = M = 128 in fp32. So fp32 has two
// kernels, and tools/bench_dot.py::plan picks one per launch and gives it
// its tiles, grid and shared memory:
//
//   dot_fp32_stream  (shapes bound by bytes) a block stages all of C once,
//             holds all of M for its BN-column tile (BN = 128 or 256), so
//             Z is read from device memory once, and walks the tiles
//             blockIdx.x, + gridDim.x, ... (two blocks an SM) with their
//             K x BN Z pieces streamed through
//             a 3-stage cp.async ring (K split into chunks of at most 32 KB
//             a stage). A thread owns TM rows x CW = 4 (or, where the FFMAs
//             near the bytes' time, 8) columns: z as 16-byte loads, its C
//             rows as 16-byte broadcasts, outputs stored straight from
//             registers as float4 streaming stores. M is padded to
//             256 / (BN / CW) x TM rows, K not at all.
//   dot_fp32_tile    (shapes bound by operations) a register-blocked SGEMM:
//             128 x 128 output tiles, 256 threads of 8 x 8 outputs, K in
//             steps of 8 through a 4-stage cp.async ring with one
//             __syncthreads a step; per k a thread reads 2 + 2 16-byte
//             vectors (C^T broadcast within each quarter warp, Z
//             conflict-free) for 64 FFMA; a row of C in one 16-byte copy
//             when M % 4 == 0. One tile a block.
//   dot_bf16  (redesigned for Hopper) mma.sync.m16n8k16 bf16 x bf16 -> fp32
//             on a persistent grid that walks the (slice, N tile) tiles of
//             one 128-row block of M, which it holds whole, so Z is read
//             once (M <= 128). C^T is rounded to bf16 once per block and
//             kept as A fragments in registers for the whole walk (K <= 128:
//             KS k16 steps). Z's kc x bn pieces (at most 16 KB) stream
//             through a cp.async ring of 4 stages (two blocks an SM) or, for
//             tiles of one or two pieces and K <= 64, of 8 (one block an
//             SM: more bytes in flight); each landed piece is rounded to
//             bf16 once, into a padded layout that ldmatrix.trans reads as
//             B fragments with no bank conflict, one barrier an item. The 8
//             warps own M16 strips where M allows and split the tile's
//             columns otherwise (32 or 64 a warp). A warp's sums go out
//             through its staging tile, 8 rows of up to 64 columns at a
//             time, as whole 128-byte lines of float4 streaming stores,
//             beside the ring's loads of the next tiles.
//             tools/bench_dot.py::plan(..., dtype='bf16') gives the launch.
//
// No TF32, no fast math: the fp32 kernels are FFMA on the CUDA cores.
// N must be a multiple of 128; the bf16 kernel takes K <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int BN = 128;          // N must be a multiple of this

// -- cp.async: 16 bytes (L2 only) or 4 bytes, zero-filled when !pred ------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// -- streaming class ----------------------------------------------------
constexpr int SS = 3;            // stages of the Z ring

// a thread's C rows are stored padded to a 16-byte vector (8 bytes for 2)
__host__ __device__ constexpr int tm_pad(int tm) {
  return tm <= 2 ? tm : (tm + 3) / 4 * 4;
}

// rows i0 .. i0 + V - 1 of a thread's C rows: one 16-byte load (8 for 2)
template <int V>
__device__ __forceinline__ void load_rows(const float* src, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = src[0];
  }
}

// shared memory: c_s (K, tmg, TMP) -- c_s[k][mg][i] = C[k][mg TM + i], 0
// past M or TM -- then SS stages of kc x bn floats of Z. A thread owns TM
// rows and CW = 4 or 8 columns: 4 at n0 + 4 tn, and for 8 another 4 at
// n0 + bn / 2 + 4 tn, so that a quarter warp reads 128 contiguous bytes
// of a Z row each time (no bank conflict) and stores 128 contiguous bytes
// of an output row.
template <int TM, int CW>
__global__ void __launch_bounds__(NT, 2)
dot_fp32_stream_kernel(const float* __restrict__ C,
                       const float* __restrict__ Z, int G, int K, int M,
                       long N, int bn, int kc, float* __restrict__ out) {
  constexpr int TMP = tm_pad(TM), NQ = CW / 4;
  extern __shared__ __align__(16) float sm[];
  const int tpr = bn / CW;                // threads across n
  const int tmg = NT / tpr;               // thread groups across m
  const int tid = threadIdx.x, tn = tid % tpr, mg = tid / tpr;
  const int half = bn / NQ;               // offset of a thread's 2nd quad
  const int c_len = (K * tmg * TMP + 3) / 4 * 4;
  float* c_s = sm;
  float* z_s = sm + c_len;
  const int stage = kc * bn;
  for (int i = tid; i < K * tmg * TMP; i += NT) {
    const int k = i / (tmg * TMP), rest = i % (tmg * TMP);
    const int t = rest % TMP, m = (rest / TMP) * TM + t;
    c_s[i] = (t < TM && m < M) ? C[(long)k * M + m] : 0.f;
  }
  const long ntn = N / bn, tiles = (long)G * ntn;
  const int nkc = (K + kc - 1) / kc, q_row = bn / 4;
  const long mine =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long items = mine * nkc;          // (tile, K chunk) pairs, in order
  auto issue = [&](long item) {
    if (item < items) {
      const long t = blockIdx.x + (item / nkc) * gridDim.x;
      const int k0 = (int)(item % nkc) * kc, kl = min(kc, K - k0);
      const float* src = Z + ((t / ntn) * K + k0) * N + (t % ntn) * bn;
      float* dst = z_s + (int)(item % SS) * stage;
      for (int q = tid; q < kl * q_row; q += NT) {
        const int row = q / q_row, c4 = q % q_row;
        cp_async16(dst + row * bn + 4 * c4, src + (long)row * N + 4 * c4,
                   true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < SS - 1; ++s) issue(s);
  float acc[TM][CW];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  for (long it = 0; it < items; ++it) {
    cp_async_wait<SS - 2>();              // item it has landed
    __syncthreads();                      // ... for all; item it - 1 is done
    issue(it + SS - 1);                   // into item it - 1's stage
    const int ch = (int)(it % nkc), k0 = ch * kc, kl = min(kc, K - k0);
    const float* zs = z_s + (int)(it % SS) * stage + 4 * tn;
    const float* cs = c_s + ((long)k0 * tmg + mg) * TMP;
#pragma unroll 1  // unrolled, the loads of later k steps cost registers
    for (int k = 0; k < kl; ++k) {
      float z[CW];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float4 zq =
            *reinterpret_cast<const float4*>(zs + k * bn + q * half);
        z[4 * q] = zq.x; z[4 * q + 1] = zq.y;
        z[4 * q + 2] = zq.z; z[4 * q + 3] = zq.w;
      }
      // the C rows a vector at a time, each used at once (at TM = 16 a
      // whole row of 16 would not fit beside the 64 sums)
      constexpr int V = TMP < 4 ? TMP : 4;
#pragma unroll
      for (int i0 = 0; i0 < TM; i0 += V) {
        float cv[V];
        load_rows<V>(cs + k * tmg * TMP + i0, cv);
#pragma unroll
        for (int i = i0; i < i0 + V && i < TM; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c)
            acc[i][c] = fmaf(cv[i - i0], z[c], acc[i][c]);
      }
    }
    if (ch == nkc - 1) {
      // the output is written once and not read again: streaming stores
      const long t = blockIdx.x + (it / nkc) * gridDim.x;
      float* o = out + (t / ntn) * M * N + (t % ntn) * bn + 4 * tn;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = mg * TM + i;
        if (m < M) {
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            __stcs(reinterpret_cast<float4*>(o + (long)m * N + q * half),
                   make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                               acc[i][4 * q + 2], acc[i][4 * q + 3]));
        }
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
      }
    }
  }
}

// -- compute class: register-blocked SGEMM ------------------------------
constexpr int TBM = 128, TBN = 128, TBK = 8, TS = 4;
constexpr int TILE_SMEM = (int)sizeof(float) * TS * TBK * (TBM + TBN);

// shared memory: TS stages of a_s (TBK, TBM) = C rows, then b_s (TBK, TBN);
// grid (m tiles, N / TBN, G)
__global__ void __launch_bounds__(NT, 2)
dot_fp32_tile_kernel(const float* __restrict__ C, const float* __restrict__ Z,
                     int K, int M, long N, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* a_s = sm;                              // [TS][TBK][TBM]
  float* b_s = sm + TS * TBK * TBM;             // [TS][TBK][TBN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * TBM;
  const long n0 = (long)blockIdx.y * TBN;
  const float* Zg = Z + (long)blockIdx.z * K * N + n0;
  const int nk = (K + TBK - 1) / TBK;
  // rows of C are 16-byte aligned when M % 4 == 0: one 16-byte copy a
  // thread; else four 4-byte copies
  const bool vec = M % 4 == 0;
  auto issue = [&](int kt) {
    if (kt < nk) {
      float* as = a_s + (kt % TS) * TBK * TBM;
      if (vec) {
#pragma unroll
        for (int q = 0; q < TBK * TBM / 4 / NT; ++q) {
          const int i = tid + q * NT, kk = i / (TBM / 4), c4 = i % (TBM / 4);
          const int k = kt * TBK + kk, m = m0 + 4 * c4;
          const bool ok = k < K && m < M;
          cp_async16(as + kk * TBM + 4 * c4, ok ? C + (long)k * M + m : C,
                     ok);
        }
      } else {
#pragma unroll
        for (int q = 0; q < TBK * TBM / NT; ++q) {
          const int i = tid + q * NT, kk = i / TBM, mm = i % TBM;
          const int k = kt * TBK + kk, m = m0 + mm;
          const bool ok = k < K && m < M;
          cp_async4(as + i, ok ? C + (long)k * M + m : C, ok);
        }
      }
#pragma unroll
      for (int q = 0; q < TBK * TBN / 4 / NT; ++q) {
        const int i = tid + q * NT, kk = i / (TBN / 4), c4 = i % (TBN / 4);
        const int k = kt * TBK + kk;
        cp_async16(b_s + (kt % TS) * TBK * TBN + kk * TBN + 4 * c4,
                   k < K ? Zg + (long)k * N + 4 * c4 : Zg, k < K);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < TS - 1; ++s) issue(s);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TS - 2>();              // step kt has landed
    __syncthreads();                      // ... for all; step kt - 1 is done
    issue(kt + TS - 1);                   // into step kt - 1's stage
    const float* as = a_s + (kt % TS) * TBK * TBM;
    const float* bs = b_s + (kt % TS) * TBK * TBN;
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TBM + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * TBM + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TBN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TBN + 64 + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* o = out + (long)blockIdx.z * M * N + n0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (m < M) {
      __stcs(reinterpret_cast<float4*>(o + (long)m * N + 4 * tx),
             make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      __stcs(reinterpret_cast<float4*>(o + (long)m * N + 64 + 4 * tx),
             make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -- bf16 class: mma.sync on Z streamed once ------------------------------
constexpr int NW = NT / 32;             // warps a block
// stages of the Z ring: a tile of one or two items (K chunks) of K <= 64
// runs one block an SM on the deep ring (more bytes in flight an SM), a
// longer tile, or K > 64 (A fragments of 8 k16 steps), two blocks on the
// short one
constexpr int BF_STAGES = 4, BF_DEEP = 8;
constexpr int BF_STAGE_BYTES = 16 * 1024;
constexpr int BF_MT = 128;              // rows of M a block holds
constexpr int SWMAX = 64;               // most columns a staging pass

// four 8 x 8 bf16 matrices of shared memory, transposed: lanes 8 i .. 8 i
// + 7 give the rows of matrix i, register i holds its fragment
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += A B: A m16 x k16 (a[0..3]), B k16 x n8 (b0, b1), fp32 sums
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// shared memory: `stages` stages of kc x bn floats of Z (the ring), the
// warps' staging tiles (8 rows x OSP floats each), then BF_PIECES landed
// pieces in bf16, each kcp = kc rounded up to 16 rows of bn + 8 (the pad
// puts the 8 rows of an ldmatrix on 8 distinct 16-byte bank groups). One
// barrier an item: after it, item it + 1's stage is rounded into its piece
// while the warps multiply item it's, rounded the item before. Two pieces
// suffice: the piece rounded in item it was last read in item it - 1,
// before that barrier, and is read next after the barrier of item it + 1.
// Warp w owns the M16 strip w / wn and the 8 NT8 columns (w % wn) 8 NT8 of
// each tile: its n8 sums acc[j] are the mma D fragments (rows gid, gid + 8;
// columns 2 tig, 2 tig + 1). Rows k >= K of A and of a piece are zeros.
// The walk's indices are 32-bit cursors stepped an item at a time.
constexpr int BF_PIECES = 2;

struct Cursor {
  int g, nt, ch;          // slice, N tile, K chunk of an item
};

template <int KS, int NT8>
__global__ void __launch_bounds__(NT, 2)
dot_bf16_kernel(const float* __restrict__ C, const float* __restrict__ Z,
                int G, int K, int M, long N, int wn, int kc, int stages,
                float* __restrict__ out) {
  constexpr int WN = 8 * NT8;           // columns a warp
  constexpr int SW = WN < SWMAX ? WN : SWMAX, OSP = SW + 8;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int bn = wn * WN, zp = bn + 8, stage = kc * bn;
  const int lq = 31 - __clz(bn / 4);      // a row of a stage: 1 << lq float4
  const int piece = ((kc + 15) & ~15) * zp;
  float* ost = sm + stages * stage + warp * 8 * OSP;
  __nv_bfloat16* zb =
      reinterpret_cast<__nv_bfloat16*>(sm + stages * stage + NW * 8 * OSP);
  const int m0 = blockIdx.y * BF_MT + 16 * (warp / wn);
  const int c0 = (warp % wn) * WN;
  // A = C^T (m rows, k columns), rounded once: fragment q of step ks holds
  // rows gid (+8 for q odd), columns 16 ks + 2 tig (+1) (+8 for q >= 2)
  uint32_t a[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * ks + 2 * tig + 8 * (q >> 1);
      const int m = m0 + gid + 8 * (q & 1);
      const bool in = m < M;
      a[ks][q] = pack_bf16(in && k < K ? C[(long)k * M + m] : 0.f,
                           in && k + 1 < K ? C[(long)(k + 1) * M + m] : 0.f);
    }
  // the block's tiles: blockIdx.x, + gridDim.x, ... of the G x ntn (slice,
  // N tile) pairs, each as nkc items (K chunks) in order
  const int ntn = (int)((N + bn - 1) / bn), tiles = G * ntn;
  const int nkc = (K + kc - 1) / kc, bx = blockIdx.x, nb = gridDim.x;
  const int items = bx < tiles ? ((tiles - 1 - bx) / nb + 1) * nkc : 0;
  const int step_g = nb / ntn, step_n = nb % ntn;
  auto advance = [&](Cursor& c) {
    if (++c.ch == nkc) {
      c.ch = 0;
      c.g += step_g;
      c.nt += step_n;
      if (c.nt >= ntn) {
        c.nt -= ntn;
        ++c.g;
      }
    }
  };
  Cursor ci = {bx / ntn, bx % ntn, 0};    // the item issued next
  Cursor cm = ci;                         // the item multiplied next
  auto issue = [&](int item) {
    if (item < items) {
      const int k0 = ci.ch * kc, kl = min(kc, K - k0);
      const long n0 = (long)ci.nt * bn;
      const float* src = Z + ((long)ci.g * K + k0) * N + n0;
      float* dst = sm + (item & (stages - 1)) * stage;
      for (int q = tid; q < (kl << lq); q += NT) {
        const int row = q >> lq, c4 = q & ((1 << lq) - 1);
        const bool in = n0 + 4 * c4 < N;  // the last tile may be half
        cp_async16(dst + row * bn + 4 * c4,
                   in ? src + (long)row * N + 4 * c4 : Z, in);
      }
      advance(ci);
    }
    cp_async_commit();
  };
  // item's landed stage rounded to bf16 once (nearest even) into its
  // piece, zero past the chunk's kl rows up to a whole k16 step
  auto round_piece = [&](int item, int ch) {
    const int kl = min(kc, K - ch * kc), rows = (kl + 15) & ~15;
    const float* zs = sm + (item & (stages - 1)) * stage;
    __nv_bfloat16* zd = zb + (item % BF_PIECES) * piece;
    for (int q = tid; q < (rows << lq); q += NT) {
      const int row = q >> lq, c4 = q & ((1 << lq) - 1);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < kl)
        v = *reinterpret_cast<const float4*>(zs + row * bn + 4 * c4);
      *reinterpret_cast<uint2*>(zd + row * zp + 4 * c4) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
  };
  const bool deep = stages == BF_DEEP;
  for (int s = 0; s < stages - 1; ++s) issue(s);
  if (deep)                               // item 0 has landed
    cp_async_wait<BF_DEEP - 2>();
  else
    cp_async_wait<BF_STAGES - 2>();
  __syncthreads();
  if (items > 0) round_piece(0, 0);
  float acc[NT8][4];
#pragma unroll
  for (int j = 0; j < NT8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // this lane's row address of each ldmatrix: matrices (k 0-7, n 0-7),
  // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of a column pair
  const int mat = lane >> 3;
  const int lrow = ((mat & 1) * 8 + (lane & 7)) * zp + c0 + (mat >> 1) * 8;
  // piece it's offset, flipped an item at a time: `(it % BF_PIECES) *
  // piece` here cost the (8, 8) instance a spill (ptxas, 128 registers)
  int poff = 0;
  for (int it = 0; it < items; ++it) {
    if (deep)                             // item it + 1 has landed
      cp_async_wait<BF_DEEP - 3>();
    else
      cp_async_wait<BF_STAGES - 3>();
    __syncthreads();                      // ... for all; piece it is rounded,
                                          // stage it - 1 and piece it - 1 free
    issue(it + stages - 1);               // into item it - 1's stage
    const int ch = cm.ch, nks = (min(kc, K - ch * kc) + 15) / 16;
    const int ks0 = ch * kc / 16;
    if (it + 1 < items) round_piece(it + 1, ch + 1 == nkc ? 0 : ch + 1);
    const __nv_bfloat16* zl = zb + poff + lrow;
    poff = piece - poff;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks >= ks0 && ks < ks0 + nks) {
#pragma unroll
        for (int p = 0; p < NT8 / 2; ++p) {
          uint32_t b[4];
          ldsm_x4_trans(b, zl + (ks - ks0) * 16 * zp + 16 * p);
          mma_bf16(acc[2 * p], a[ks], b[0], b[1]);
          mma_bf16(acc[2 * p + 1], a[ks], b[2], b[3]);
        }
      }
    }
    if (ch == nkc - 1) {
      // the tile's sums: 8 rows x SW columns at a time through the warp's
      // staging tile, out as rows of SW floats (SW / 4 lanes a row, whole
      // 128-byte lines), streaming stores (written once, never read here)
      constexpr int LR = SW / 4, RI = 32 / LR;   // lanes a row, rows a store
      const long n0 = (long)cm.nt * bn + c0;
      if (n0 < N) {                       // a warp's columns are all in or out
        float* o = out + (long)cm.g * M * N + n0 + 4 * (lane % LR);
#pragma unroll
        for (int s = 0; s < WN / SW; ++s)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int j = 0; j < SW / 8; ++j)
              *reinterpret_cast<float2*>(ost + gid * OSP + 8 * j + 2 * tig) =
                  make_float2(acc[SW / 8 * s + j][2 * h],
                              acc[SW / 8 * s + j][2 * h + 1]);
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 8 / RI; ++i) {
              const int r = RI * i + lane / LR, m = m0 + 8 * h + r;
              const float4 v = *reinterpret_cast<const float4*>(
                  ost + r * OSP + 4 * (lane % LR));
              if (m < M)
                __stcs(reinterpret_cast<float4*>(o + (long)m * N + SW * s), v);
            }
            __syncwarp();
          }
      }
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    advance(cm);
  }
}

constexpr int MAX_DEVICES = 64;
constexpr int N_STREAM = 10;     // the stream kernel's instances
size_t reserved[N_STREAM][MAX_DEVICES];

template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes, size_t* res) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= res[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) res[dev] = bytes;
  return err;
}

template <int TM, int CW>
cudaError_t launch_stream(int slot, const float* C, const float* Z, int G,
                          int K, int M, long N, int bn, int kc, int grid,
                          int smem, float* out, cudaStream_t stream) {
  const int tmg = NT / (bn / CW);
  const int want = (int)sizeof(float) *
                   ((K * tmg * tm_pad(TM) + 3) / 4 * 4 + SS * kc * bn);
  if (tmg * TM < M || smem != want) return cudaErrorInvalidValue;
  const cudaError_t err =
      reserve_smem(dot_fp32_stream_kernel<TM, CW>, smem, reserved[slot]);
  if (err != cudaSuccess) return err;
  dot_fp32_stream_kernel<TM, CW><<<grid, NT, smem, stream>>>(
      C, Z, G, K, M, N, bn, kc, out);
  return cudaGetLastError();
}

// the bf16 kernel's launch as its own arithmetic gives it (mirrored by
// tools/bench_dot.py::plan): ks k16 steps (1, 2, 3, 4 or 8), strips of
// M16 (1, 2, 4 or 8 a block), nt8 n8 sums a warp, wn warps across N, bn
// columns a tile, kc rows of K a stage, the ring's stages, dynamic shared
// bytes
struct Bf16Plan {
  int ks, nt8, wn, bn, kc, stages, smem;
};

bool bf16_plan(int K, int M, Bf16Plan* p) {
  if (K < 1 || K > 128 || M < 1) return false;
  const int kt = (K + 15) / 16;
  p->ks = kt <= 4 ? kt : 8;
  int strips = 1;
  while (strips * 16 < (M < BF_MT ? M : BF_MT)) strips *= 2;
  p->nt8 = strips == 1 ? 4 : 8;
  p->wn = NW / strips;
  p->bn = p->wn * 8 * p->nt8;
  p->kc = (int)sizeof(float) * K * p->bn <= BF_STAGE_BYTES
              ? K
              : BF_STAGE_BYTES / ((int)sizeof(float) * p->bn) / 16 * 16;
  const int kcp = (p->kc + 15) / 16 * 16;
  const int sw = 8 * p->nt8 < SWMAX ? 8 * p->nt8 : SWMAX;
  const bool deep = (K + p->kc - 1) / p->kc <= 2 && p->ks <= 4;
  p->stages = deep ? BF_DEEP : BF_STAGES;
  p->smem = (int)sizeof(float) *
                (p->stages * p->kc * p->bn + NW * 8 * (sw + 8)) +
            (int)sizeof(__nv_bfloat16) * BF_PIECES * kcp * (p->bn + 8);
  return true;
}

constexpr int N_BF16 = 10;       // the bf16 kernel's instances
size_t reserved_bf16[N_BF16][MAX_DEVICES];

template <int KS, int NT8>
cudaError_t launch_bf16(int slot, const float* C, const float* Z, int G,
                        int K, int M, long N, const Bf16Plan& p, dim3 grid,
                        float* out, cudaStream_t stream) {
  const cudaError_t err = reserve_smem(dot_bf16_kernel<KS, NT8>, p.smem,
                                       reserved_bf16[slot]);
  if (err != cudaSuccess) return err;
  dot_bf16_kernel<KS, NT8><<<grid, NT, p.smem, stream>>>(
      C, Z, G, K, M, N, p.wn, p.kc, p.stages, out);
  return cudaGetLastError();
}

}  // namespace

// C (K, M), Z (G, K, N) -> out (G, M, N); N a multiple of 128, G <= 65535.
// The launch is tools/bench_dot.py::plan's: cls 0 the stream kernel with
// its rows (tm) and columns (cw) a thread, bn, kc, grid (blocks) and
// dynamic shared bytes; cls 1 the tile kernel (tm, cw, bn, kc ignored;
// grid the product of its three dimensions).
// Numbers that do not match the kernel's own arithmetic are refused.
extern "C" int dot_fp32(const float* C, const float* Z, int G, int K, int M,
                        long N, int cls, int tm, int cw, int bn, int kc,
                        long grid, int smem, float* out, void* stream) {
  if (N % BN || G < 1 || G > 65535 || K < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (cls == 1) {
    const dim3 g3((M + TBM - 1) / TBM, (unsigned)(N / TBN), G);
    if (grid != (long)g3.x * g3.y * g3.z || smem != TILE_SMEM)
      return (int)cudaErrorInvalidValue;
    dot_fp32_tile_kernel<<<g3, NT, TILE_SMEM, s>>>(C, Z, K, M, N, out);
    return (int)cudaGetLastError();
  }
  const long tiles = (bn == 128 || bn == 256) ? G * (N / bn) : 0;
  if (cls != 0 || tiles < 1 || N % bn || kc < 1 || kc > K || grid < 1 ||
      grid > tiles || (cw == 8 && bn != 256))
    return (int)cudaErrorInvalidValue;
  const int g = (int)grid;
#define STREAM(slot, T, W)                                          \
  case T * 100 + W:                                                  \
    return (int)launch_stream<T, W>(slot, C, Z, G, K, M, N, bn, kc, g, \
                                    smem, out, s);
  switch (tm * 100 + cw) {
    STREAM(0, 1, 4) STREAM(1, 2, 4) STREAM(2, 3, 4) STREAM(3, 4, 4)
    STREAM(4, 5, 4) STREAM(5, 6, 4) STREAM(6, 7, 4) STREAM(7, 8, 4)
    STREAM(8, 16, 4) STREAM(9, 8, 8)
  }
#undef STREAM
  return (int)cudaErrorInvalidValue;
}

// C (K, M), Z (G, K, N) -> out (G, M, N) with C and Z rounded to bf16;
// N a multiple of 128, K <= 128, G <= 65535. The launch is
// tools/bench_dot.py::plan(..., dtype='bf16')'s: k16 steps (ks), n8 sums a
// warp (nt8), warps across N (wn), columns a tile (bn), rows of K a stage
// (kc), blocks across the tiles (grid; one row of them per 128 rows of M)
// and dynamic shared bytes. Numbers that do not match the kernel's own
// arithmetic (bf16_plan) are refused.
extern "C" int dot_bf16(const float* C, const float* Z, int G, int K, int M,
                        long N, int ks, int nt8, int wn, int bn, int kc,
                        long grid, int smem, float* out, void* stream) {
  Bf16Plan p;
  if (N % BN || G < 1 || G > 65535 || !bf16_plan(K, M, &p) || ks != p.ks ||
      nt8 != p.nt8 || wn != p.wn || bn != p.bn || kc != p.kc ||
      smem != p.smem || grid < 1 || grid > G * ((N + bn - 1) / bn) ||
      G * ((N + bn - 1) / bn) * ((K + kc - 1) / kc) > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 g2((unsigned)grid, (M + BF_MT - 1) / BF_MT);
  const cudaStream_t s = (cudaStream_t)stream;
#define BF16(slot, S, W)                                                    \
  case S * 100 + W:                                                        \
    return (int)launch_bf16<S, W>(slot, C, Z, G, K, M, N, p, g2, out, s);
  switch (ks * 100 + nt8) {
    BF16(0, 1, 4) BF16(1, 2, 4) BF16(2, 3, 4) BF16(3, 4, 4) BF16(4, 8, 4)
    BF16(5, 1, 8) BF16(6, 2, 8) BF16(7, 3, 8) BF16(8, 4, 8) BF16(9, 8, 8)
  }
#undef BF16
  return (int)cudaErrorInvalidValue;
}
