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
//   dot_bf16  a 32 x 128 tile on mma.sync.m16n8k16 (bf16 x bf16 -> fp32):
//             fp32 tiles staged in shared memory, rounded to bf16 (nearest
//             even) as each fragment is built, K in steps of 16; 8 warps of
//             2 x 2 mma tiles each. Z is read once per 32 rows of M.
//
// No TF32, no fast math: the fp32 kernels are FFMA on the CUDA cores.
// N must be a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int BM = 32, BN = 128;
constexpr int BK16 = 16;         // bf16: K per mma
constexpr int CS = BM + 4;       // bf16 tile strides, padded so that the
constexpr int ZS = BN + 4;       // fragment loads hit distinct banks

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

__global__ void __launch_bounds__(NT)
dot_bf16_kernel(const float* __restrict__ C, const float* __restrict__ Z,
                int K, int M, long N, float* __restrict__ out) {
  __shared__ __align__(16) float c_s[BK16][CS];   // c_s[k][m] = C[k][m]
  __shared__ __align__(16) float z_s[BK16][ZS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = blockIdx.x * BM;
  const long n0 = (long)blockIdx.y * BN;
  const float* Zg = Z + (long)blockIdx.z * K * N;
  float acc[2][2][4] = {};       // [m16 tile][n8 tile][fragment]
  for (int k0 = 0; k0 < K; k0 += BK16) {
    for (int i = tid; i < BK16 * BM; i += NT) {
      const int kk = i / BM, mm = i % BM, k = k0 + kk, m = m0 + mm;
      c_s[kk][mm] = (k < K && m < M) ? C[(long)k * M + m] : 0.f;
    }
    for (int i = tid; i < BK16 * BN / 4; i += NT) {
      const int kk = i / (BN / 4), c4 = i % (BN / 4), k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K)
        v = *reinterpret_cast<const float4*>(Zg + (long)k * N + n0 + 4 * c4);
      *reinterpret_cast<float4*>(&z_s[kk][4 * c4]) = v;
    }
    __syncthreads();
    // A = C^T (m rows, k columns): rows gid / gid + 8, columns 2 tig (+1)
    // and 2 tig + 8 (+1); B = Z (k rows, n columns): rows 2 tig (+1) and
    // 2 tig + 8 (+1), column gid
    uint32_t a[2][4], b[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = 16 * mt + gid;
      a[mt][0] = pack_bf16(c_s[2 * tig][m], c_s[2 * tig + 1][m]);
      a[mt][1] = pack_bf16(c_s[2 * tig][m + 8], c_s[2 * tig + 1][m + 8]);
      a[mt][2] = pack_bf16(c_s[2 * tig + 8][m], c_s[2 * tig + 9][m]);
      a[mt][3] = pack_bf16(c_s[2 * tig + 8][m + 8], c_s[2 * tig + 9][m + 8]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = 16 * warp + 8 * nt + gid;
      b[nt][0] = pack_bf16(z_s[2 * tig][n], z_s[2 * tig + 1][n]);
      b[nt][1] = pack_bf16(z_s[2 * tig + 8][n], z_s[2 * tig + 9][n]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float* d = acc[mt][nt];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
              "r"(b[nt][0]), "r"(b[nt][1]));
      }
    __syncthreads();
  }
  // D: rows gid (fragments 0, 1) and gid + 8 (2, 3), columns 2 tig (+1)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * mt + gid + 8 * h;
        const long n = n0 + 16 * warp + 8 * nt + 2 * tig;
        if (m < M)
          *reinterpret_cast<float2*>(out + ((long)blockIdx.z * M + m) * N + n) =
              make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
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

extern "C" int dot_bf16(const float* C, const float* Z, int G, int K, int M,
                        long N, float* out, void* stream) {
  if (N % BN || G < 1 || G > 65535 || K < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (unsigned)(N / BN), G);
  dot_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(C, Z, K, M, N, out);
  return (int)cudaGetLastError();
}
