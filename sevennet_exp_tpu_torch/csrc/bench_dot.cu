// Small-matmul cost law on NVIDIA Hopper (sm_90a): out[g] = C^T Z[g] for
// G slices Z[g] (K, N), C (K, M), fp32 out -- in fp32 on the CUDA cores, or
// with the inputs rounded to bf16 in the kernel and multiplied on the
// tensor cores with fp32 accumulation.
//
// Replaces the TPU kernel of tools/bench_dot.py (bench(K, M, N, dtype), run
// through pl.pallas_call over a grid of G steps: dot_general of C and one
// Z slice per step, bf16 inputs cast inside the kernel).
//
//   dot_fp32  a register-tiled SGEMM: a block computes a 32 x 128 tile of
//             one slice's output over K in steps of 8 through shared
//             memory; each thread 4 x 4 outputs, 16 FMAs per two 16-byte
//             shared loads. No TF32.
//   dot_bf16  the same tile on mma.sync.m16n8k16 (bf16 x bf16 -> fp32):
//             fp32 tiles staged in shared memory, rounded to bf16 (nearest
//             even) as each fragment is built, K in steps of 16; 8 warps of
//             2 x 2 mma tiles each.
//
// What bounds them: bytes for the CG-sized shapes (K, M <= 45: ~1 multiply-
// add per byte moved, under fp32's ridge of ~10), operations only for
// K = M = 128 in fp32. Z is read once per 32 rows of M (consecutive blocks
// share a Z tile, so the re-reads hit L2) and every output written once.
// N must be a multiple of 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int BM = 32, BN = 128;
constexpr int BK = 8;            // fp32: K per shared-memory step
constexpr int BK16 = 16;         // bf16: K per mma
constexpr int CS = BM + 4;       // bf16 tile strides, padded so that the
constexpr int ZS = BN + 4;       // fragment loads hit distinct banks

__global__ void __launch_bounds__(NT)
dot_fp32_kernel(const float* __restrict__ C, const float* __restrict__ Z,
                int K, int M, long N, float* __restrict__ out) {
  __shared__ __align__(16) float c_s[BK][BM];
  __shared__ __align__(16) float z_s[BK][BN];
  const int tid = threadIdx.x, tx = tid % 32, ty = tid / 32;
  const int m0 = blockIdx.x * BM;
  const long n0 = (long)blockIdx.y * BN;
  const float* Zg = Z + (long)blockIdx.z * K * N;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int kk = tid / BM, mm = tid % BM, k = k0 + kk, m = m0 + mm;
      c_s[kk][mm] = (k < K && m < M) ? C[(long)k * M + m] : 0.f;
    }
    {
      const int kk = tid / 32, c4 = tid % 32, k = k0 + kk;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K)
        v = *reinterpret_cast<const float4*>(Zg + (long)k * N + n0 + 4 * c4);
      *reinterpret_cast<float4*>(&z_s[kk][4 * c4]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&c_s[kk][4 * ty]);
      const float4 z = *reinterpret_cast<const float4*>(&z_s[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], zv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m < M)
      *reinterpret_cast<float4*>(
          out + ((long)blockIdx.z * M + m) * N + n0 + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

}  // namespace

// C (K, M), Z (G, K, N) -> out (G, M, N); N a multiple of 128, G <= 65535
extern "C" int dot_fp32(const float* C, const float* Z, int G, int K, int M,
                        long N, float* out, void* stream) {
  if (N % BN || G < 1 || G > 65535 || K < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (unsigned)(N / BN), G);
  dot_fp32_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(C, Z, K, M, N, out);
  return (int)cudaGetLastError();
}

extern "C" int dot_bf16(const float* C, const float* Z, int G, int K, int M,
                        long N, float* out, void* stream) {
  if (N % BN || G < 1 || G > 65535 || K < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + BM - 1) / BM, (unsigned)(N / BN), G);
  dot_bf16_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(C, Z, K, M, N, out);
  return (int)cudaGetLastError();
}
