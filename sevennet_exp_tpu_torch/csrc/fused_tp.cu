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
// per byte against a ridge of 20. So the design moves each byte once:
// a warp owns one row; it stages the row's x and sh in shared memory (x is
// read by several instructions), reads each weight and writes each output
// once, 32 consecutive channels per warp access. The "terms" of the TPU
// kernel -- a Python-unrolled list of (m, n, p, c) products -- are a table
// in __constant__ memory here: all lanes of a warp work on the same
// instruction, so every table read is a broadcast and costs no
// shared-memory bandwidth. In the backward a lane keeps dw of its channel in
// a register, adds dx into the warp's own shared-memory row (only that lane
// ever touches that element) and dsh is reduced over the lanes by shuffles;
// no atomics anywhere, so results are reproducible bit for bit.

#include <cuda_runtime.h>

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

// shared memory: the tables, then per warp a row of x and of sh (and in the
// backward of dx and dsh)
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

__global__ void __launch_bounds__(NT)
fused_tp_bwd_kernel(const float* __restrict__ g,
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

extern "C" int fused_tp_bwd(const float* g, const float* xg, const float* sh,
                            const float* w, const int* ins, const int* slices,
                            int n_ins, int n_slices, long n_rows, int d1,
                            int f, int wn, int d3, float* dxg, float* dsh,
                            float* dw, void* stream) {
  const Args A = make_args(ins, slices, n_ins, n_slices, n_rows, d1, f, wn,
                           d3);
  const size_t smem =
      sizeof(float) * ((size_t)table_words(A) + (size_t)NW * 2 * (d1 + f));
  const cudaError_t err = reserve_smem(fused_tp_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    const unsigned blocks = (unsigned)((n_rows + NW - 1) / NW);
    fused_tp_bwd_kernel<<<blocks, NT, smem, (cudaStream_t)stream>>>(
        g, xg, sh, w, A, dxg, dsh, dw);
  }
  return (int)cudaGetLastError();
}
