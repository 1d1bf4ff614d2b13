// Per-piece cost of the fused conv forward (kernel 1 of fused_conv.cu) on
// NVIDIA Hopper (sm_90a), fp32: the same body with one piece at a time
// replaced by a near-free stand-in, so that full - variant is what the piece
// costs inside the real kernel (its scheduling and occupancy included).
//
// Replaces the TPU kernels of tools/bench_pieces.py (make_kernel(skip), run
// through pl.pallas_call): the production forward fwd_kernel_cm with the
// pieces 'mlp', 'cg', 'w', 'agg' and 'si2' stubbed.
//
//   bench_pieces_full   fwd_body<M_PLAIN>: fused_conv_fwd_kernel itself
//   bench_pieces_nomlp  S_MLP: radial weight = emb[:, 0] * ms, no MLP
//   bench_pieces_nocg   S_CG:  each component's CG sum = x entry m = 0
//   bench_pieces_now    S_W:   no radial multiply (the weight is still
//                              computed, so the MLP stays)
//   bench_pieces_noagg  fwd_body<M_EDGE>: si2 per row, (E, d_out) rows out,
//                       no D-row sum (fused_conv_edge_fwd_kernel itself)
//   bench_pieces_nosi2  S_SI2: the aggregate written straight to the output
//                       columns of its si2 group, truncated or zero-padded
//
// What bounds it: as kernel 1, arithmetic (the MLP's output layer); the
// stand-ins cut it piece by piece. Every variant is its own kernel with its
// own __launch_bounds__, and each is the shared body of fused_conv_body.cuh
// instantiated with compile-time flags (if constexpr), so that the full
// variant is kernel 1 bit for bit and the others differ only where stubbed.

#include "fused_conv_body.cuh"

namespace {

__global__ void __launch_bounds__(NT, 2)
bench_pieces_full_kernel(const float* __restrict__ xg,
                         const float* __restrict__ sh,
                         const float* __restrict__ emb,
                         const float* __restrict__ ms,
                         const float* __restrict__ w0,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ si2w, Plan P,
                         float* __restrict__ out) {
  fwd_body<M_PLAIN>(xg, sh, emb, ms, nullptr, w0, w1, w2, si2w, P,
                    out);
}

__global__ void __launch_bounds__(NT, 2)
bench_pieces_nomlp_kernel(const float* __restrict__ xg,
                          const float* __restrict__ sh,
                          const float* __restrict__ emb,
                          const float* __restrict__ ms,
                          const float* __restrict__ w0,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ si2w, Plan P,
                          float* __restrict__ out) {
  fwd_body<M_PLAIN, S_MLP>(xg, sh, emb, ms, nullptr, w0, w1, w2,
                           si2w, P, out);
}

__global__ void __launch_bounds__(NT, 2)
bench_pieces_nocg_kernel(const float* __restrict__ xg,
                         const float* __restrict__ sh,
                         const float* __restrict__ emb,
                         const float* __restrict__ ms,
                         const float* __restrict__ w0,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ si2w, Plan P,
                         float* __restrict__ out) {
  fwd_body<M_PLAIN, S_CG>(xg, sh, emb, ms, nullptr, w0, w1, w2,
                          si2w, P, out);
}

__global__ void __launch_bounds__(NT, 2)
bench_pieces_now_kernel(const float* __restrict__ xg,
                        const float* __restrict__ sh,
                        const float* __restrict__ emb,
                        const float* __restrict__ ms,
                        const float* __restrict__ w0,
                        const float* __restrict__ w1,
                        const float* __restrict__ w2,
                        const float* __restrict__ si2w, Plan P,
                        float* __restrict__ out) {
  fwd_body<M_PLAIN, S_W>(xg, sh, emb, ms, nullptr, w0, w1, w2, si2w,
                         P, out);
}

__global__ void __launch_bounds__(NT, 2)
bench_pieces_noagg_kernel(const float* __restrict__ xg,
                          const float* __restrict__ sh,
                          const float* __restrict__ emb,
                          const float* __restrict__ ms,
                          const float* __restrict__ w0,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ si2w, Plan P,
                          float* __restrict__ out) {
  fwd_body<M_EDGE>(xg, sh, emb, ms, nullptr, w0, w1, w2, si2w, P, out);
}

__global__ void __launch_bounds__(NT, 2)
bench_pieces_nosi2_kernel(const float* __restrict__ xg,
                          const float* __restrict__ sh,
                          const float* __restrict__ emb,
                          const float* __restrict__ ms,
                          const float* __restrict__ w0,
                          const float* __restrict__ w1,
                          const float* __restrict__ w2,
                          const float* __restrict__ si2w, Plan P,
                          float* __restrict__ out) {
  fwd_body<M_PLAIN, S_SI2>(xg, sh, emb, ms, nullptr, w0, w1, w2,
                           si2w, P, out);
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, const float*, const float*,
                        const float*, const float*, Plan, float*);

constexpr int N_VARIANTS = 6;
constexpr int V_NOAGG = 4;
const Kernel kernels[N_VARIANTS] = {
    bench_pieces_full_kernel, bench_pieces_nomlp_kernel,
    bench_pieces_nocg_kernel, bench_pieces_now_kernel,
    bench_pieces_noagg_kernel, bench_pieces_nosi2_kernel};

}  // namespace

static size_t reserved[N_VARIANTS][MAX_DEVICES];

// variant: 0 full, 1 -mlp, 2 -cg, 3 -w, 4 -agg, 5 -si2. The plan is kernel
// 1's (one block per atom of D rows); -agg regroups it into the edge-row
// form's blocks of RT_E rows and writes n_atoms * D rows of d_out.
extern "C" int bench_pieces_fwd(int variant, const float* xg,
                                const float* sh, const float* emb,
                                const float* ms, const float* w0,
                                const float* w1, const float* w2,
                                const float* si2w, PLAN_ARGS, float* out,
                                void* stream) {
  if (variant < 0 || variant >= N_VARIANTS) return (int)cudaErrorInvalidValue;
  const bool edge = variant == V_NOAGG;
  const Plan P = edge ? edge_plan(PLAN_CALL, RT_E) : PLAN_CALL;
  const size_t smem = fwd_smem(P, edge ? M_EDGE : M_PLAIN);
  const cudaError_t err =
      reserve_smem(kernels[variant], smem, reserved[variant]);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    kernels[variant]<<<P.n_atoms, NT, smem, (cudaStream_t)stream>>>(
        xg, sh, emb, ms, w0, w1, w2, si2w, P, out);
  return (int)cudaGetLastError();
}
