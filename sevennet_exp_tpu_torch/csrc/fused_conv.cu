// Fused convolution block, external-weight form, forward, for NVIDIA Hopper
// (sm_90a), fp32 throughout.
//
// Replaces the TPU kernel of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_extw_fwd <- make_fused_conv(agg_d > 0, ext_w).fwd_kernel_cm_w
//                          (_cm_fwd_core on given weights)
// Its backward (bwd_kernel_cm_w, entry fused_conv_extw_bwd) lives in
// fused_conv_geom.cu, built as the library fused_conv_geom_extw. The
// dense-grid pair of fwd_kernel_cm / bwd_kernel_cm (agg_d > 0, entries
// fused_conv_fwd / fused_conv_bwd) and its edge-row form (agg_d = 0,
// fused_conv_edge_fwd / fused_conv_edge_bwd) live in fused_conv_geom.cu too,
// beside the geometry-fused pair. The body below is the first design of the
// dense-grid forward (fused_conv_body.cuh), which bench_pieces.cu still
// stubs piece by piece (its edge-row mode M_EDGE is the edge-row kernel 1 of
// that design).
//
// Per grid row e of atom i (row i*D + k is atom i's k-th neighbor):
//   A_i   = sum_e weff[e] (x) CG(xg[e], sh[e])  uvu tensor product on the
//                                          given weights, summed over the
//                                          atom's D rows
//   y[i]  = si2(A_i)                       self-interaction 2 per atom
// The weights weff (E, wn) come already scaled by mask/denominator (the
// caller computes them once per edge PAIR on the half list, outside any
// kernel).
//
// What bounds it on this card: bytes. Without the MLP a mid layer does
// ~4.3k multiply-adds per row against ~4.3 kB read per row (xg, sh and 576
// live weights): ~3 flop/byte. The design keeps the one-block-per-atom shape
// and the thread-per-live-column CG of the first dense-grid design: a weight
// is read once, coalesced over the columns, with the next row's weight in
// flight while this row's CG runs. The D-row sum stays in shared memory (no
// atomics) and si2 runs once per atom. A row whose live weights are all zero
// is a grid pad: it sends no message. CUDA-core fp32 FMA only.


#include "fused_conv_body.cuh"

namespace {

__global__ void __launch_bounds__(NT)
fused_conv_extw_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ weff,
                           const float* __restrict__ si2w, Plan P,
                           float* __restrict__ out) {
  fwd_body<M_EXTW>(xg, sh, nullptr, nullptr, weff, nullptr, nullptr,
                   nullptr, si2w, P, out);
}

}  // namespace

static size_t extw_fwd_reserved[MAX_DEVICES];

extern "C" int fused_conv_extw_fwd(const float* xg, const float* sh,
                                   const float* weff, const float* si2w,
                                   PLAN_ARGS, float* out, void* stream) {
  const Plan P = PLAN_CALL;
  const size_t smem = fwd_smem(P, M_EXTW);
  const cudaError_t err =
      reserve_smem(fused_conv_extw_fwd_kernel, smem, extw_fwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_extw_fwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        xg, sh, weff, si2w, P, out);
  return (int)cudaGetLastError();
}
