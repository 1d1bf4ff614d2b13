// Fused convolution block, external-weight form, forward and force
// backward, for NVIDIA Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_extw_fwd <- make_fused_conv(agg_d > 0, ext_w).fwd_kernel_cm_w
//                          (_cm_fwd_core on given weights)
//   fused_conv_extw_bwd <- make_fused_conv(agg_d > 0, ext_w).bwd_kernel_cm_w
//                          (_cm_bwd_core; emits dweff)
// The dense-grid pair of fwd_kernel_cm / bwd_kernel_cm (agg_d > 0, entries
// fused_conv_fwd / fused_conv_bwd) and its edge-row form (agg_d = 0,
// fused_conv_edge_fwd / fused_conv_edge_bwd) live in fused_conv_geom.cu,
// beside the geometry-fused pair. The bodies below are the first design of
// the dense-grid pair (fused_conv_body.cuh), which bench_pieces.cu still
// stubs piece by piece (its edge-row mode M_EDGE is the edge-row kernel 1
// of that design).
//
// Per grid row e of atom i (row i*D + k is atom i's k-th neighbor):
//   w[e]  = MLP(emb[e]) * ms[e]            radial MLP nb -> 64 -> 64 -> wn
//   A_i   = sum_e w[e] (x) CG(xg[e], sh[e]) uvu tensor product, summed over
//                                          the atom's D rows
//   y[i]  = si2(A_i)                       self-interaction 2 per atom
// The backward takes the node cotangent g[i], forms gm = si2^T g[i] ONCE
// per atom (the D rows share it), recomputes the MLP and returns dxg,
// dsh and demb; weights and the mask scale get no gradient.
//
// What bounds it on this card: arithmetic. A mid layer (d1 = 480, 576
// live MLP columns) does ~41k multiply-adds of radial MLP and ~4.3k of
// CG per row against ~2 kB of input per row, i.e. ~40 flop/byte, far
// above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20 flop/byte; the
// MLP output layer (64 x 576 per row) is ~85% of the work.
//
// What this simple design does about it: one block owns one atom, so the
// D-row sum stays in shared memory with no atomics and no second pass,
// and the per-atom si2 (forward) and si2^T g (backward) run once per
// atom instead of once per row. A thread owns one live MLP output column
// (instruction, channel): it keeps that column of w2 in 64 registers
// (read once per tile, coalesced: w2 is (64, wn) row-major and lanes take
// consecutive columns -- the whole w2 would not fit in shared memory),
// so the MLP output layer is register-blocked over the tile's rows and
// its input (the hidden row) is a shared-memory broadcast; the backward's
// dw @ w2^T is register-blocked the same way over the tile's rows. The
// CG tables live in shared memory. Instructions no si2 path reads are
// never computed, and rows with ms == 0 (grid pads) are skipped.
// Everything is CUDA-core fp32 FMA: no TF32, no tensor cores yet
// (wgmma/3xTF32 for the MLP is the next step).
//
// The kernels are table-driven over the layer's plan (built by
// ops/fused_conv.py from _tp_plan / _si2_groups), so one source serves
// every layer (irreps up to l = 3).
//
// The external-weight pair runs no MLP: it takes the per-row weights
// weff (E, wn), already scaled by mask/denominator (the caller computes them
// once per edge PAIR on the half list, outside any kernel), and does the CG,
// the D-row sum and si2 only; its backward returns dxg, dsh and dweff (E, wn)
// and leaves the MLP's VJP to the caller. Without the MLP a mid layer does
// ~4.3k multiply-adds per row against ~4.3 kB read per row (xg, sh and 576
// live weights): ~3 flop/byte, so this pair is bound by bytes. Its design
// keeps the one-block-per-atom shape and the thread-per-live-column CG of
// the first dense-grid design: a weight is read once, coalesced over the
// columns, with the next row's weight in flight while this row's CG runs
// (forward) or staged through shared memory per row tile (backward). A row
// whose live weights are all zero is a grid pad: it sends no message and
// its dxg, dsh and dweff rows are exact zeros; dweff columns no live
// instruction reads are written as zeros.


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

// Without the MLP's weight column in registers this kernel fits three
// blocks per SM (85 registers; ptxas has taken 72 and, after an unrelated
// edit of the shared body, 96, which cost a block and 16 % of the time).
__global__ void __launch_bounds__(NT, 3)
fused_conv_extw_bwd_kernel(const float* __restrict__ gout,
                           const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ weff,
                           const float* __restrict__ si2wt, Plan P,
                           const int* __restrict__ dead_w, int n_dead,
                           float* __restrict__ dxg, float* __restrict__ dsh,
                           float* __restrict__ dweff) {
  bwd_body<M_EXTW>(gout, xg, sh, nullptr, nullptr, weff, nullptr,
                   nullptr, nullptr, nullptr, nullptr, si2wt, P,
                   dead_w, n_dead, dxg, dsh, nullptr, dweff);
}

}  // namespace

static size_t extw_fwd_reserved[MAX_DEVICES], extw_bwd_reserved[MAX_DEVICES];

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

extern "C" int fused_conv_extw_bwd(const float* g, const float* xg,
                                   const float* sh, const float* weff,
                                   const float* si2wt, PLAN_ARGS,
                                   const int* dead_w, int n_dead, float* dxg,
                                   float* dsh, float* dweff, void* stream) {
  const Plan P = PLAN_CALL;
  const size_t smem = bwd_smem(P, M_EXTW);
  const cudaError_t err =
      reserve_smem(fused_conv_extw_bwd_kernel, smem, extw_bwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_extw_bwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        g, xg, sh, weff, si2wt, P, dead_w, n_dead, dxg, dsh, dweff);
  return (int)cudaGetLastError();
}
