// Fused convolution block, edge-row and external-weight forms, forward and
// force backward, for NVIDIA Hopper (sm_90a), fp32 throughout.
//
// Replaces the TPU kernels of sevennet_exp_tpu/ops/pallas_conv.py:
//   fused_conv_edge_fwd <- make_fused_conv(agg_d = 0).fwd_kernel_cm
//                          (_cm_fwd_core, _cg_acc_cm, _mlp_forward)
//   fused_conv_edge_bwd <- make_fused_conv(agg_d = 0).bwd_kernel_cm
//                          (_cm_bwd_core, _act_grad)
//   fused_conv_extw_fwd <- make_fused_conv(agg_d > 0, ext_w).fwd_kernel_cm_w
//                          (_cm_fwd_core on given weights)
//   fused_conv_extw_bwd <- make_fused_conv(agg_d > 0, ext_w).bwd_kernel_cm_w
//                          (_cm_bwd_core; emits dweff)
// The dense-grid pair of fwd_kernel_cm / bwd_kernel_cm (agg_d > 0, entries
// fused_conv_fwd / fused_conv_bwd) is the geometry-fused pair's template
// without the geometry, in fused_conv_geom.cu. The bodies below are the
// first design of that pair (fused_conv_body.cuh), which bench_pieces.cu
// still stubs piece by piece.
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
//
// The edge-row pair (fused_conv_edge_fwd / fused_conv_edge_bwd) is the
// first dense-grid design at agg_d = 0, the plain edge list of the
// calculator: one output row per input row, si2 applied per row, the caller
// scatters the rows onto the atoms. si2 per row is ~107k multiply-adds in a
// mid layer, more than the MLP and the CG together, and its weights (~220
// kB) fit no shared memory. One row per block (the dense design with D = 1)
// reloads them, the tables and the MLP's columns for every row; here a
// block owns RT_E (RT_EB) rows in any order, keeps their aggregates
// (message cotangents) row-minor in shared memory and reads each si2 weight
// once for all of them, the rows' values by one or two 16-byte loads.


#include "fused_conv_body.cuh"

namespace {

// The forward kernels keep a 64-weight MLP column in registers and fit two
// blocks per SM at 128 registers. ptxas has found 128 by itself and, after
// an unrelated edit of the shared body, 170 for the first geometry-fused one
// (one block per SM, 1.6x the time): the bound is stated on each.
__global__ void __launch_bounds__(NT, 2)
fused_conv_edge_fwd_kernel(const float* __restrict__ xg,
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

__global__ void __launch_bounds__(NT)
fused_conv_extw_fwd_kernel(const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ weff,
                           const float* __restrict__ si2w, Plan P,
                           float* __restrict__ out) {
  fwd_body<M_EXTW>(xg, sh, nullptr, nullptr, weff, nullptr, nullptr,
                   nullptr, si2w, P, out);
}

// The backward kernels are held to two blocks per SM (128 registers). Left
// to itself ptxas has taken 173 (the first dense-grid backward) and 193
// (the first geometry-fused one, with the sinf/cosf/powf slow paths
// inlined): one block per SM, and 1.5-1.6x the time.
__global__ void __launch_bounds__(NT, 2)
fused_conv_edge_bwd_kernel(const float* __restrict__ gout,
                           const float* __restrict__ xg,
                           const float* __restrict__ sh,
                           const float* __restrict__ emb,
                           const float* __restrict__ ms,
                           const float* __restrict__ w0,
                           const float* __restrict__ w1,
                           const float* __restrict__ w1t,
                           const float* __restrict__ w2,
                           const float* __restrict__ w2t,
                           const float* __restrict__ si2wt, Plan P,
                           float* __restrict__ dxg, float* __restrict__ dsh,
                           float* __restrict__ demb) {
  bwd_body<M_EDGE>(gout, xg, sh, emb, ms, nullptr, w0, w1, w1t, w2,
                   w2t, si2wt, P, nullptr, 0, dxg, dsh, demb,
                   nullptr);
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

static size_t extw_fwd_reserved[MAX_DEVICES], extw_bwd_reserved[MAX_DEVICES],
    edge_fwd_reserved[MAX_DEVICES], edge_bwd_reserved[MAX_DEVICES];

extern "C" int fused_conv_edge_fwd(const float* xg, const float* sh,
                                   const float* emb, const float* ms,
                                   const float* w0, const float* w1,
                                   const float* w2, const float* si2w,
                                   PLAN_ARGS, float* out, void* stream) {
  const Plan P = edge_plan(PLAN_CALL, RT_E);
  const size_t smem = fwd_smem(P, M_EDGE);
  const cudaError_t err =
      reserve_smem(fused_conv_edge_fwd_kernel, smem, edge_fwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_edge_fwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        xg, sh, emb, ms, w0, w1, w2, si2w, P, out);
  return (int)cudaGetLastError();
}

extern "C" int fused_conv_edge_bwd(const float* g, const float* xg,
                                   const float* sh, const float* emb,
                                   const float* ms, const float* w0,
                                   const float* w1, const float* w1t,
                                   const float* w2, const float* w2t,
                                   const float* si2wt, PLAN_ARGS, float* dxg,
                                   float* dsh, float* demb, void* stream) {
  const Plan P = edge_plan(PLAN_CALL, RT_EB);
  const size_t smem = bwd_smem(P, M_EDGE);
  const cudaError_t err =
      reserve_smem(fused_conv_edge_bwd_kernel, smem, edge_bwd_reserved);
  if (err != cudaSuccess) return (int)err;
  if (P.n_atoms > 0)
    fused_conv_edge_bwd_kernel<<<P.n_atoms, NT, smem,
                                 (cudaStream_t)stream>>>(
        g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2wt, P, dxg, dsh, demb);
  return (int)cudaGetLastError();
}

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
