"""Per-pass cost of the geometry-fused conv kernels, with ``--dense`` of
the dense-grid pair (kernels 1-2, the same template without the geometry),
with ``--edge`` of the edge pair (kernels 1-2 at ``agg_d = 0``), measured by
stubbing one pass at a time and timing each build.

    python -m sevennet_exp_tpu_torch.tools.geom_passes [OTHER.cu] [OUT.json] [--dense | --edge]

Each pass gets a ``-DSTUB_<PASS>`` switch, inserted into a temporary copy of
the source (the stand-in keeps its result live, so the compiler keeps the
rest); every variant is built with the port's nvcc flags, bound like the
port's pair (``fused_conv.bind_geom``) and timed with ``timing.cuda_ms`` on
``geom_ab.chunk_inputs`` (16,384 atoms x 32 rows, 6 pad rows an atom) at
checkpoint layer 1, then layers 4 and 0 (all variants). Per variant and
kernel it prints the ms a launch and (full - stubbed) / rows in ns a row.
With ``--dense`` the dense pair is timed the same way on the 1k grid's
shape (``geom_ab.dense_inputs``, 1,000 atoms x 32 rows, 6 pad rows an
atom), with the passes of ``DENSE_PASSES``. With ``--edge`` the edge pair
on the 1k calculator's rows (``geom_ab.edge_inputs``: 31,232 rows, the last
5,232 pads), with the passes of ``EDGE_PASSES`` (its SI2 the per-group
products over the tile's rows).

Without OTHER.cu the source is the port's ``csrc/fused_conv_geom.cu``, with
the passes of ``NEW_STUBS``. With OTHER.cu it is an earlier tree's
``csrc/fused_conv.cu`` whose ``fused_conv_body.cuh`` (beside it) still holds
the geometry-fused mode ``M_GEOM`` (the kernels before their redesign), with
the passes of ``OLD_STUBS``. Needs a card (exits 2 without one).

The stand-ins (what each switch leaves of its pass):
  GEOM  emb and sh a cheap function of the edge vector; dvec from demb, dsh
  ROWS  (dense pair) emb and sh a cheap function of the tile's first emb
        value, not loaded
  HID   the hidden layers a product of emb and one w1 entry, derivatives 1
  W / FMLP / AMLP  the radial weight from one w2 entry, not the 64-term sum
  CG / FCG / ACG   one term of the CG instead of the instruction's pattern
  RED   dsh summed over lanes without the butterfly (new kernels)
  B, C  (old kernels) dxg and dsh from one product, no scan
  D     dh1 from one dw and one w2 entry per row
  EF    passes E and F with one hidden unit
  SI2   the per-atom si2 (forward) and si2^T g (backward) as copies; in
        the edge pair the group products without their weight loads and
        multiply-adds
  (the edge forward's W and CG are its per-group w pass and CG: the same
  switches)
  LOAD  (old kernels) the x rows not staged in shared memory
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

import torch

from ..ops import cuda_build
from ..ops import fused_conv as fc
from ..ops import torch_ops
from .geom_ab import CHECKPOINT, chunk_inputs, dense_inputs, edge_inputs
from .timing import card, cuda_ms, require_card

Stubs = List[Tuple[str, str]]

# (text, text with the #ifdef STUB_ block) in csrc/fused_conv_geom.cu
NEW_STUBS: Stubs = [
    ("""                          const float* vec_s, float* embT_s, float* sh_s) {
  const int per = P.nb + SHP;
""",
     """                          const float* vec_s, float* embT_s, float* sh_s) {
  const int per = P.nb + SHP;
#ifdef STUB_GEOM
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float v = vec_s[3 * e] * 0.25f + k * 0.01f;
    if (k < P.nb) embT_s[k * T + e] = v; else sh_s[e * SHP + k - P.nb] = v;
  }
  return;
#endif
"""),
    ("""  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane & 7;""",
     """  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sl = lane & 7;
#ifdef STUB_GEOM
  for (int i = threadIdx.x; i < rows * 3; i += NT) {
    const int e = i / 3;
    dvec[(row0 + e) * 3 + i - e * 3] = ms_s[e] != 0.f
        ? dembT_s[(i - e * 3) * T + e] + dsh_s[e * SHP + (i - e * 3)] : 0.f;
  }
  return;
#endif"""),
    ("""                                           float* embT_s, float* sh_s) {
  const int nb = P.nb, f = P.f, pad = SHP - P.f;
""",
     """                                           float* embT_s, float* sh_s) {
  const int nb = P.nb, f = P.f, pad = SHP - P.f;
#ifdef STUB_ROWS
  const float v0 = __ldg(G.emb + row0 * nb);
  for (int i = threadIdx.x; i < rows * (nb + SHP); i += NT) {
    const int e = i / (nb + SHP), k = i - e * (nb + SHP);
    const float v = v0 * 0.25f + (e + k) * 0.01f;
    if (k < nb) embT_s[k * T + e] = v; else sh_s[e * SHP + k - nb] = v;
  }
  return;
#endif
"""),
    ("""                          float* h1T_s, float* da0T_s, float* da1T_s) {
""",
     """                          float* h1T_s, float* da0T_s, float* da1T_s) {
#ifdef STUB_HID
  for (int i = threadIdx.x; i < T * H; i += NT) {
    const int j = i / T, e = i - j * T;
    const float v = embT_s[(j & 7) * T + e] * __ldg(w1 + j);
    h0T_s[i] = v; h1T_s[i] = v;
    if (da0T_s) { da0T_s[i] = 1.f; da1T_s[i] = 1.f; }
  }
  __syncthreads();
  return;
#endif
"""),
    ("""    const float* wg = w2 + __ldg(P.col_w + c);
    float acc[R];""",
     """    const float* wg = w2 + __ldg(P.col_w + c);
#ifdef STUB_W
    for (int e = e0; e < e1; ++e)
      w_s[e * S.nap + c] = h1T_s[(c & 63) * S.T + e] * __ldg(wg) * ms_s[e];
    continue;
#endif
    float acc[R];"""),
    ("""    CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
      s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                   sv[decltype(n)::value],
                                   s[decltype(p)::value]);
    });""",
     """#ifdef STUB_CG
    s[0] = xv[0] * sv[0];
#else
    CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
      s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                   sv[decltype(n)::value],
                                   s[decltype(p)::value]);
    });
#endif"""),
    ("""  CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
    const float g = cf * gmv[decltype(p)::value];
    t[decltype(m)::value] = fmaf(g, sv[L2 * L2 + decltype(n)::value],
                                 t[decltype(m)::value]);
    v[decltype(n)::value] = fmaf(g, xv[decltype(m)::value],
                                 v[decltype(n)::value]);
  });""",
     """#ifdef STUB_CG
  t[0] = gmv[0] * sv[L2 * L2];
  v[0] = gmv[0] * xv[0];
#else
  CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
    const float g = cf * gmv[decltype(p)::value];
    t[decltype(m)::value] = fmaf(g, sv[L2 * L2 + decltype(n)::value],
                                 t[decltype(m)::value]);
    v[decltype(n)::value] = fmaf(g, xv[decltype(m)::value],
                                 v[decltype(n)::value]);
  });
#endif"""),
    ("""          const float tot = butterfly16(dsh, lane);
          if (valid && !(lane & 1))
            dshp_s[(warp * T + e) * SHP + butterfly_index(lane)] += tot;""",
     """#ifdef STUB_RED
          float tot = 0.f;
#pragma unroll
          for (int n = 0; n < NSH; ++n) tot += dsh[n];
          if (valid && lane < 16)
            dshp_s[(warp * T + e) * SHP + lane] += tot;
#else
          const float tot = butterfly16(dsh, lane);
          if (valid && !(lane & 1))
            dshp_s[(warp * T + e) * SHP + butterfly_index(lane)] += tot;
#endif"""),
    ("""        for (int c0 = c_lo; c0 < c_hi; c0 += SLAB) {""",
     """#ifdef STUB_D
#pragma unroll
        for (int e = 0; e < TR; ++e)
          acc[e] = wdw_s[e * S.nap + (c_lo + k) % S.nap] * __ldg(w2t + k);
        if (false)
#endif
        for (int c0 = c_lo; c0 < c_hi; c0 += SLAB) {"""),
    ("""#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 d = *reinterpret_cast<const float4*>(h1T_s + k * T + q);""",
     """#pragma unroll 8
        for (int k = 0; k < EF_K; ++k) {
          const float4 d = *reinterpret_cast<const float4*>(h1T_s + k * T + q);"""),
    ("""        for (int j = 0; j < H; ++j) s = fmaf(h0T_s[j * T + e], __ldg(wr + j), s);""",
     """        for (int j = 0; j < EF_K; ++j) s = fmaf(h0T_s[j * T + e], __ldg(wr + j), s);"""),
    ("""    if (on) {
      if (fast) {""",
     """#ifdef STUB_SI2
    if (on) acc[0][0] += __ldg(b) * a[0];
    if (false)
#endif
    if (on) {
      if (fast) {"""),
    ("""      CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
        s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                     sv[decltype(n)::value],
                                     s[decltype(p)::value]);
      });""",
     """#ifdef STUB_CG
      s[0] = xv[0] * sv[0];
#else
      CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
        s[decltype(p)::value] = fmaf(cf * xv[decltype(m)::value],
                                     sv[decltype(n)::value],
                                     s[decltype(p)::value]);
      });
#endif"""),
    ("""namespace {

constexpr int TF = 16;""",
     """#ifdef STUB_EF
#define EF_K 1
#else
#define EF_K H
#endif
namespace {

constexpr int TF = 16;"""),
    ("""    // message cotangent, once per atom: gm[p][r] = alpha sum_o W[r,o] g[p,o]
    for (int g = 0; g < P.n_grp; ++g) {""",
     """    // message cotangent, once per atom: gm[p][r] = alpha sum_o W[r,o] g[p,o]
#ifdef STUB_SI2
    for (int i = tid; i < P.agg_dim; i += NT) gm_s[i] = g_s[i % P.d_out];
    if (false)
#endif
    for (int g = 0; g < P.n_grp; ++g) {"""),
    ("""    // per-atom self-interaction 2 over the aggregated messages
    for (int g = 0; g < P.n_grp; ++g) {""",
     """    // per-atom self-interaction 2 over the aggregated messages
#ifdef STUB_SI2
    for (int i = tid; i < P.d_out; i += NT) out_s[i] = aggp_s[i % P.agg_dim];
    if (false)
#endif
    for (int g = 0; g < P.n_grp; ++g) {"""),
]

# the same in fused_conv_body.cuh before the redesign (its M_GEOM mode)
OLD_STUBS: Stubs = [
    ("""  const int per = P.nb + P.f;
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
""",
     """  const int per = P.nb + P.f;
#ifdef STUB_GEOM
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float v = vec_s[3 * e] * 0.25f + k * 0.01f;
    if (k < P.nb) emb_s[e * P.nb + k] = v; else sh_s[e * P.f + k - P.nb] = v;
  }
  return;
#endif
  for (int i = threadIdx.x; i < rows * per; i += NT) {
    const int e = i / per, k = i - e * per;
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
"""),
    ("""  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = warp; e < rows; e += NT / 32) {
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
""",
     """  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#ifdef STUB_GEOM
  for (int i = threadIdx.x; i < rows * 3; i += NT) {
    const int e = i / 3;
    dvec[(row0 + e) * 3 + i - e * 3] = ms_s[e] != 0.f
        ? demb_s[e * P.nb + (i - e * 3)] + dsh_s[e * P.f + (i - e * 3)] : 0.f;
  }
  return;
#endif
  for (int e = warp; e < rows; e += NT / 32) {
    const float x = vec_s[3 * e], y = vec_s[3 * e + 1], z = vec_s[3 * e + 2];
"""),
    ("""                           float* h1_s, float* da0_s, float* da1_s) {
""",
     """                           float* h1_s, float* da0_s, float* da1_s) {
#ifdef STUB_HID
  for (int i = threadIdx.x; i < rows * H; i += NT) {
    const int e = i / H, j = i - e * H;
    const float v = emb_s[e * P.nb + (j & 7)] * __ldg(w1 + j);
    h0_s[i] = v; h1_s[i] = v;
    if (da0_s) { da0_s[i] = 1.f; da1_s[i] = 1.f; }
  }
  __syncthreads();
  return;
#endif
"""),
    ("""  const float* s = src + row0 * width;
  for (int i = threadIdx.x; i < rows * width; i += NT) dst[i] = s[i];
""",
     """  const float* s = src + row0 * width;
#ifdef STUB_LOAD
  if (width > 3) { if (threadIdx.x < width) dst[threadIdx.x] = s[threadIdx.x]; return; }
#endif
  for (int i = threadIdx.x; i < rows * width; i += NT) dst[i] = s[i];
"""),
    ("""            const float* hr = h1_s + e * H;
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
            w *= P.s2 * m_e;
          }
          if constexpr (SKIP & S_W) {""",
     """            const float* hr = h1_s + e * H;
#ifdef STUB_FMLP
            w = hr[e & 63] * wc[e & 63];
#else
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
#endif
            w *= P.s2 * m_e;
          }
          if constexpr (SKIP & S_W) {"""),
    ("""          if constexpr (SKIP & S_CG) {
            s = xr[0];
          } else {""",
     """          if constexpr (SKIP & S_CG) {
            s = xr[0];
          } else {
#ifdef STUB_FCG
            s = xr[p * mul] * sr[p];
            if (true) { if constexpr (EDGE) ab[p * K * RT + e] = w * s; else ab[p * K] += w * s; continue; }
#endif"""),
    ("""  // per-atom self-interaction 2 over the aggregated messages
  for (int i = tid; i < P.d_out; i += NT) out_s[i] = 0.f;""",
     """  // per-atom self-interaction 2 over the aggregated messages
#ifdef STUB_SI2
  for (int i = tid; i < P.d_out; i += NT)
    out[(long)atom * P.d_out + i] = agg_s[i % P.agg_dim];
  return;
#endif
  for (int i = tid; i < P.d_out; i += NT) out_s[i] = 0.f;"""),
    ("""            const float* hr = h1_s + e * H;
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
            w *= P.s2 * m_e;
          }
          for (int p = 0; p < d3; ++p) {""",
     """            const float* hr = h1_s + e * H;
#ifdef STUB_AMLP
            w = hr[e] * wc[e & 63];
#else
#pragma unroll
            for (int k = 0; k < H; ++k) w = fmaf(hr[k], wc[k], w);
#endif
            w *= P.s2 * m_e;
          }
#ifdef STUB_ACG
          dwe = xr[0] * sr[0] * gmb[e * gs];
          if (true) {} else
#endif
          for (int p = 0; p < d3; ++p) {"""),
    ("""      const int e = idx / P.d1, xc = idx - e * P.d1;
      float v = 0.f;
      for (int xe = 0; xe < P.n_xent; ++xe) {""",
     """      const int e = idx / P.d1, xc = idx - e * P.d1;
      float v = 0.f;
#ifdef STUB_B
      v = x_s[idx] * weff_s[e * P.n_active + (xc % P.n_active)];
      if (true) { dxg[(row0 + e) * P.d1 + xc] = v; continue; }
#endif
      for (int xe = 0; xe < P.n_xent; ++xe) {"""),
    ("""      const int e = item / P.f, sc = item - e * P.f;
      float v = 0.f;
      for (int i = 0; i < P.n_ins; ++i) {""",
     """      const int e = item / P.f, sc = item - e * P.f;
      float v = 0.f;
#ifdef STUB_C
      v = x_s[e * P.d1 + lane] * weff_s[e * P.n_active + lane];
      if (true) {} else
#endif
      for (int i = 0; i < P.n_ins; ++i) {"""),
    ("""      for (int c = q; c < P.n_active; c += KQ) {
        const float w = __ldg(w2t + (long)P.col_w[c] * H + k);""",
     """#ifdef STUB_D
#pragma unroll
      for (int e = 0; e < RT; ++e) acc[e] = dw_s[e * P.n_active + (q + KQ * k) % P.n_active] * __ldg(w2t + k);
      if (false)
#endif
      for (int c = q; c < P.n_active; c += KQ) {
        const float w = __ldg(w2t + (long)P.col_w[c] * H + k);"""),
    ("""#pragma unroll 8
      for (int k = 0; k < H; ++k) s = fmaf(dr[k], __ldg(w1t + k * H + j), s);""",
     """#pragma unroll 8
      for (int k = 0; k < EF_K; ++k) s = fmaf(dr[k], __ldg(w1t + k * H + j), s);"""),
    ("""      for (int j = lane; j < H; j += 32) s = fmaf(dr[j], __ldg(wr + j), s);""",
     """      for (int j = lane; j < (EF_K == 1 ? 32 : H); j += 32) s = fmaf(dr[j], __ldg(wr + j), s);"""),
    ("""namespace {

constexpr int H = 64;""",
     """#ifdef STUB_EF
#define EF_K 1
#else
#define EF_K H
#endif
namespace {

constexpr int H = 64;"""),
]

NEW_PASSES = ('GEOM', 'HID', 'W', 'CG', 'RED', 'D', 'EF', 'SI2')
DENSE_PASSES = ('ROWS',) + NEW_PASSES[1:]
EDGE_PASSES = DENSE_PASSES
OLD_PASSES = ('GEOM', 'HID', 'AMLP', 'ACG', 'B', 'C', 'D', 'EF', 'FMLP', 'FCG',
              'SI2', 'LOAD')


def apply(text: str, stubs: Stubs) -> str:
    """Insert every stub switch; each text must occur exactly once."""
    for old, new in stubs:
        if text.count(old) != 1:
            raise ValueError(f'stub anchor found {text.count(old)} times: '
                             f'{old[:60]!r}')
        text = text.replace(old, new)
    return text


def stubbed_source(other: str = None,
                   pair: str = 'geom') -> Tuple[str, str, Stubs, Tuple]:
    """(directory to copy, file to patch in it, stubs, passes); pair:
    'geom', 'dense' or 'edge'."""
    if other is None:
        src = cuda_build.source_path('fused_conv_geom')
        return (os.path.dirname(src), os.path.basename(src), NEW_STUBS,
                {'geom': NEW_PASSES, 'dense': DENSE_PASSES,
                 'edge': EDGE_PASSES}[pair])
    return (os.path.dirname(os.path.abspath(other)), 'fused_conv_body.cuh',
            OLD_STUBS, OLD_PASSES)


def build(other: str, out_dir: str,
          pair: str = 'geom') -> Dict[str, ctypes.CDLL]:
    src_dir, target, stubs, passes = stubbed_source(other, pair)
    work = os.path.join(out_dir, 'src')
    shutil.copytree(src_dir, work, ignore=shutil.ignore_patterns('_build'))
    path = os.path.join(work, target)
    with open(path) as fh:
        text = apply(fh.read(), stubs)
    with open(path, 'w') as fh:
        fh.write(text)
    main_src = os.path.join(work, os.path.basename(other) if other
                            else target)
    procs = {}
    for v in ('full',) + tuple(passes):
        so = os.path.join(out_dir, f'lib_{v}.so')
        flags = [] if v == 'full' else [f'-DSTUB_{v}']
        procs[v] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, '-o',
             so, main_src], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    libs = {}
    for v, (so, p) in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed on variant {v}:\n{out}\n{err}')
        lib = fc.bind_geom(ctypes.CDLL(so))
        libs[v] = lib if other else fc.bind_edge(fc.bind_dense(lib))
    return libs


def run(other: str = None, pair: str = 'geom') -> Dict:
    from ..checkpoint import SevenNetCheckpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'source': other or 'csrc/fused_conv_geom.cu',
           'pair': pair, 'layers': {}}
    dense = pair != 'geom'
    geom_lib = fc._geom_lib
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(other, tmp, pair)
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            for layer in (1, 4, 0):
                cl = model.layers[f'{layer}_convolution']
                mlp_ws, si2_ws = cl._weights()
                if dense:
                    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2,
                                        0 if pair == 'edge' else 32)
                    xg, sh, emb, ms, g = (
                        edge_inputs(conv, cl.geom, dev) if pair == 'edge'
                        else dense_inputs(conv, cl.geom, dev, 1000))

                    def fwd():
                        conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)

                    def bwd():
                        conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                             si2_ws)
                else:
                    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32,
                                        geom=cl.geom)
                    xg, vec, ms, coeffs, g = chunk_inputs(conv, dev)

                    def fwd():
                        conv.kernel_geom_forward(xg, vec, ms, coeffs, mlp_ws,
                                                 si2_ws)

                    def bwd():
                        conv.kernel_geom_backward(g, xg, vec, ms, coeffs,
                                                  mlp_ws, si2_ws)
                rows = xg.shape[0]
                reps = 20 if dense else 5
                out = {}
                for v, lib in libs.items():
                    fc._geom_lib = lambda lib=lib: lib
                    if pair == 'edge':
                        # the edge pair launches through the dispatcher op
                        torch_ops.set_kernel_library('fused_conv_geom',
                                                     lib._name)
                    out[v] = {'fwd_ms': cuda_ms(fwd, reps=reps, warm=1),
                              'bwd_ms': cuda_ms(bwd, reps=reps, warm=1)}
                    full = out['full']
                    out[v].update({f'{k[:3]}_ns_per_row_saved':
                                   (full[k] - out[v][k]) * 1e6 / rows
                                   for k in ('fwd_ms', 'bwd_ms')})
                    print(f'layer {layer} {v}: ' + json.dumps(
                        {k: round(x, 3) for k, x in out[v].items()}),
                        flush=True)
                res['layers'][layer] = out
                del xg, ms, g
                torch.cuda.empty_cache()
        finally:
            fc._geom_lib = geom_lib
            if pair == 'edge':
                torch_ops.set_kernel_library(
                    'fused_conv_geom', cuda_build.build('fused_conv_geom'))
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pair = ('edge' if '--edge' in argv else
            'dense' if '--dense' in argv else 'geom')
    other = argv[0] if argv and argv[0].endswith('.cu') else None
    if pair != 'geom' and other:
        print(f'geom_passes: --{pair} stubs the port\'s own source only',
              file=sys.stderr)
        return 2
    if not require_card('geom_passes'):
        return 2
    res = run(other, pair)
    out = [a for a in argv if a.endswith('.json')]
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out[0])), exist_ok=True)
        with open(out[0], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
