"""Per-pass cost of the redesigned conv kernels (the terms pair and the
external-weight pair) and of their earlier designs, measured by stubbing
one pass at a time and timing each build: with ``--terms`` the ``terms``
backward (``--terms-fwd``: forward) on the 1k grid's shape (1,000 atoms x
32 rows, 6 pad rows an atom) and on the 1k calculator's 31,232 rows, with
``--extw`` the external-weight backward (``--extw-fwd``: forward) on the 1k
``half_mlp`` grid's shape, at checkpoint layer 1.

    python -m sevennet_exp_tpu_torch.tools.bwd_passes [OTHER_CSRC] [OUT.json] --terms | --extw | --terms-fwd | --extw-fwd

Each pass gets a ``-DSTUB_<PASS>`` switch, inserted into a temporary copy of
the source (the stand-in keeps its result live, so the compiler keeps the
rest); every variant is built with the port's nvcc flags, bound by
``bwd_ab``'s launchers and timed with ``timing.cuda_ms`` on
``bwd_ab.layer_inputs``. Per variant it prints the ms a launch and (full -
stubbed) / rows in ns a row. Without OTHER_CSRC the source is the port's
(``csrc/fused_conv_terms.cu``, or ``csrc/fused_conv_geom.cu`` built as
``fused_conv_geom_extw``); with it, an earlier tree's ``csrc`` directory
(its ``fused_conv_terms.cu``, or its ``fused_conv.cu`` whose
``fused_conv_body.cuh`` holds the first external-weight pair: each
kind's earlier switches fit a tree that still has that kernel's first
design). Needs a card (exits 2 without one).

The stand-ins (what each switch leaves of its pass):
  SI2   gm = alpha W^T g from one o instead of the sum; forwards: y = alpha
        M W from one r
  HID   the hidden layers from one input each (one basis, one hidden unit)
  W     the radial weight from one w2 row, not the 64-term sum
  CG    terms: (earlier) the last term of each instruction only, (new) T
        and V from one SH component; extw: (earlier) passes A-C from one
        product each, (new) the class pass runs no instruction; terms
        forward: (earlier) one term per component, (new) B x from one x
        component; extw forward: (earlier) one term per component, (new)
        one product per row
  Q     (new terms) Q from one term of each instruction
  FOLD  (new terms forward) B from one term per component
  RED   (new) dsh summed without the 16-value halving (one value)
  D     dh1 from one column group instead of all live columns
  EF    passes E and F with one hidden unit
  WLOAD (earlier extw, both forwards) the tile's weights not loaded (a
        function of the column or of the row's place in its atom)
  STORE (new extw) the dweff rows not written
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from typing import Dict, List, Tuple

import torch

from ..ops import cuda_build
from . import bwd_ab
from .geom_ab import CHECKPOINT, D
from .timing import card, cuda_ms, require_card

Stubs = List[Tuple[str, str, str]]   # (pass, text, text with the switch)

# the earlier terms backward (csrc/fused_conv_terms.cu before its redesign)
OLD_TERMS: Stubs = [
    ('SI2', """      for (int o = 0; o < mo; ++o) {
        const float wv = __ldg(Wt + (size_t)o * mi);""",
     """#ifdef STUB_SI2
      for (int o = 0; o < 1; ++o) {
#else
      for (int o = 0; o < mo; ++o) {
#endif
        const float wv = __ldg(Wt + (size_t)o * mi);"""),
    ('HID', """      for (int b = 0; b < A.nb; ++b)
        s = fmaf(T.emb[r * A.nb + b], __ldg(w0 + b * H + j), s);""",
     """#ifdef STUB_HID
      for (int b = 0; b < 1; ++b)
#else
      for (int b = 0; b < A.nb; ++b)
#endif
        s = fmaf(T.emb[r * A.nb + b], __ldg(w0 + b * H + j), s);"""),
    ('HID', """      for (int k = 0; k < H; ++k) s = fmaf(hr[k], __ldg(w1 + k * H + j), s);""",
     """#ifdef STUB_HID
      for (int k = 0; k < 1; ++k) s = fmaf(hr[k], __ldg(w1 + k * H + j), s);
#else
      for (int k = 0; k < H; ++k) s = fmaf(hr[k], __ldg(w1 + k * H + j), s);
#endif"""),
    ('W', """    for (int k = 0; k < H; ++k) {
      const float wv = __ldg(w2 + (size_t)k * A.wn + c);""",
     """#ifdef STUB_W
    for (int k = 0; k < 1; ++k) {
#else
    for (int k = 0; k < H; ++k) {
#endif
      const float wv = __ldg(w2 + (size_t)k * A.wn + c);"""),
    ('CG', """          while (t < t1) {      // one group of terms per filter component n""",
     """#ifdef STUB_CG
          if (t < t1) t = t1 - 1;
#endif
          while (t < t1) {      // one group of terms per filter component n"""),
    ('D', """      for (int i = 0; i < A.n_live; ++i) {""",
     """#ifdef STUB_D
      for (int i = 0; i < 1; ++i) {
#else
      for (int i = 0; i < A.n_live; ++i) {
#endif"""),
    ('EF', """      for (int k = 0; k < H; ++k) s = fmaf(dp[k], __ldg(w1t + k * H + j), s);""",
     """#ifdef STUB_EF
      for (int k = 0; k < 1; ++k) s = fmaf(dp[k], __ldg(w1t + k * H + j), s);
#else
      for (int k = 0; k < H; ++k) s = fmaf(dp[k], __ldg(w1t + k * H + j), s);
#endif"""),
    ('EF', """      for (int j = 0; j < H; ++j) s = fmaf(dp[j], __ldg(w0 + b * H + j), s);""",
     """#ifdef STUB_EF
      for (int j = 0; j < 1; ++j) s = fmaf(dp[j], __ldg(w0 + b * H + j), s);
#else
      for (int j = 0; j < H; ++j) s = fmaf(dp[j], __ldg(w0 + b * H + j), s);
#endif"""),
]

# the redesigned terms backward
NEW_TERMS: Stubs = [
    ('SI2', """#pragma unroll 4
    for (int o = o0; o < o1; ++o) {
      float4 w4;""",
     """#ifdef STUB_SI2
    for (int o = o0; o < min(o1, o0 + 1); ++o) {
#else
#pragma unroll 4
    for (int o = o0; o < o1; ++o) {
#endif
      float4 w4;"""),
    ('Q', """    for (int t = Bi[B_TB0]; t < t1; ++t) {""",
     """#ifdef STUB_Q
    for (int t = Bi[B_TB0]; t < min(t1, Bi[B_TB0] + 1); ++t) {
#else
    for (int t = Bi[B_TB0]; t < t1; ++t) {
#endif"""),
    ('HID', """        for (int b = 0; b < A.nb; ++b)
          s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);""",
     """#ifdef STUB_HID
        for (int b = 0; b < 1; ++b)
#else
        for (int b = 0; b < A.nb; ++b)
#endif
          s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);"""),
    ('HID', """#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);""",
     """#ifdef STUB_HID
        for (int k = 0; k < 1; ++k) {
#else
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
#endif
          const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);"""),
    ('W', """#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float4 w = __ldg(w4p + k * nq + cq);""",
     """#ifdef STUB_W
    for (int k = 0; k < 1; ++k) {
#else
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
#endif
      const float4 w = __ldg(w4p + k * nq + cq);"""),
    ('CG', """    for (int n = 0; n < D2; ++n) {
      const float qv = q[(m * D2 + n) * mul];""",
     """#ifdef STUB_CG
    for (int n = 0; n < 1; ++n) {
#else
    for (int n = 0; n < D2; ++n) {
#endif
      const float qv = q[(m * D2 + n) * mul];"""),
    ('RED', """__device__ __forceinline__ float warp_sum16(float (&v)[SHS], int lane) {""",
     """__device__ __forceinline__ float warp_sum16(float (&v)[SHS], int lane) {
#ifdef STUB_RED
  return v[0] + v[1];
#endif"""),
    ('D', """    for (int c = c0; c < c1; c += 4) {
      float2 wv[4];""",
     """#ifdef STUB_D
    for (int c = c0; c < min(c1, c0 + 4); c += 4) {
#else
    for (int c = c0; c < c1; c += 4) {
#endif
      float2 wv[4];"""),
    ('EF', """#pragma unroll 8
        for (int k = 0; k < H; ++k) {
          const float4 p = *reinterpret_cast<const float4*>(d1T + k * T + e0);""",
     """#ifdef STUB_EF
        for (int k = 0; k < 1; ++k) {
#else
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
#endif
          const float4 p = *reinterpret_cast<const float4*>(d1T + k * T + e0);"""),
    ('EF', """#pragma unroll 8
        for (int j = 0; j < H; ++j)
          s = fmaf(d0T[j * T + e], __ldg(w0 + b * H + j), s);""",
     """#ifdef STUB_EF
        for (int j = 0; j < 1; ++j)
#else
#pragma unroll 8
        for (int j = 0; j < H; ++j)
#endif
          s = fmaf(d0T[j * T + e], __ldg(w0 + b * H + j), s);"""),
]

# the earlier external-weight backward (bwd_body<M_EXTW> of
# fused_conv_body.cuh)
OLD_EXTW: Stubs = [
    ('SI2', """        for (int o = 0; o < mo; ++o)
          s = fmaf(__ldg(WT + (long)o * K + r), gp[o], s);""",
     """#ifdef STUB_SI2
        for (int o = 0; o < 1; ++o)
#else
        for (int o = 0; o < mo; ++o)
#endif
          s = fmaf(__ldg(WT + (long)o * K + r), gp[o], s);"""),
    ('WLOAD', """        const float w = __ldg(weff + (row0 + e) * P.wn + P.col_w[c]);""",
     """#ifdef STUB_WLOAD
        const float w = (row0 + e) % P.D < P.D - 6 ? 0.01f * (c & 7) + 0.01f
                                                   : 0.f;
#else
        const float w = __ldg(weff + (row0 + e) * P.wn + P.col_w[c]);
#endif"""),
    ('CG', """          for (int p = 0; p < d3; ++p) {
            float s = 0.f;
            const int q1 = I[I_POFF + p + 1];""",
     """#ifdef STUB_CG
          dwe = xr[0] * sr[0] * gmb[e * gs];
          if (true) {} else
#endif
          for (int p = 0; p < d3; ++p) {
            float s = 0.f;
            const int q1 = I[I_POFF + p + 1];"""),
    ('CG', """      const int e = idx / P.d1, xc = idx - e * P.d1;
      float v = 0.f;
      for (int xe = 0; xe < P.n_xent; ++xe) {""",
     """      const int e = idx / P.d1, xc = idx - e * P.d1;
      float v = 0.f;
#ifdef STUB_CG
      v = x_s[idx] * weff_s[e * P.n_active + (xc % P.n_active)];
      if (true) { dxg[(row0 + e) * P.d1 + xc] = v; continue; }
#endif
      for (int xe = 0; xe < P.n_xent; ++xe) {"""),
    ('CG', """      const int e = item / P.f, sc = item - e * P.f;
      float v = 0.f;
      for (int i = 0; i < P.n_ins; ++i) {""",
     """      const int e = item / P.f, sc = item - e * P.f;
      float v = 0.f;
#ifdef STUB_CG
      v = x_s[e * P.d1 + lane] * weff_s[e * P.n_active + lane];
      if (true) {} else
#endif
      for (int i = 0; i < P.n_ins; ++i) {"""),
]

# the redesigned external-weight backward (fused_conv_geom.cu's extw build)
NEW_EXTW: Stubs = [
    ('SI2', """#pragma unroll 4
        for (int o = o0; o < o1; ++o) {
          const float* wr = WT + (long)o * K;""",
     """#ifdef STUB_SI2
        for (int o = o0; o < min(o1, o0 + 1); ++o) {
#else
#pragma unroll 4
        for (int o = o0; o < o1; ++o) {
#endif
          const float* wr = WT + (long)o * K;"""),
    ('CG', """    for (int j = 0; j < nins; ++j) {
      const int ii = __ldg(users + j);""",
     """#ifdef STUB_CG
    for (int j = 0; j < 0; ++j) {
#else
    for (int j = 0; j < nins; ++j) {
#endif
      const int ii = __ldg(users + j);"""),
    ('RED', """  float v[SHP];
#pragma unroll
  for (int i = 0; i < SHP; ++i) v[i] = i < NSH ? dsh[i] : 0.f;""",
     """#ifdef STUB_RED
  return dsh[0] + dsh[NSH - 1];
#endif
  float v[SHP];
#pragma unroll
  for (int i = 0; i < SHP; ++i) v[i] = i < NSH ? dsh[i] : 0.f;"""),
    ('STORE', """      store_block(dweff + row0 * P.wn, rows * P.wn, [&](int i) {
        const int e = i / P.wn, c = wc_s[i - e * P.wn];
        return c >= 0 ? w_s[e * nap + c] : 0.f;
      });
    }""",
     """#ifndef STUB_STORE
      store_block(dweff + row0 * P.wn, rows * P.wn, [&](int i) {
        const int e = i / P.wn, c = wc_s[i - e * P.wn];
        return c >= 0 ? w_s[e * nap + c] : 0.f;
      });
#endif
    }"""),
]


# the earlier terms forward (csrc/fused_conv_terms.cu before its redesign):
# its hidden layers and output layer are the earlier backward's mlp_tile
OLD_TERMS_FWD: Stubs = OLD_TERMS[1:4] + [
    ('CG', """          for (int tt = t; tt < te; ++tt) {""",
     """#ifdef STUB_CG
          for (int tt = t; tt < min(te, t + 1); ++tt) {
#else
          for (int tt = t; tt < te; ++tt) {
#endif"""),
    ('SI2', """      for (int r = 0; r < mi; ++r) {
        const float wv = __ldg(W + (size_t)r * mo);""",
     """#ifdef STUB_SI2
      for (int r = 0; r < min(mi, 1); ++r) {
#else
      for (int r = 0; r < mi; ++r) {
#endif
        const float wv = __ldg(W + (size_t)r * mo);"""),
]

# the redesigned terms forward; its w pass and si2 product are the
# backward's code (the same switches)
NEW_TERMS_FWD: Stubs = [
    ('HID', """    for (int b = 0; b < A.nb; ++b)
      s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);
    h0T[i] = act_f(s * A.s0, A.act) * A.act_cst;""",
     """#ifdef STUB_HID
    for (int b = 0; b < 1; ++b)
#else
    for (int b = 0; b < A.nb; ++b)
#endif
      s = fmaf(embT[b * T + e], __ldg(w0 + b * H + j), s);
    h0T[i] = act_f(s * A.s0, A.act) * A.act_cst;"""),
    ('HID', """#pragma unroll 8
    for (int k = 0; k < H; ++k) {
      const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);""",
     """#ifdef STUB_HID
    for (int k = 0; k < 1; ++k) {
#else
#pragma unroll 8
    for (int k = 0; k < H; ++k) {
#endif
      const float4 h = *reinterpret_cast<const float4*>(h0T + k * T + e0);"""),
    NEW_TERMS[4],     # W
    ('FOLD', """    for (int t = O[O_T0]; t < t1; ++t) {""",
     """#ifdef STUB_FOLD
    for (int t = O[O_T0]; t < min(t1, O[O_T0] + 1); ++t) {
#else
    for (int t = O[O_T0]; t < t1; ++t) {
#endif"""),
    ('CG', """      for (int m = 0; m < D1; ++m) {
#pragma unroll
        for (int k = 0; k < D3P / 4; ++k) {""",
     """#ifdef STUB_CG
      for (int m = 0; m < 1; ++m) {
#else
      for (int m = 0; m < D1; ++m) {
#endif
#pragma unroll
        for (int k = 0; k < D3P / 4; ++k) {"""),
    NEW_TERMS[0],     # SI2 once an atom (agg_d = D)
    ('SI2', """#pragma unroll 4
      for (int k = j; k < mi; k += KS) {""",
     """#ifdef STUB_SI2
      for (int k = j; k < min(mi, j + 1); k += KS) {
#else
#pragma unroll 4
      for (int k = j; k < mi; k += KS) {
#endif"""),
]

# the earlier external-weight forward (fwd_body<M_EXTW> of
# fused_conv_body.cuh)
OLD_EXTW_FWD: Stubs = [
    ('WLOAD', """          if (e + 1 < rows) w_next = __ldg(wg + (long)(e + 1) * P.wn);""",
     """#ifdef STUB_WLOAD
          if (e + 1 < rows)
            w_next = (row0 + e + 1) % P.D < P.D - 6 ? 0.01f : 0.f;
#else
          if (e + 1 < rows) w_next = __ldg(wg + (long)(e + 1) * P.wn);
#endif"""),
    ('CG', """          } else {
            const int q1 = I[I_POFF + p + 1];
            for (int q = I[I_POFF + p]; q < q1; ++q) {""",
     """          } else {
            const int q1 = I[I_POFF + p + 1];
#ifdef STUB_CG
            for (int q = I[I_POFF + p]; q < min(q1, I[I_POFF + p] + 1); ++q) {
#else
            for (int q = I[I_POFF + p]; q < q1; ++q) {
#endif"""),
    ('SI2', """      for (int r = 0; r < K; ++r)
        s = fmaf(ap[r], __ldg(W + (long)r * mo + o), s);""",
     """#ifdef STUB_SI2
      for (int r = 0; r < min(K, 1); ++r)
#else
      for (int r = 0; r < K; ++r)
#endif
        s = fmaf(ap[r], __ldg(W + (long)r * mo + o), s);"""),
]

# the redesigned external-weight forward (fused_conv_geom.cu's extw build)
NEW_EXTW_FWD: Stubs = [
    ('WLOAD', """              v[k] = __ldcs(reinterpret_cast<const float4*>(
                  wrow + (long)e * P.wn + src_s[4 * (j - e * nq)]));""",
     """#ifdef STUB_WLOAD
              v[k] = (row0 + e) % P.D < P.D - 6
                         ? make_float4(0.01f, 0.01f, 0.01f, 0.01f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
#else
              v[k] = __ldcs(reinterpret_cast<const float4*>(
                  wrow + (long)e * P.wn + src_s[4 * (j - e * nq)]));
#endif"""),
    ('CG', """    CgPattern<L1, L2, L3>::each([&](auto m, auto n, auto p, float cf) {
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
    ('SI2', """        for (int r = 0; r < K; ++r)
          acc = fmaf(ap[r], __ldg(W + (long)r * mo + o), acc);""",
     """#ifdef STUB_SI2
        for (int r = 0; r < min(K, 1); ++r)
#else
        for (int r = 0; r < K; ++r)
#endif
          acc = fmaf(ap[r], __ldg(W + (long)r * mo + o), acc);"""),
]

KINDS = ('terms', 'extw', 'terms_fwd', 'extw_fwd')


def apply(text: str, stubs: Stubs) -> str:
    """Insert every stub switch; each text must occur exactly once."""
    for _, old, new in stubs:
        if text.count(old) != 1:
            raise ValueError(f'stub anchor found {text.count(old)} times: '
                             f'{old[:60]!r}')
        text = text.replace(old, new)
    return text


def plan(kind: str, other: str = None):
    """(source directory, file to patch, file to compile, stubs, macros) of
    KIND (one of ``KINDS``) in the port's csrc or in OTHER."""
    extw = kind.startswith('extw')
    fwd = kind.endswith('_fwd')
    if other is None:
        src = cuda_build.source_path('fused_conv_geom_extw' if extw
                                     else 'fused_conv_terms')
        name = os.path.basename(src)
        stubs = {'terms': NEW_TERMS, 'extw': NEW_EXTW,
                 'terms_fwd': NEW_TERMS_FWD, 'extw_fwd': NEW_EXTW_FWD}[kind]
        return (os.path.dirname(src), name, name, stubs,
                cuda_build.DEFINES['fused_conv_geom_extw'] if extw else ())
    if not extw:
        return (other, 'fused_conv_terms.cu', 'fused_conv_terms.cu',
                OLD_TERMS_FWD if fwd else OLD_TERMS, ())
    return (other, 'fused_conv_body.cuh', 'fused_conv.cu',
            OLD_EXTW_FWD if fwd else OLD_EXTW, ())


def build(kind: str, other: str, out_dir: str):
    """{variant: launcher} of every stub build (and 'full')."""
    src_dir, target, main, stubs, defines = plan(kind, other)
    work = os.path.join(out_dir, 'src')
    shutil.copytree(src_dir, work, ignore=shutil.ignore_patterns('_build'))
    path = os.path.join(work, target)
    with open(path) as fh:
        text = apply(fh.read(), stubs)
    with open(path, 'w') as fh:
        fh.write(text)
    variants = ('full',) + tuple(dict.fromkeys(p for p, _, _ in stubs))
    procs = {}
    for v in variants:
        so = os.path.join(out_dir, f'lib_{v}.so')
        flags = [] if v == 'full' else [f'-DSTUB_{v}']
        procs[v] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *defines,
             *flags, '-o', so, os.path.join(work, main)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    import ctypes
    for v, (so, p) in procs.items():
        o, e = p.communicate()
        if p.returncode:
            raise RuntimeError(f'nvcc failed on variant {v}:\n{o}\n{e}')
        out[v] = bwd_ab.launcher(kind, ctypes.CDLL(so), other is not None)
    return out


def run(kind: str, other: str = None) -> Dict:
    from ..checkpoint import SevenNetCheckpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'kind': kind,
           'source': other or 'csrc', 'shapes': {}}
    port = bwd_ab.port_launcher(kind)
    key = 'fwd_ms' if kind.endswith('_fwd') else 'bwd_ms'
    with tempfile.TemporaryDirectory() as tmp:
        launchers = build(kind, other, tmp)
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            convs = bwd_ab.layer_inputs(model, kind, dev)
            for (layer, dd), (conv, ws, ins) in convs.items():
                if layer != 1:
                    continue
                rows = ins[0].shape[0]
                out = {}
                for v, fn in launchers.items():
                    bwd_ab.install(kind, fn)
                    out[v] = {key: cuda_ms(
                        lambda: bwd_ab.call(kind, conv, ws, ins),
                        reps=20, warm=1)}
                    out[v]['ns_per_row_saved'] = (
                        (out['full'][key] - out[v][key]) * 1e6 / rows)
                    print(f'layer 1 agg_d {dd} {v}: ' + json.dumps(
                        {k: round(x, 4) for k, x in out[v].items()}),
                        flush=True)
                res['shapes'][f'layer1_agg{dd}'] = out
        finally:
            bwd_ab.install(kind, port)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = [k for k in KINDS if f'--{k.replace("_", "-")}' in argv]
    if len(kinds) != 1:
        print(__doc__.strip().splitlines()[8].strip(), file=sys.stderr)
        return 2
    if not require_card('bwd_passes'):
        return 2
    other = next((a for a in argv if not a.startswith('--')
                  and not a.endswith('.json')), None)
    res = run(kinds[0], other)
    out = [a for a in argv if a.endswith('.json')]
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out[0])), exist_ok=True)
        with open(out[0], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
