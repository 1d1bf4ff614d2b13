"""Operations and bytes of one launch of the fused convolution pair: a frozen
copy of the program's ``conv_cost`` / ``conv_bytes`` and of the plan
builders they read (``_tp_plan``, ``_si2_plan``, ``_si2_groups``,
``_sh_terms``; ``sevennet_exp_tpu_torch/ops/fused_conv.py``), on shapes
built from the reference's own specs. The counts are of the work that this
run's data needs: rows that carry an edge (``live``) and the instructions
that some si2 path reads. A multiply-add counts as 2 operations.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..reference.spherical import _monomials, sh_coefficients
from ..reference.tensor_product import LinearSpec, UVUTensorProductSpec
from ..reference.wigner import wigner_3j


def _tp_plan(spec: UVUTensorProductSpec):
    s1 = spec.irreps_in1.slices()
    s2 = spec.irreps_in2.slices()
    plan, w_off, fan = [], 0, {}
    for (i1, i2, k) in spec.instructions:
        fan[k] = fan.get(k, 0) + spec.irreps_in2[i2].mul
    for (i1, i2, k) in spec.instructions:
        mul1, ir1 = spec.irreps_in1[i1]
        _, ir2 = spec.irreps_in2[i2]
        _, ir3 = spec.irreps_out[k]
        C = wigner_3j(ir1.l, ir2.l, ir3.l) * math.sqrt(
            (2 * ir3.l + 1) / fan[k])
        nz = [(m, n, p, float(C[m, n, p])) for m in range(ir1.dim)
              for n in range(ir2.dim) for p in range(ir3.dim)
              if abs(C[m, n, p]) > 1e-12]
        plan.append(dict(k=k, mul=mul1, x_off=s1[i1].start,
                         sh_off=s2[i2].start, dim3=ir3.dim, nz=tuple(nz),
                         dim1=ir1.dim, dim2=ir2.dim))
        w_off += mul1
    return plan, w_off


def _si2_plan(tp_spec: UVUTensorProductSpec, si2: LinearSpec):
    out_offsets, off = [], 0
    for mul, ir in si2.irreps_out:
        out_offsets.append(off)
        off += mul * ir.dim
    d_out = off
    simp = si2.irreps_in
    k_row, si, consumed = {}, 0, 0
    for k, (mul_k, ir_k) in enumerate(tp_spec.irreps_out):
        while simp[si].ir != ir_k or consumed >= simp[si].mul:
            si += 1
            consumed = 0
        k_row[k] = (si, consumed)
        consumed += mul_k
    path_by_entry = {i: (n, j, mi, mo) for n, (i, j, mi, mo, _)
                     in enumerate(si2.paths)}
    per_k = {}
    for k in range(len(tp_spec.irreps_out)):
        si_idx, row = k_row[k]
        if si_idx not in path_by_entry:
            continue
        n, j, mi, mo = path_by_entry[si_idx]
        per_k[k] = dict(path=n, row=row, j=j, mo=mo,
                        dim3=si2.irreps_out[j].ir.dim)
    return per_k, d_out


def _si2_groups(tp_spec: UVUTensorProductSpec, si2: LinearSpec):
    per_k, d_out = _si2_plan(tp_spec, si2)
    by_k = {p['k']: p for p in _tp_plan(tp_spec)[0]}
    groups = {}
    for k, info in per_k.items():
        g = groups.setdefault(info['j'], dict(mo=info['mo'],
                                              dim3=info['dim3'], ks=[]))
        g['ks'].append((by_k[k], info['row']))
    out = []
    for j in sorted(groups):
        g = groups[j]
        g['K'] = sum(p['mul'] for p, _ in g['ks'])
        out.append(g)
    return out, d_out


def sh_term_count(lmax: int) -> int:
    """Terms of the SH polynomials up to lmax (the kernels' term list)."""
    count = 0
    for l in range(lmax + 1):
        C = np.asarray(sh_coefficients(l)) * math.sqrt(2 * l + 1)
        count += int(np.sum(np.abs(C[:, :len(_monomials(l))]) >= 1e-14))
    return count


@dataclass(frozen=True)
class ConvShape:
    """What the cost of one convolution launch depends on."""
    groups: tuple
    d_out: int
    d1: int
    f: int
    nb: int
    hidden: int
    agg_d: int
    lmax: int

    @property
    def group(self) -> int:
        return max(self.agg_d, 1)


def conv_shape(tp: UVUTensorProductSpec, mlp_hs, si2: LinearSpec,
               agg_d: int, lmax: int) -> ConvShape:
    groups, d_out = _si2_groups(tp, si2)
    return ConvShape(groups=tuple(groups), d_out=d_out,
                     d1=tp.irreps_in1.dim, f=tp.irreps_in2.dim,
                     nb=mlp_hs[0], hidden=mlp_hs[1], agg_d=agg_d, lmax=lmax)


def conv_cost(c: ConvShape, rows: int, live: float,
              geom: bool = False) -> Tuple[float, float]:
    """(forward, backward) operations of one launch over ``rows`` grid
    rows of which ``live`` carry an edge."""
    H = c.hidden
    active = [p for g in c.groups for p, _ in g['ks']]
    n_active = sum(p['mul'] for p in active)
    mlp = c.nb * H + H * H + H * n_active
    cg = sum(p['mul'] * len(p['nz']) for p in active)
    si2 = sum(g['K'] * g['mo'] * g['dim3'] for g in c.groups)
    si2_rows = live if c.agg_d == 0 else rows // c.group
    fwd = 2.0 * live * (mlp + 1.5 * cg) + 2.0 * si2_rows * si2
    bwd = 2.0 * si2_rows * si2 + 2.0 * live * (2 * mlp + 4.5 * cg)
    if geom:
        geo = 20.0 + 4.0 * c.nb + 5.0 * sh_term_count(c.lmax)
        fwd += live * geo
        bwd += 3.0 * live * geo
    return fwd, bwd


def conv_bytes(c: ConvShape, rows: int, live: float,
               geom: bool = False) -> Tuple[float, float]:
    """(forward, backward) bytes one launch must move: each input read
    once, each output written once."""
    n_out = rows // c.group
    H = c.hidden
    active = [p for g in c.groups for p, _ in g['ks']]
    n_active = sum(p['mul'] for p in active)
    x_cols, sh_cols = set(), set()
    for p in active:
        x_cols.update(range(p['x_off'], p['x_off'] + p['dim1'] * p['mul']))
        sh_cols.update(range(p['sh_off'], p['sh_off'] + p['dim2']))
    weights = (sum(g['K'] * g['mo'] for g in c.groups)
               + c.nb * H + H * H + H * n_active)
    if geom:
        edge_in, edge_out = 3, c.d1 + 3
        weights += c.nb
    else:
        edge_in, edge_out = len(sh_cols) + c.nb, c.d1 + c.f + c.nb
    reads = live * (len(x_cols) + edge_in) + rows + weights
    fwd = 4.0 * (reads + n_out * c.d_out)
    bwd = 4.0 * (reads + n_out * c.d_out + rows * edge_out)
    return fwd, bwd


def linear_flops(spec: LinearSpec, rows: int) -> float:
    """Operations of one e3nn linear over ``rows`` rows (one matmul a
    path)."""
    return sum(2.0 * rows * mi * mo * spec.irreps_in[i].ir.dim
               for i, _, mi, mo, _ in spec.paths)


def roofline_s(flops: float, nbytes: float, peak_flops: float,
               peak_bw: float) -> Tuple[float, str]:
    """The least time of a launch and what bounds it."""
    t_op, t_by = flops / peak_flops, nbytes / peak_bw
    return (t_op, 'operations') if t_op >= t_by else (t_by, 'bytes')


def chunk_live(degrees: np.ndarray, deg_cap: int, chunk_rows: int
               ) -> List[Tuple[int, float]]:
    """(rows, live rows) of every launch of a layer on the dense grid of
    ``len(degrees)`` atoms x ``deg_cap`` rows, in chunks of ``chunk_rows``
    rows (0: one launch over the whole grid)."""
    rows = len(degrees) * deg_cap
    if not chunk_rows:
        return [(rows, float(degrees.sum()))]
    per = chunk_rows // deg_cap
    return [(min(chunk_rows, rows - a * deg_cap),
             float(degrees[a:a + per].sum()))
            for a in range(0, len(degrees), per)]
