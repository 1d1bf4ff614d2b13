"""Fused convolution block on the dense neighbor grid: CUDA kernels, their
plain PyTorch versions and the autograd wrapper.

Counterpart of ``sevennet_exp_tpu/ops/pallas_conv.py::make_fused_conv``
with ``agg_d > 0`` (the ``cmshared`` kernels ``fwd_kernel_cm`` and
``bwd_kernel_cm``). Per grid row (edge) e of atom i = e // D:

    w    = FullyConnectedNet(emb[e]) * ms[e]          (radial MLP)
    msg  = uvu-TP(xg[e], sh[e]; w)                    (CG tensor product)
    y[i] = si2( sum_{e in i's D rows} msg[e] )        (self-interaction 2)

The forward returns the (N, d_out) node rows; the backward recomputes
the MLP and returns (dxg, dsh, demb) -- first order only, the mask
scale and the weights get no gradient (as the JAX ``bwd_call``).

With a ``GeomSpec`` the same block also runs geometry-fused (the
counterpart of ``make_fused_conv(geom=...)``: ``fwd_kernel_geom`` and
``bwd_kernel_geom``): it takes the raw edge vector ``vec`` and the Bessel
frequencies instead of ``sh`` and ``emb``, computes both per row inside
the kernel (``geom_rows`` is the plain version), and its backward returns
(dxg, dvec).

Built with ``ext_w=True`` the block takes the per-row weights ready-made
(the counterpart of ``make_fused_conv(ext_w=True)``: ``fwd_kernel_cm_w``
and ``bwd_kernel_cm_w``): ``fused(xg, sh, weff, si2_ws)`` with
``weff = MLP(emb) * ms`` computed by the caller (on the half list, see
``model/layers.py::_half_mlp_w``), no MLP inside, and a backward that
returns (dxg, dsh, dweff) so that autograd carries ``dweff`` back through
the caller's MLP. A row whose weights are all zero is a grid pad: its
dxg, dsh and dweff rows are zeros.

``agg_d = 0`` is the edge-row contract of the plain edge list: one
(E, d_out) output row per edge, si2 applied per row, the caller scatters
the rows onto the atoms. On the card it runs the edge pair of
``csrc/fused_conv_geom.cu`` (``fused_conv_edge_fwd`` /
``fused_conv_edge_bwd``), the dense-grid pair's template in a third mode:
its MLP and CG on tiles of rows in any order, si2 as a product over the
tile's rows per si2 group, each si2 weight read once a tile. The forward
runs group by group (the group's w pass, its CG into the group's message
tile, the product), on tiles of up to 16 rows; the backward keeps one
message cotangent per row of 8-row tiles (``edge_unsupported`` says which
plans the pair takes).

``cg_mode='terms'`` (the counterpart of ``set_cg_mode('terms')``:
``fwd_kernel`` / ``bwd_kernel``) keeps the function and swaps the kernels of
the plain contract, for either ``agg_d``, for the independently derived
pair of ``csrc/fused_conv_terms.cu`` (``ops/fused_conv_terms.py``).

On CUDA tensors the wrapper launches the kernels of
``csrc/fused_conv_geom.cu`` (built with nvcc at first use into
``_build/``): the dense-grid pair (``agg_d > 0``), its edge-row form
(``agg_d = 0``), the geometry-fused pair, and, in the build
``fused_conv_geom_extw``, the external-weight pair. The edge-row form is
launched through the PyTorch dispatcher (``ops/torch_ops.py``: the ops
``sevenn_torch::conv_edge_fwd`` / ``_bwd``), so that a traced and
exported graph (``scripts/deploy.py``) launches it too; the others
through ctypes. On CPU tensors it runs
the plain version, the XLA-path chain of ``model/layers.py::_rows_to_nodes``
(MLP -> TP -> reshape-sum -> si2). Any other device raises. The kernels of
``fused_conv_geom.cu`` read an instruction's SH block at ``l2^2`` and take
at most 16 SH components and 15 x entries (``dense_unsupported``), hidden
widths of 64 and the activations of ``_ACT_CODE``: silu and tanh in the
library ``fused_conv_geom``, ssp in ``fused_conv_geom_ssp``, the same
source built with the shifted softplus (``_geom_ssp_lib``), at a model's
first launch. The external-weight kernels read no activation. ``kernel_refusal``, decided from the layer's shapes
when the conv is built, says why the kernels do not take a layer; the
model then runs that layer as the plain chain (``model/layers.py``), and
a kernel launched on such a conv raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_build import check as _check
from .cuda_build import launch_counts, reset_launch_counts  # noqa: F401
from . import fused_conv_geom as _fcg
from . import torch_ops
from .fused_conv_geom import MAX_XENT, SHP
from .fused_conv_terms import TermsKernels, si2_unsupported
from .normalize import NORMALIZE2MOM_CST
from .spherical import _monomials, sh_coefficients, spherical_harmonics
from .tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)
from .wigner import wigner_3j

Tensor = torch.Tensor

# table layout and constants shared with csrc/fused_conv_body.cuh (Plan)
_H = 64          # radial MLP hidden width
_MAXD = 8        # offsets per key in an instruction record (irrep dim <= 7)
_I_STRIDE = 10 + 3 * _MAXD    # ints per instruction record
_G_STRIDE = 6                 # ints per si2 group record
_ACT_CODE = {'silu': 0, 'tanh': 1, 'ssp': 2}

CG_MODES = ('cmshared', 'terms')
# data-dict key under which the engine or the calculator names the mode per
# call (the JAX package's module switch set_cg_mode; absent = 'cmshared').
# It is the port's own, so it stays out of _keys.py, a copy of the JAX file
CG_MODE_KEY = 'conv_cg_mode'
# data-dict key of the switch that sends every convolution down the plain
# chain (the JAX package's pallas_tp.disabled() / use_pallas=False; absent
# = True): the trainer sets it, the calculator and the engine carry their
# ``use_kernels`` argument in it
USE_KERNELS_KEY = 'conv_use_kernels'


# ---------------------------------------------------------------------
# in-kernel edge geometry: counterpart of pallas_conv.GeomSpec / _geom_fm
# ---------------------------------------------------------------------

@dataclass(frozen=True)
class GeomSpec:
    """Static geometry of the geometry-fused conv; mirrors
    ``EdgeEmbedding``: emb_n = (2/rc) sin(c_n r)/r * env(r), Y = the
    component-normalised real SH of the (normalised) edge vector."""
    cutoff: float
    num_basis: int
    lmax: int
    cutoff_kind: str            # 'poly' | 'xplor'
    cutoff_p: float = 6.0       # poly exponent
    cutoff_on: float = 0.0      # xplor r_on
    normalize: bool = True      # SH of v/|v|


_ENV_CODE = {'poly': 0, 'xplor': 1}


def geom_rows(vec: Tensor, coeffs: Tensor, spec: GeomSpec):
    """(E, 3) edge vectors and (num_basis,) Bessel frequencies ->
    (emb (E, num_basis), sh (E, (lmax+1)^2)), row-major: the plain
    version of the kernels' geometry (``pallas_conv._geom_fm``). The
    mask is not applied here (the conv applies it through ``ms``); the
    eps keeps an exactly zero vector finite."""
    r2 = torch.sum(vec * vec, dim=-1, keepdim=True)
    r = torch.sqrt(r2 + 1e-30)
    inv_r = 1.0 / r
    if spec.cutoff_kind == 'poly':
        p = float(spec.cutoff_p)
        c0 = (p + 1.0) * (p + 2.0) / 2.0
        c1 = p * (p + 2.0)
        c2 = p * (p + 1.0) / 2.0
        rr = r * (1.0 / spec.cutoff)
        rp = rr ** p
        env = 1.0 - c0 * rp + c1 * rp * rr - c2 * rp * rr * rr
    elif spec.cutoff_kind == 'xplor':
        r_on2 = spec.cutoff_on ** 2
        rc2 = spec.cutoff ** 2
        smooth = ((rc2 - r2) ** 2 * (rc2 + 2.0 * r2 - 3.0 * r_on2)
                  / (rc2 - r_on2) ** 3)
        env = torch.where(r < spec.cutoff_on, torch.ones_like(r), smooth)
    else:
        raise ValueError(spec.cutoff_kind)
    emb = (torch.sin(coeffs.to(vec.dtype) * r)
           * ((2.0 / spec.cutoff) * inv_r * env))
    u = vec * inv_r if spec.normalize else vec
    sh = spherical_harmonics(spec.lmax, u, normalize=False,
                             normalization='component')
    return emb, sh


def _sh_terms(lmax: int):
    """The SH polynomials as a flat term list for the kernels:
    Y_j(u) = sum over terms t in [off[j], off[j+1]) of
    coef[t] * ux^a uy^b uz^c, (a, b, c) packed in idx[t] with j."""
    idx, coef, off = [], [], [0]
    j = 0
    for l in range(lmax + 1):
        C = np.asarray(sh_coefficients(l)) * math.sqrt(2 * l + 1)
        monos = _monomials(l)
        for m in range(2 * l + 1):
            for k, (a, b, c) in enumerate(monos):
                if abs(C[m, k]) < 1e-14:
                    continue
                idx.append(a | (b << 4) | (c << 8) | (j << 12))
                coef.append(float(C[m, k]))
            off.append(len(idx))
            j += 1
    return idx, coef, off


# ---------------------------------------------------------------------
# plan builders: copies of pallas_conv._tp_plan / _si2_groups / _si2_plan
# ---------------------------------------------------------------------

def _tp_plan(spec: UVUTensorProductSpec):
    s1 = spec.irreps_in1.slices()
    s2 = spec.irreps_in2.slices()
    plan = []
    w_off = 0
    fan = {}
    for (i1, i2, k) in spec.instructions:
        fan[k] = fan.get(k, 0) + spec.irreps_in2[i2].mul
    for (i1, i2, k) in spec.instructions:
        mul1, ir1 = spec.irreps_in1[i1]
        _, ir2 = spec.irreps_in2[i2]
        mul3, ir3 = spec.irreps_out[k]
        alpha = math.sqrt((2 * ir3.l + 1) / fan[k])
        C = wigner_3j(ir1.l, ir2.l, ir3.l) * alpha
        nz = [
            (m, n, p, float(C[m, n, p]))
            for m in range(ir1.dim)
            for n in range(ir2.dim)
            for p in range(ir3.dim)
            if abs(C[m, n, p]) > 1e-12
        ]
        plan.append(dict(
            k=k, mul=mul1, x_off=s1[i1].start, sh_off=s2[i2].start,
            w_off=w_off, dim3=ir3.dim, ir3=ir3, nz=tuple(nz),
            dim1=ir1.dim, dim2=ir2.dim,
        ))
        w_off += mul1
    return plan, w_off


def _si2_groups(tp_spec: UVUTensorProductSpec, si2: LinearSpec):
    """Group-major view of the TP->si2 contraction: one group per si2
    output entry j, listing the TP output entries k that feed it in
    weight-row order."""
    per_k, d_out = _si2_plan(tp_spec, si2)
    plan, _ = _tp_plan(tp_spec)
    by_k = {p['k']: p for p in plan}
    groups = {}
    for k, info in per_k.items():
        j = info['j']
        g = groups.setdefault(j, dict(
            path=info['path'], alpha=info['alpha'], mo=info['mo'],
            out_off=info['out_off'], dim3=info['dim3'], ks=[],
        ))
        assert g['path'] == info['path'], 'si2: >1 path per output entry'
        g['ks'].append((by_k[k], info['row']))
    out = []
    for j in sorted(groups):
        g = groups[j]
        g['ks'].sort(key=lambda t: t[1])
        off = 0
        for p_ins, row in g['ks']:
            assert row == off, 'si2 rows not contiguous'
            off += p_ins['mul']
        g['K'] = off
        out.append(g)
    return out, d_out


def _si2_plan(tp_spec: UVUTensorProductSpec, si2: LinearSpec):
    """Map TP output entries (k) to si2 output entries (j) with per-k
    row offsets into the si2 path weight matrices."""
    out_offsets = []
    off = 0
    for mul, ir in si2.irreps_out:
        out_offsets.append(off)
        off += mul * ir.dim
    d_out = off
    simp = si2.irreps_in
    k_row = {}
    si = 0
    consumed = 0
    for k, (mul_k, ir_k) in enumerate(tp_spec.irreps_out):
        while simp[si].ir != ir_k or consumed >= simp[si].mul:
            si += 1
            consumed = 0
        k_row[k] = (si, consumed)
        consumed += mul_k
    path_by_entry = {}
    for n, (i, j, mi, mo, alpha) in enumerate(si2.paths):
        # FusedConv refuses such an si2 before planning (si2_unsupported)
        assert i not in path_by_entry, 'si2: an input entry feeds two outputs'
        path_by_entry[i] = (n, j, mi, mo, alpha)
    per_k = {}
    for k, (mul_k, ir_k) in enumerate(tp_spec.irreps_out):
        si_idx, row = k_row[k]
        if si_idx not in path_by_entry:
            continue
        n, j, mi, mo, alpha = path_by_entry[si_idx]
        per_k[k] = dict(path=n, row=row, j=j, mo=mo, alpha=alpha,
                        out_off=out_offsets[j],
                        dim3=si2.irreps_out[j].ir.dim)
    return per_k, d_out


# ---------------------------------------------------------------------
# kernel build and binding (nvcc -> shared library -> ctypes)
# ---------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_TABLE_ARGS = [_P] * 9          # ins, col_ins, col_w, nz_idx, nz_coef,
#                                 grp, grp_alpha, xent, xins
_DIM_ARGS = [_I] * 14 + [_F] * 4  # n_atoms, D, d1, f, nb, wn, d_out,
#   n_ins, n_active, n_grp, n_xent, agg_dim, n_nz, act, act_cst, s0, s1, s2


_GEOM_ARGS = [_P] * 4 + [_I] * 3 + [_F] * 3   # coeffs, sh_idx, sh_coef,
#   sh_off, n_terms, env_kind, normalize, cutoff, env_p, r_on


def _bind_rows_pair(fwd, bwd):
    """argtypes of a pair with kernels 1-2's arguments (xg, sh, emb, ms,
    weights ...)."""
    fwd.argtypes = [_P] * 8 + _TABLE_ARGS + _DIM_ARGS + [_P, _P]
    fwd.restype = _I
    bwd.argtypes = [_P] * 11 + _TABLE_ARGS + _DIM_ARGS + [_P, _P, _P, _P]
    bwd.restype = _I


@functools.lru_cache(maxsize=None)
def _extw_lib():
    """The external-weight pair, csrc/fused_conv_geom.cu built as
    ``fused_conv_geom_extw``."""
    return bind_extw(cuda_build.load('fused_conv_geom_extw'))


def bind_extw(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries ``fused_conv_extw_fwd`` / ``_bwd`` (and their
    resources) of a library with this ABI (the port's; ``tools/bwd_ab.py
    --extw`` binds an earlier tree's own)."""
    lib.fused_conv_extw_fwd.argtypes = ([_P] * 4 + _TABLE_ARGS + _DIM_ARGS
                                        + [_I, _I, _I, _P, _P])
    lib.fused_conv_extw_fwd.restype = _I
    lib.fused_conv_extw_bwd.argtypes = ([_P] * 5 + _TABLE_ARGS + _DIM_ARGS
                                        + [_I, _I, _P, _P, _P, _P])
    lib.fused_conv_extw_bwd.restype = _I
    for res in (lib.fused_conv_extw_resources,
                lib.fused_conv_extw_fwd_resources):
        res.argtypes = _TABLE_ARGS + _DIM_ARGS + [_P]
        res.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _geom_lib():
    """The dense-grid pair, its edge-row form and the geometry-fused pair,
    csrc/fused_conv_geom.cu, for the activations silu and tanh."""
    return bind_edge(bind_dense(bind_geom(cuda_build.load('fused_conv_geom'))))


@functools.lru_cache(maxsize=None)
def _geom_ssp_lib():
    """The same kernels for the shifted softplus (activation code 2)."""
    return bind_edge(bind_dense(bind_geom(
        cuda_build.load('fused_conv_geom_ssp'))))


def bind_edge(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries ``fused_conv_edge_fwd`` / ``_bwd`` of the
    edge-row pair (kernels 1-2 at ``agg_d = 0``) of a library: the port's,
    or another build with the same ABI for an A/B (``tools/geom_ab.py
    --edge``, an earlier tree's ``csrc/fused_conv_geom.cu``)."""
    _bind_rows_pair(lib.fused_conv_edge_fwd, lib.fused_conv_edge_bwd)
    return lib


def bind_dense(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries ``fused_conv_fwd`` / ``_bwd`` of the dense-grid
    pair (kernels 1-2) of a library: the port's, or another build with the
    same ABI for an A/B (``tools/geom_ab.py --dense``)."""
    _bind_rows_pair(lib.fused_conv_fwd, lib.fused_conv_bwd)
    return lib


def bind_geom(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries ``fused_conv_geom_fwd`` / ``_bwd`` of a library
    (the port's, or another build with the same ABI for an A/B:
    ``tools/geom_ab.py``)."""
    lib.fused_conv_geom_fwd.argtypes = ([_P] * 7 + _TABLE_ARGS + _DIM_ARGS
                                        + _GEOM_ARGS + [_P, _P])
    lib.fused_conv_geom_fwd.restype = _I
    lib.fused_conv_geom_bwd.argtypes = ([_P] * 10 + _TABLE_ARGS + _DIM_ARGS
                                        + _GEOM_ARGS + [_P, _P, _P])
    lib.fused_conv_geom_bwd.restype = _I
    return lib


# ---------------------------------------------------------------------
# the fused conv
# ---------------------------------------------------------------------

@dataclass
class _Tables:
    """Device tables of one layer's plan (see csrc/fused_conv_body.cuh)."""
    ins: Tensor
    col_ins: Tensor
    col_w: Tensor
    nz_idx: Tensor
    nz_coef: Tensor
    grp: Tensor
    grp_alpha: Tensor
    xent: Tensor
    xins: Tensor
    dead_w: Tensor               # MLP output columns no instruction reads
    n_dead: int
    n_ins: int
    n_active: int
    n_grp: int
    n_xent: int
    agg_dim: int
    n_nz: int
    unsupported: Optional[str]   # why the kernels cannot take this plan


class FusedConv:
    """fused(xg, sh, emb, ms, mlp_ws, si2_ws) -> (N, d_out) node rows on
    the dense grid of ``agg_d`` rows per atom, or (E, d_out) edge rows
    with ``agg_d = 0`` (see module docstring); the counterpart of the
    function ``make_fused_conv(...)`` returns. With ``geom`` it also
    offers the geometry-fused call
    ``apply_geom(xg, vec, ms, coeffs, mlp_ws, si2_ws)``; with ``ext_w``
    the call is ``fused(xg, sh, weff, si2_ws)``.

    ``cg_mode`` (the JAX package's ``set_cg_mode``) picks the kernels of
    the plain contract on the card: ``'cmshared'`` (default) kernels 1-2 of
    ``csrc/fused_conv_geom.cu``, ``'terms'`` the independently derived pair of
    ``csrc/fused_conv_terms.cu``, for either ``agg_d``. The function and
    its plain version are the same. Under ``'terms'`` the geometry-fused
    and the external-weight contracts do not exist."""

    def __init__(self, tp_spec: UVUTensorProductSpec,
                 mlp_spec: FullyConnectedNetSpec, si2_spec: LinearSpec,
                 agg_d: int, geom: Optional[GeomSpec] = None,
                 ext_w: bool = False, cg_mode: str = 'cmshared'):
        assert agg_d >= 0
        assert len(mlp_spec.hs) == 4, 'kernel assumes 2 hidden layers'
        assert not (ext_w and geom is not None)
        if cg_mode not in CG_MODES:
            raise ValueError(f'cg_mode {cg_mode!r}: one of {CG_MODES}')
        if cg_mode == 'terms' and (ext_w or geom is not None):
            raise ValueError("cg_mode 'terms' has no geometry-fused and no "
                             'external-weight kernels')
        self.cg_mode = cg_mode
        self._terms = (TermsKernels(tp_spec, mlp_spec, si2_spec)
                       if cg_mode == 'terms' else None)
        # an si2 input entry that feeds several output entries (fault C.3)
        # is refused before any table is built: the tables keep one path
        # per input entry
        self._si2_refusal = si2_unsupported(si2_spec)
        self.tp, self.mlp, self.si2 = tp_spec, mlp_spec, si2_spec
        self.agg_d = agg_d
        self.group = max(agg_d, 1)     # input rows per output row
        self.geom = geom
        self.ext_w = ext_w
        if geom is not None:
            if geom.num_basis != mlp_spec.hs[0]:
                raise ValueError('geom: num_basis != radial MLP input width')
            if (geom.lmax + 1) ** 2 != tp_spec.irreps_in2.dim:
                raise ValueError('geom: (lmax+1)^2 != filter width')
            if geom.cutoff_kind not in _ENV_CODE:
                raise ValueError(f'geom: envelope {geom.cutoff_kind!r}')
            if geom.lmax > 3:
                raise ValueError('geom: the kernels take lmax <= 3')
        self.plan, self.w_numel = _tp_plan(tp_spec)
        if geom is not None and any(p['sh_off'] != (p['dim2'] // 2) ** 2
                                    for p in self.plan):
            # the kernels read an instruction's SH block at l2^2
            raise ValueError('geom: the filter irreps are not 1x0+1x1+...')
        self.groups, self.d_out = ((), si2_spec.irreps_out.dim) \
            if self._si2_refusal else _si2_groups(tp_spec, si2_spec)
        self.d1 = tp_spec.irreps_in1.dim
        self.f = tp_spec.irreps_in2.dim
        self.nb = mlp_spec.hs[0]
        self._tables: Dict[torch.device, _Tables] = {}
        self._geom_tables: Dict[torch.device, tuple] = {}
        self._packed: Dict[tuple, tuple] = {}
        # why the kernels cannot take this layer (None: they can), from its
        # shapes alone; the model sends a refused layer down the plain chain
        self.kernel_refusal: Optional[str] = self._refusal()

    def _refusal(self) -> Optional[str]:
        """The rules of ``_dims``, the tables, ``dense_unsupported`` and
        ``edge_unsupported`` for the grid degree and mode this conv was
        built for: the first that refuses the layer, or None. An si2 input
        entry that feeds several output entries refuses every form."""
        if self._si2_refusal:
            return self._si2_refusal
        why = self.kernel_tables(torch.device('cpu')).unsupported
        if self.ext_w:
            # the radial MLP runs outside the external-weight kernels
            return why or extw_unsupported(self)
        act = self.mlp.act
        if act not in _ACT_CODE:
            return f'fused conv kernel: activation {act!r}'
        if self.mlp.hs[1] != _H or self.mlp.hs[2] != _H:
            return (f'fused conv kernel: hidden widths must be {_H}; got '
                    f'{list(self.mlp.hs[1:3])}')
        if why or self._terms is not None:
            return why or self._terms.refusal(self.agg_d)
        return (dense_unsupported(self.tp) if self.agg_d > 0
                else edge_unsupported(self))

    # -- plain version ------------------------------------------------
    def plain_forward(self, xg, sh, emb, ms, mlp_ws, si2_ws) -> Tensor:
        """The XLA-path chain (``model/layers.py::_rows_to_nodes``)."""
        w = self.mlp.apply({f'w{i}': v for i, v in enumerate(mlp_ws)},
                           emb) * ms
        return self.plain_extw_forward(xg, sh, w, si2_ws)

    def plain_backward(self, g, xg, sh, emb, ms, mlp_ws, si2_ws):
        """(dxg, dsh, demb): the VJP of ``plain_forward`` by autograd."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (xg, sh, emb)]
            out = self.plain_forward(
                *ins, ms.detach(), tuple(w.detach() for w in mlp_ws),
                tuple(w.detach() for w in si2_ws))
            return torch.autograd.grad(out, ins, g)

    def plain_extw_forward(self, xg, sh, weff, si2_ws) -> Tensor:
        """TP on given weights -> sum over the group's rows -> si2."""
        message = self.tp.apply(xg, sh, weff)
        agg = message.reshape(
            (message.shape[0] // self.group, self.group)
            + message.shape[1:]).sum(1)
        return self.si2.apply({f'w{n}': v for n, v in enumerate(si2_ws)},
                              agg, skip_bias=True)

    def plain_extw_backward(self, g, xg, sh, weff, si2_ws):
        """(dxg, dsh, dweff): the VJP of ``plain_extw_forward`` by
        autograd; dweff is zero on rows whose weights are all zero (grid
        pads: the caller's mask scale removes them anyway)."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (xg, sh, weff)]
            out = self.plain_extw_forward(
                *ins, tuple(w.detach() for w in si2_ws))
            dxg, dsh, dweff = torch.autograd.grad(out, ins, g)
        live = (weff != 0).any(dim=1, keepdim=True)
        return dxg, dsh, dweff * live

    def plain_geom_forward(self, xg, vec, ms, coeffs, mlp_ws,
                           si2_ws) -> Tensor:
        """``geom_rows`` followed by ``plain_forward``."""
        emb, sh = geom_rows(vec, coeffs, self.geom)
        return self.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)

    def plain_geom_backward(self, g, xg, vec, ms, coeffs, mlp_ws, si2_ws):
        """(dxg, dvec): the VJP of ``plain_geom_forward`` by autograd."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (xg, vec)]
            out = self.plain_geom_forward(
                *ins, ms.detach(), coeffs.detach(),
                tuple(w.detach() for w in mlp_ws),
                tuple(w.detach() for w in si2_ws))
            return torch.autograd.grad(out, ins, g)

    # -- kernel tables ------------------------------------------------
    def kernel_tables(self, device) -> _Tables:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = self._build_tables(device)
        return t

    def geom_tables(self, device):
        """(sh_idx, sh_coef, sh_off) device tables of the SH terms."""
        t = self._geom_tables.get(device)
        if t is None:
            idx, coef, off = _sh_terms(self.geom.lmax)
            t = self._geom_tables[device] = (
                torch.tensor(idx, dtype=torch.int32, device=device),
                torch.tensor(coef, dtype=torch.float32, device=device),
                torch.tensor(off, dtype=torch.int32, device=device))
        return t

    def _build_tables(self, device) -> _Tables:
        active = []   # (p_ins, offset in the aggregate, component stride)
        grp_rows, grp_alpha = [], []
        agg_off = 0
        w_offs = np.cumsum([0] + [mi * mo for (_, _, mi, mo, _)
                                  in self.si2.paths])
        for gi, g in enumerate(self.groups):
            grp_rows.append([g['K'], g['mo'], g['dim3'], g['out_off'],
                             agg_off, int(w_offs[g['path']])])
            grp_alpha.append(g['alpha'])
            # the aggregate keeps the message layout of the plain chain:
            # instruction blocks [p][u] back to back inside the si2 input
            # entry, which si2 then reads as (dim3, K) row-major -- the
            # XLA path's layout (see the module docstring)
            for p_ins, row in g['ks']:
                active.append((p_ins, agg_off + row * g['dim3'],
                               p_ins['mul']))
            agg_off += g['K'] * g['dim3']
        unsupported = next((
            f'fused conv kernel takes irreps of dim < {_MAXD}; got '
            f"{p['dim1']}, {p['dim2']}, {p['dim3']}"
            for p, _, _ in active
            if max(p['dim1'], p['dim2'], p['dim3']) >= _MAXD), None)
        sections = ([], [], [])    # nz sorted by p, by n, by m
        ins_rows, col_ins, col_w = [], [], []
        col0 = 0
        for a, (p_ins, agg, K) in enumerate(active):
            rec = [p_ins['x_off'], p_ins['mul'], p_ins['sh_off'],
                   p_ins['w_off'], p_ins['dim1'], p_ins['dim2'],
                   p_ins['dim3'], agg, K, col0]
            # key index in (m, n, p, c): p=2, n=1, m=0
            for sec, key, dim in ((0, 2, p_ins['dim3']),
                                  (1, 1, p_ins['dim2']),
                                  (2, 0, p_ins['dim1'])):
                offs = []
                for v in range(dim + 1):
                    offs.append(len(sections[sec]) + sum(
                        1 for t in p_ins['nz'] if t[key] < v))
                sections[sec].extend(sorted(p_ins['nz'],
                                            key=lambda t: t[key]))
                rec.extend(offs + [offs[-1]] * (_MAXD - len(offs)))
            ins_rows.append(rec)
            col_ins.extend([a] * p_ins['mul'])
            col_w.extend(range(p_ins['w_off'], p_ins['w_off']
                               + p_ins['mul']))
            col0 += p_ins['mul']
        # the three nz sections share one index space
        base = [0, len(sections[0]), len(sections[0]) + len(sections[1])]
        for rec in ins_rows:
            for s in range(3):
                for j in range(_MAXD):
                    rec[10 + s * _MAXD + j] += base[s]
        nz_all = sections[0] + sections[1] + sections[2]
        nz_idx = [m | (n << 8) | (p << 16) for (m, n, p, _) in nz_all]
        nz_coef = [c for (_, _, _, c) in nz_all]
        xent, xins = [], []
        for (mul, ir), sl in zip(self.tp.irreps_in1,
                                 self.tp.irreps_in1.slices()):
            users = [a for a, (p_ins, _, _) in enumerate(active)
                     if p_ins['x_off'] == sl.start]
            xent.append([sl.start, mul, ir.dim, len(users), len(xins)])
            xins.extend(users)

        dead_w = sorted(set(range(self.w_numel)) - set(col_w))

        def it(v):
            return torch.tensor(np.asarray(v, np.int32).reshape(-1),
                                device=device)

        def ft(v):
            return torch.tensor(np.asarray(v, np.float32).reshape(-1),
                                device=device)

        return _Tables(
            ins=it(ins_rows), col_ins=it(col_ins), col_w=it(col_w),
            nz_idx=it(nz_idx), nz_coef=ft(nz_coef), grp=it(grp_rows),
            grp_alpha=ft(grp_alpha), xent=it(xent),
            xins=it(xins if xins else [0]),
            dead_w=it(dead_w if dead_w else [0]), n_dead=len(dead_w),
            n_ins=len(active),
            n_active=col0, n_grp=len(self.groups), n_xent=len(xent),
            agg_dim=agg_off, n_nz=len(nz_all), unsupported=unsupported,
        )

    def _pack(self, mlp_ws, si2_ws):
        """Kernel-side weight layouts -- w1 and w2 transposed (none
        without MLP weights), si2 flat and si2 transposed flat -- cached
        per set of weight tensors. An entry holds its weights, so their
        ids stay unique while it lives."""
        ws = (*mlp_ws, *si2_ws)
        key = tuple((id(w), w._version) for w in ws)
        got = self._packed.get(key)
        if got is None:
            if len(self._packed) >= 16:
                self._packed.clear()
            mlp = ()
            if mlp_ws:
                w0, w1, w2 = (w.contiguous() for w in mlp_ws)
                mlp = (w0, w1, w1.t().contiguous(), w2, w2.t().contiguous())
            si2 = torch.cat([w.reshape(-1) for w in si2_ws]).contiguous()
            si2t = torch.cat([w.t().reshape(-1) for w in si2_ws]
                             ).contiguous()
            got = (ws, (*mlp, si2, si2t))
            self._packed[key] = got
        return got[1]

    def _dims(self, t: _Tables, rows: int):
        if self.kernel_refusal:
            raise ValueError(self.kernel_refusal)
        act = 'silu' if self.ext_w else self.mlp.act
        return [rows // self.group, self.group, self.d1, self.f, self.nb,
                self.w_numel, self.d_out, t.n_ins, t.n_active, t.n_grp,
                t.n_xent, t.agg_dim, t.n_nz, self.act_code,
                NORMALIZE2MOM_CST[act], 1.0 / math.sqrt(self.nb),
                1.0 / math.sqrt(_H), 1.0 / math.sqrt(_H)]

    def _check_inputs(self, xg, sh, emb, ms, *rest):
        self._check_rows(xg=(xg, self.d1), sh=(sh, self.f),
                         emb=(emb, self.nb), ms=(ms, 1))
        self._check_tensors(xg, sh, emb, ms, *rest)

    def _check_rows(self, **named):
        """Every (tensor, width) is (rows, width) with rows % D == 0. (The
        kernels form every global offset in 64 bits; one block per atom
        bounds a launch at 2^31 - 1 atoms.)"""
        rows = named['xg'][0].shape[0]
        if rows % self.group:
            raise ValueError(f'{rows} rows is not a multiple of D')
        for name, (t, width) in named.items():
            if tuple(t.shape) != (rows, width):
                raise ValueError(f'{name}: shape {tuple(t.shape)} != '
                                 f'{(rows, width)}')

    @staticmethod
    def _check_tensors(first, *rest):
        for t in (first, *rest):
            if t.device != first.device or t.dtype != torch.float32:
                raise ValueError('fused conv kernel takes float32 tensors '
                                 'on one CUDA device')
            if not t.is_contiguous():
                raise ValueError('fused conv kernel takes contiguous tensors')

    @staticmethod
    def _ptr(t: Tensor):
        return ctypes.c_void_p(t.data_ptr())

    def _entry(self, which: str):
        """(name, C entry point) of the dense-grid kernel 1 or 2
        (``which``: fwd | bwd) in csrc/fused_conv_geom.cu."""
        if self.kernel_refusal:
            raise ValueError(self.kernel_refusal)
        name = f'fused_conv_{which}'
        return name, getattr(self._geom_kernels(), name)

    def _geom_kernels(self) -> ctypes.CDLL:
        """The library of csrc/fused_conv_geom.cu built for this layer's
        activation."""
        return _geom_ssp_lib() if self.mlp.act == 'ssp' else _geom_lib()

    def kernel_forward(self, xg, sh, emb, ms, mlp_ws, si2_ws) -> Tensor:
        """Launch ``fused_conv_fwd``, or with ``agg_d = 0`` the op
        ``sevenn_torch::conv_edge_fwd`` (``fused_conv_edge_fwd``); under
        ``cg_mode='terms'`` ``fused_conv_terms_fwd`` (CUDA tensors only)."""
        self._check_inputs(xg, sh, emb, ms)
        if self._terms is not None:
            if self.kernel_refusal:
                raise ValueError(self.kernel_refusal)
            w0, w1, _, w2, _, si2, _ = self._pack(mlp_ws, si2_ws)
            return self._terms.forward(self.agg_d, xg, sh, emb, ms, w0, w1,
                                       w2, si2)
        if self.agg_d == 0:
            return torch_ops.edge_forward(self, xg, sh, emb, ms, mlp_ws,
                                          si2_ws)
        t = self.kernel_tables(xg.device)
        w0, w1, _, w2, _, si2, _ = self._pack(mlp_ws, si2_ws)
        rows = xg.shape[0]
        out = torch.empty((rows // self.group, self.d_out),
                          dtype=xg.dtype, device=xg.device)
        P = self._ptr
        name, entry = self._entry('fwd')
        err = entry(
            P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w2), P(si2),
            *self._table_ptrs(t), *self._dims(t, rows), P(out),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, name)
        launch_counts[name] += 1
        return out

    def kernel_backward(self, g, xg, sh, emb, ms, mlp_ws, si2_ws):
        """Launch ``fused_conv_bwd``, or with ``agg_d = 0`` the op
        ``sevenn_torch::conv_edge_bwd`` (``fused_conv_edge_bwd``); under
        ``cg_mode='terms'`` ``fused_conv_terms_bwd`` (CUDA tensors only)."""
        g = g.contiguous()
        self._check_inputs(xg, sh, emb, ms, g)
        rows = xg.shape[0]
        if tuple(g.shape) != (rows // self.group, self.d_out):
            raise ValueError(f'g: shape {tuple(g.shape)}')
        if self._terms is not None:
            if self.kernel_refusal:
                raise ValueError(self.kernel_refusal)
            w0, w1, w1t, w2, _, _, si2t = self._pack(mlp_ws, si2_ws)
            return self._terms.backward(self.agg_d, g, xg, sh, emb, ms, w0,
                                        w1, w1t, w2, si2t)
        if self.agg_d == 0:
            return torch_ops.edge_backward(self, g, xg, sh, emb, ms, mlp_ws,
                                           si2_ws)
        t = self.kernel_tables(xg.device)
        w0, w1, w1t, w2, w2t, _, si2t = self._pack(mlp_ws, si2_ws)
        dxg = torch.empty_like(xg)
        dsh = torch.empty_like(sh)
        demb = torch.empty_like(emb)
        P = self._ptr
        name, entry = self._entry('bwd')
        err = entry(
            P(g), P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w1t),
            P(w2), P(w2t), P(si2t), *self._table_ptrs(t),
            *self._dims(t, rows),
            P(dxg), P(dsh), P(demb),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, name)
        launch_counts[name] += 1
        return dxg, dsh, demb

    @staticmethod
    def table_tensors(t: _Tables):
        """The kernel tables in the C entries' (and the ops') order."""
        return (t.ins, t.col_ins, t.col_w, t.nz_idx, t.nz_coef, t.grp,
                t.grp_alpha, t.xent, t.xins)

    def _table_ptrs(self, t: _Tables):
        return [self._ptr(v) for v in self.table_tensors(t)]

    @property
    def act_code(self) -> int:
        """The activation's code in ``_dims`` (it picks the library); the
        external-weight kernels read no activation."""
        return _ACT_CODE['silu' if self.ext_w else self.mlp.act]

    def _geom_args(self, coeffs: Tensor):
        if self.geom is None:
            raise ValueError('this FusedConv was built without a GeomSpec')
        if tuple(coeffs.shape) != (self.nb,):
            raise ValueError(f'coeffs: shape {tuple(coeffs.shape)}')
        g = self.geom
        sh_idx, sh_coef, sh_off = self.geom_tables(coeffs.device)
        return [self._ptr(coeffs), self._ptr(sh_idx), self._ptr(sh_coef),
                self._ptr(sh_off), sh_idx.numel(), _ENV_CODE[g.cutoff_kind],
                int(g.normalize), g.cutoff, g.cutoff_p, g.cutoff_on]

    def kernel_geom_forward(self, xg, vec, ms, coeffs, mlp_ws,
                            si2_ws) -> Tensor:
        """Launch ``fused_conv_geom_fwd`` (CUDA tensors only)."""
        self._check_rows(xg=(xg, self.d1), vec=(vec, 3), ms=(ms, 1))
        self._check_tensors(xg, vec, ms, coeffs)
        geom_args = self._geom_args(coeffs)
        t = self.kernel_tables(xg.device)
        w0, w1, _, w2, _, si2, _ = self._pack(mlp_ws, si2_ws)
        rows = xg.shape[0]
        out = torch.empty((rows // self.group, self.d_out),
                          dtype=xg.dtype, device=xg.device)
        P = self._ptr
        err = self._geom_kernels().fused_conv_geom_fwd(
            P(xg), P(vec), P(ms), P(w0), P(w1), P(w2), P(si2),
            *self._table_ptrs(t), *self._dims(t, rows), *geom_args, P(out),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, 'fused_conv_geom_fwd')
        launch_counts['fused_conv_geom_fwd'] += 1
        return out

    def kernel_geom_backward(self, g, xg, vec, ms, coeffs, mlp_ws, si2_ws):
        """Launch ``fused_conv_geom_bwd`` (CUDA tensors only); returns
        (dxg, dvec), every row written (zeros where ms == 0)."""
        g = g.contiguous()
        self._check_rows(xg=(xg, self.d1), vec=(vec, 3), ms=(ms, 1))
        rows = xg.shape[0]
        if tuple(g.shape) != (rows // self.group, self.d_out):
            raise ValueError(f'g: shape {tuple(g.shape)}')
        self._check_tensors(xg, vec, ms, coeffs, g)
        dxg = torch.empty_like(xg)
        geom_args = self._geom_args(coeffs)
        t = self.kernel_tables(xg.device)
        w0, w1, w1t, w2, w2t, _, si2t = self._pack(mlp_ws, si2_ws)
        dvec = torch.empty_like(vec)
        P = self._ptr
        err = self._geom_kernels().fused_conv_geom_bwd(
            P(g), P(xg), P(vec), P(ms), P(w0), P(w1), P(w1t), P(w2),
            P(w2t), P(si2t), *self._table_ptrs(t), *self._dims(t, rows),
            *geom_args, P(dxg), P(dvec),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, 'fused_conv_geom_bwd')
        launch_counts['fused_conv_geom_bwd'] += 1
        return dxg, dvec

    def kernel_extw_forward(self, xg, sh, weff, si2_ws) -> Tensor:
        """Launch ``fused_conv_extw_fwd`` (CUDA tensors only)."""
        self._check_rows(xg=(xg, self.d1), sh=(sh, self.f),
                         weff=(weff, self.w_numel))
        self._check_tensors(xg, sh, weff)
        t = self.kernel_tables(xg.device)
        si2, _ = self._pack((), si2_ws)
        rows = xg.shape[0]
        out = torch.empty((rows // self.group, self.d_out),
                          dtype=xg.dtype, device=xg.device)
        P = self._ptr
        dims = _fcg.extw_dims(self)
        T, s = _fcg.extw_fwd_shape(dims)
        err = _extw_lib().fused_conv_extw_fwd(
            P(xg), P(sh), P(weff), P(si2), *self._table_ptrs(t),
            *self._dims(t, rows), T, s, _fcg.extw_fwd_words(dims, T, s),
            P(out),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, 'fused_conv_extw_fwd')
        launch_counts['fused_conv_extw_fwd'] += 1
        return out

    def kernel_extw_backward(self, g, xg, sh, weff, si2_ws):
        """Launch ``fused_conv_extw_bwd`` (CUDA tensors only); returns
        (dxg, dsh, dweff), every element written: zeros on rows whose
        weights are all zero and in the dweff columns no instruction
        reads."""
        g = g.contiguous()
        self._check_rows(xg=(xg, self.d1), sh=(sh, self.f),
                         weff=(weff, self.w_numel))
        rows = xg.shape[0]
        if tuple(g.shape) != (rows // self.group, self.d_out):
            raise ValueError(f'g: shape {tuple(g.shape)}')
        self._check_tensors(xg, sh, weff, g)
        t = self.kernel_tables(xg.device)
        _, si2t = self._pack((), si2_ws)
        dxg = torch.empty_like(xg)
        dsh = torch.empty_like(sh)
        dweff = torch.empty_like(weff)
        P = self._ptr
        dims = _fcg.extw_dims(self)
        T = _fcg.extw_tile(dims)
        err = _extw_lib().fused_conv_extw_bwd(
            P(g), P(xg), P(sh), P(weff), P(si2t), *self._table_ptrs(t),
            *self._dims(t, rows), T, _fcg.extw_words(dims, T),
            P(dxg), P(dsh), P(dweff),
            ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
        _check(err, 'fused_conv_extw_bwd')
        launch_counts['fused_conv_extw_bwd'] += 1
        return dxg, dsh, dweff

    def extw_resources(self, device, fwd: bool = False) -> _fcg.Resources:
        """The external-weight backward (``fwd``: forward) this layer
        launches: registers, local bytes a thread, blocks an SM and dynamic
        shared bytes (on the current card)."""
        t = self.kernel_tables(device)
        out = (ctypes.c_int * 4)()
        name = ('fused_conv_extw_fwd_resources' if fwd
                else 'fused_conv_extw_resources')
        _check(getattr(_extw_lib(), name)(
            *self._table_ptrs(t), *self._dims(t, self.group), out), name)
        return _fcg.Resources(*out)

    # -- dispatch -----------------------------------------------------
    @staticmethod
    def _by_device(t: Tensor, plain, kernel):
        """The plain version for a CPU tensor, the kernel for a CUDA one."""
        if t.device.type == 'cpu':
            return plain
        if t.device.type == 'cuda':
            return kernel
        raise ValueError(f'fused conv: no kernel for device {t.device}')

    def forward(self, xg, sh, emb, ms, mlp_ws, si2_ws) -> Tensor:
        return self._by_device(xg, self.plain_forward, self.kernel_forward)(
            xg, sh, emb, ms, mlp_ws, si2_ws)

    def backward(self, g, xg, sh, emb, ms, mlp_ws, si2_ws):
        return self._by_device(xg, self.plain_backward, self.kernel_backward)(
            g, xg, sh, emb, ms, mlp_ws, si2_ws)

    def geom_forward(self, xg, vec, ms, coeffs, mlp_ws, si2_ws) -> Tensor:
        return self._by_device(xg, self.plain_geom_forward,
                               self.kernel_geom_forward)(
            xg, vec, ms, coeffs, mlp_ws, si2_ws)

    def geom_backward(self, g, xg, vec, ms, coeffs, mlp_ws, si2_ws):
        return self._by_device(xg, self.plain_geom_backward,
                               self.kernel_geom_backward)(
            g, xg, vec, ms, coeffs, mlp_ws, si2_ws)

    def extw_forward(self, xg, sh, weff, si2_ws) -> Tensor:
        return self._by_device(xg, self.plain_extw_forward,
                               self.kernel_extw_forward)(xg, sh, weff, si2_ws)

    def extw_backward(self, g, xg, sh, weff, si2_ws):
        return self._by_device(xg, self.plain_extw_backward,
                               self.kernel_extw_backward)(
            g, xg, sh, weff, si2_ws)

    def __call__(self, xg, sh, *rest) -> Tensor:
        """(xg, sh, emb, ms, mlp_ws, si2_ws), or with ``ext_w``
        (xg, sh, weff, si2_ws), with autograd."""
        if self.ext_w:
            weff, si2_ws = rest
            return _FusedConvExtWFn.apply(self, xg, sh, weff, *si2_ws)
        emb, ms, mlp_ws, si2_ws = rest
        return _FusedConvFn.apply(self, len(mlp_ws), xg, sh, emb, ms,
                                  *mlp_ws, *si2_ws)

    def apply_geom(self, xg, vec, ms, coeffs, mlp_ws, si2_ws) -> Tensor:
        """The geometry-fused call with autograd: (N, d_out) node rows,
        gradients to xg and vec."""
        return _FusedConvGeomFn.apply(self, len(mlp_ws), xg, vec, ms, coeffs,
                                      *mlp_ws, *si2_ws)


class _FusedConvFn(torch.autograd.Function):
    """Forward: fused conv. Backward: (dxg, dsh, demb); None for the mask
    scale and the weights (first-order, forces only)."""

    @staticmethod
    def forward(ctx, conv, n_mlp, xg, sh, emb, ms, *ws):
        mlp_ws, si2_ws = ws[:n_mlp], ws[n_mlp:]
        ctx.conv, ctx.n_mlp = conv, n_mlp
        ctx.save_for_backward(xg, sh, emb, ms, *ws)
        return conv.forward(xg, sh, emb, ms, mlp_ws, si2_ws)

    @staticmethod
    def backward(ctx, g):
        xg, sh, emb, ms, *ws = ctx.saved_tensors
        n_mlp = ctx.n_mlp
        dxg, dsh, demb = ctx.conv.backward(g, xg, sh, emb, ms,
                                           tuple(ws[:n_mlp]),
                                           tuple(ws[n_mlp:]))
        return (None, None, dxg, dsh, demb, None) + (None,) * len(ws)


class _FusedConvExtWFn(torch.autograd.Function):
    """Forward: external-weight fused conv. Backward: (dxg, dsh, dweff);
    None for the si2 weights. ``dweff`` goes back to autograd, which runs
    it through the caller's radial MLP."""

    @staticmethod
    def forward(ctx, conv, xg, sh, weff, *si2_ws):
        ctx.conv = conv
        ctx.save_for_backward(xg, sh, weff, *si2_ws)
        return conv.extw_forward(xg, sh, weff, si2_ws)

    @staticmethod
    def backward(ctx, g):
        xg, sh, weff, *si2_ws = ctx.saved_tensors
        dxg, dsh, dweff = ctx.conv.extw_backward(g, xg, sh, weff,
                                                 tuple(si2_ws))
        return (None, dxg, dsh, dweff) + (None,) * len(si2_ws)


class _FusedConvGeomFn(torch.autograd.Function):
    """Forward: geometry-fused conv. Backward: (dxg, dvec); None for the
    mask scale, the Bessel frequencies and the weights."""

    @staticmethod
    def forward(ctx, conv, n_mlp, xg, vec, ms, coeffs, *ws):
        ctx.conv, ctx.n_mlp = conv, n_mlp
        ctx.save_for_backward(xg, vec, ms, coeffs, *ws)
        return conv.geom_forward(xg, vec, ms, coeffs, ws[:n_mlp],
                                 ws[n_mlp:])

    @staticmethod
    def backward(ctx, g):
        xg, vec, ms, coeffs, *ws = ctx.saved_tensors
        n_mlp = ctx.n_mlp
        dxg, dvec = ctx.conv.geom_backward(g, xg, vec, ms, coeffs,
                                           tuple(ws[:n_mlp]),
                                           tuple(ws[n_mlp:]))
        return (None, None, dxg, dvec, None, None) + (None,) * len(ws)


def filter_unsupported(tp_spec: UVUTensorProductSpec,
                       kernel: str) -> Optional[str]:
    """Why the kernels built on the dense backward's class pass (rows 1-2,
    5-6 and 8) cannot take this filter, or None: they keep an instruction's
    SH operands in registers at the offset ``l2^2``, at most 16 of them."""
    plan, _ = _tp_plan(tp_spec)
    if tp_spec.irreps_in2.dim > SHP:
        return (f'{kernel} conv kernel takes at most {SHP} SH components;'
                f' got {tp_spec.irreps_in2.dim}')
    if any(p['sh_off'] != (p['dim2'] // 2) ** 2 for p in plan):
        return (f'{kernel} conv kernel reads an instruction\'s SH block '
                'at l2^2: the filter irreps are not 1x0+1x1+...')
    return None


def dense_unsupported(tp_spec: UVUTensorProductSpec) -> Optional[str]:
    """Why the dense-grid and geometry-fused kernels cannot take this tensor
    product, or None: ``filter_unsupported``, and the backward's table of x
    entries has 15 rows."""
    why = filter_unsupported(tp_spec, 'dense-grid')
    if why:
        return why
    if len(tp_spec.irreps_in1) >= MAX_XENT:
        return (f'dense-grid conv kernel takes fewer than {MAX_XENT} x '
                f'entries; got {len(tp_spec.irreps_in1)}')
    return None


def extw_unsupported(conv: 'FusedConv') -> Optional[str]:
    """Why the external-weight pair cannot take this layer, or None: they
    run the dense pair's CG (``filter_unsupported``; any number of x
    entries: the backward's class table is sized by the plan), and need a
    tile of 8 rows (backward) and of 4 (forward) in one block's shared
    memory."""
    why = filter_unsupported(conv.tp, 'external-weight')
    if why:
        return why
    dims = _fcg.extw_dims(conv)
    if _fcg.extw_tile(dims) == 0 or _fcg.extw_fwd_shape(dims)[0] == 0:
        return ('external-weight conv kernel: no tile in '
                f'{_fcg.MAX_SMEM} shared bytes')
    return None


def edge_unsupported(conv: 'FusedConv') -> Optional[str]:
    """Why the edge-row pair (``agg_d = 0``) cannot take this layer, or
    None: ``dense_unsupported``, a forward tile of fewer than 8 rows in two
    blocks' shared words (per row the widest si2 group's w and the largest
    group's messages), or backward shared memory past one block an SM (one
    message cotangent per row of a tile)."""
    why = dense_unsupported(conv.tp)
    if why:
        return why
    dims = _fcg.layer_dims(conv, 0)
    F = _fcg.edge_fwd_plan(dims, conv.kernel_tables(torch.device('cpu')))
    if F.T == 0:
        return (f'edge-row conv kernel: not {_fcg.RB} rows of a tile in '
                f'{_fcg.TWO_PER_SM} shared bytes (w of {F.nc4} columns, '
                f'{F.slice4} message words a row)')
    smem = _fcg.shape(dims, True, edge=True).smem
    if smem > _fcg.MAX_SMEM:
        return (f'edge-row conv kernel: {smem} shared bytes a block '
                f'(at most {_fcg.MAX_SMEM})')
    return None


def _live_rows(ms: Tensor) -> float:
    """Rows of ``ms`` with a nonzero entry: the mask scale (rows, 1), or
    the external weights (rows, w_numel), whose all-zero rows are pads."""
    return float((ms != 0).any(dim=1).sum().item())


def conv_cost(conv: FusedConv, ms: Tensor, geom: bool = False,
              ext_w: bool = False) -> Tuple[float, float, float]:
    """(forward flops, backward flops, rows that carry an edge) for one
    launch on the mask scale ``ms``: the work this run's data needs --
    the kernels skip rows with ms == 0 and instructions no si2 path
    reads. A multiply-add counts as 2 flops. ``geom``: the geometry-fused
    pair, which adds the Bessel, envelope and SH arithmetic per row (a
    transcendental counted as one operation) and its VJP. ``ext_w``: the
    external-weight pair, ``ms`` being its ``weff``: no MLP operations."""
    real = _live_rows(ms)
    n_out = ms.shape[0] // conv.group
    H = conv.mlp.hs[1]
    active = [(p_ins, g) for g in conv.groups for p_ins, _ in g['ks']]
    n_active = sum(p['mul'] for p, _ in active)
    mlp = 0 if ext_w else conv.nb * H + H * H + H * n_active
    cg = sum(p['mul'] * len(p['nz']) for p, _ in active)
    si2 = sum(g['K'] * g['mo'] * g['dim3'] for g in conv.groups)
    # si2 per output row; at agg_d = 0 an output row is an input row, and
    # a pad row's is zero without any work
    si2_rows = real if conv.agg_d == 0 else n_out
    # forward: MLP, CG (2 multiplies + 1 add per nonzero -> ~1.5 MAC)
    # and the si2 per output row
    fwd = 2.0 * real * (mlp + 1.5 * cg) + 2.0 * si2_rows * si2
    # backward: W.g per output row, MLP recompute, CG for dw_eff, dsh and
    # dxg, then the MLP backward (output layer + both hidden layers)
    bwd = 2.0 * si2_rows * si2 + 2.0 * real * (2 * mlp + 4.5 * cg)
    if geom:
        # r, 1/r, envelope (~20), nb x (sin, 3 products), 3 products and
        # one multiply-add per SH term; the backward recomputes it and
        # runs the VJP at about twice that
        geo = 20.0 + 4.0 * conv.nb + 5.0 * len(_sh_terms(conv.geom.lmax)[0])
        fwd += real * geo
        bwd += 3.0 * real * geo
    return fwd, bwd, real


def conv_bytes(conv: FusedConv, ms: Tensor, geom: bool = False,
               ext_w: bool = False) -> Tuple[float, float]:
    """(forward bytes, backward bytes) one launch must move on the mask
    scale ``ms``: each input read once, each output written once. Per-row
    inputs count only on rows with ms != 0 and only in the xg and sh
    columns a live instruction reads; ms is read on every row; the MLP's
    last weight only in its live columns. The backward writes dxg, dsh
    and demb on every row (zeros where nothing flows). ``geom``: the
    geometry-fused pair reads the 3 vec columns in place of sh and emb
    and its backward writes dxg and dvec only. ``ext_w``: ``ms`` is
    ``weff``; no MLP weights, no emb and no mask column; the live weight
    columns are read on the live rows, and the backward writes dweff there
    (the zeros it writes elsewhere are not counted)."""
    rows = ms.shape[0]
    real = _live_rows(ms)
    n_out = rows // conv.group
    H = conv.mlp.hs[1]
    active = [p_ins for g in conv.groups for p_ins, _ in g['ks']]
    n_active = sum(p['mul'] for p in active)
    x_cols, sh_cols = set(), set()
    for p in active:
        x_cols.update(range(p['x_off'], p['x_off'] + p['dim1'] * p['mul']))
        sh_cols.update(range(p['sh_off'], p['sh_off'] + p['dim2']))
    weights = sum(g['K'] * g['mo'] for g in conv.groups)
    if not ext_w:
        weights += conv.nb * H + H * H + H * n_active
    live_out = 0.0
    if geom:
        edge_in, edge_out = 3, conv.d1 + 3
        weights += conv.nb            # the Bessel frequencies
    elif ext_w:
        edge_in, edge_out = len(sh_cols) + n_active, conv.d1 + conv.f
        live_out = real * n_active
    else:
        edge_in, edge_out = len(sh_cols) + conv.nb, conv.d1 + conv.f + conv.nb
    reads = (real * (len(x_cols) + edge_in) + (0 if ext_w else rows)
             + weights)
    fwd = 4.0 * (reads + n_out * conv.d_out)
    bwd = 4.0 * (reads + n_out * conv.d_out + rows * edge_out + live_out)
    return fwd, bwd
