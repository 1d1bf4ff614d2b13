"""The ``terms`` kernels of the fused convolution: plan, tables and
launchers of ``csrc/fused_conv_terms.cu``.

Both launches are planned here. The forward's (``terms_fwd_plan``): tiles
of ``T`` rows (16 when two blocks fit on an SM, else 8), the fold entries
of the SH into the CG (B, per row and live instruction), the CG units and
row groups, the compact message and the si2 paths as the product reads
them. The backward's (``terms_bwd_plan``): tiles of ``T`` rows (16 at
``agg_d > 0`` when two blocks fit on an SM, else 8), the w pass's rows per
item ``R``, the CG items by x entry, the compact message cotangent and the
words of the folded CG ``Q``. Each C entry holds the shared words against
its own layout and refuses a plan that differs. The SH operands sit at
``l2^2`` in the backward's registers: a filter that is not ``1x0+1x1+...``
of ``l <= 3`` is refused (``terms_unsupported``), and so is an si2 input
entry that feeds several output entries (``si2_unsupported``).

Counterpart of ``sevennet_exp_tpu/ops/pallas_conv.py::make_fused_conv``
under ``set_cg_mode('terms')`` (``fwd_kernel`` / ``bwd_kernel``): the same
function as the default kernels of ``ops/fused_conv.py``, derived
independently of them so that one can check the other. Nothing here reads
``fused_conv._Tables`` or its plan builders: the plan follows the two specs
directly. The message has the layout ``UVUTensorProductSpec.apply`` returns
(``fused_tp._plan``'s ``out_off``), and the self-interaction reads it the
way ``LinearSpec.apply`` does -- the slice of input entry i as a
(dim, mul_in) row-major matrix -- so the kernels agree with the plain chain
also where si2 merges several l > 0 entries of the tensor product.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from . import cuda_build
from .cuda_build import launch_counts
from .fused_tp import TermPool, _plan, pack_plan
from .normalize import NORMALIZE2MOM_CST
from .tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

Tensor = torch.Tensor

_H = 64
_ACT_CODE = {'silu': 0, 'tanh': 1, 'ssp': 2}
_POOL = TermPool('fused_conv_terms', 'fused_conv_terms')
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                  ctypes.c_float)
_TERMS_ARGS = [_P] * 2 + [_I] * 3 + [_L] + [_I] * 6 + [_F] * 4
_BWD_ARGS = [_P] * 4 + [_I] * 10
_FWD_ARGS = [_P] * 4 + [_I] * 10

NT = 256                 # threads per block
NW = NT // 32            # warps per block
SHS = 16                 # sh row stride in the backward's shared memory
KS = 4                   # pass D: parts of the live columns
B_STRIDE, X_STRIDE, G_STRIDE = 9, 8, 6     # backward table records
FI_STRIDE, FO_STRIDE = 7, 6                # forward table records
TWO_PER_SM = (233472 - 2 * 1024) // 2      # shared bytes a block, 2 an SM
MAX_SMEM = 232448                          # shared bytes a block at most


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('fused_conv_terms')
    lib.fused_conv_terms_fwd.argtypes = ([_P] * 8 + _TERMS_ARGS + _FWD_ARGS
                                         + [_P, _P])
    lib.fused_conv_terms_fwd.restype = _I
    lib.fused_conv_terms_fwd_resources.argtypes = [_I, _I, _P]
    lib.fused_conv_terms_fwd_resources.restype = _I
    lib.fused_conv_terms_bwd.argtypes = ([_P] * 11 + _TERMS_ARGS
                                         + _BWD_ARGS + [_P] * 4)
    lib.fused_conv_terms_bwd.restype = _I
    lib.fused_conv_terms_bwd_resources.argtypes = [_I, _I, _P]
    lib.fused_conv_terms_bwd_resources.restype = _I
    return lib


@dataclass
class TermsPlan:
    """Host tables of one layer (see csrc/fused_conv_terms.cu)."""
    ins: np.ndarray         # live instructions' records
    slices: np.ndarray
    idx: np.ndarray
    coef: np.ndarray
    live_cols: np.ndarray   # MLP output columns a live instruction reads
    paths: np.ndarray       # (n_paths, 6): in_off, mi, mo, dim, out_off, w_off
    path_alpha: np.ndarray
    col_path: np.ndarray    # (d_out,) path writing the output column or -1
    msg_path: np.ndarray    # (d_msg,) path reading the message element or -1
    d_msg: int
    d_out: int


def si2_unsupported(si2: LinearSpec) -> Optional[str]:
    """Why the conv kernels' tables cannot take this si2, or None: they keep
    one si2 path per input entry, so an input entry that feeds more than
    one output entry (output irreps that repeat an irrep as separate
    entries) is refused, and the layer runs the plain chain."""
    fan = Counter(i for i, *_ in si2.paths)
    i, n = max(fan.items(), key=lambda t: t[1], default=(0, 0))
    if n > 1:
        return (f'fused conv kernel: si2 input entry {i} '
                f'({si2.irreps_in[i]}) feeds {n} output entries; the kernel '
                'tables keep one si2 path per input entry')
    return None


def terms_plan(tp: UVUTensorProductSpec, si2: LinearSpec) -> TermsPlan:
    plan, d_msg, _ = _plan(tp)
    if si2.irreps_in.dim != d_msg:
        raise ValueError('si2 does not read the tensor product output')
    why = si2_unsupported(si2)
    if why:
        raise ValueError(why)
    in_slices = si2.irreps_in.slices()
    out_slices = si2.irreps_out.slices()
    d_out = si2.irreps_out.dim
    paths, alphas = [], []
    col_path = np.full(d_out, -1, np.int32)
    msg_path = np.full(d_msg, -1, np.int32)
    w_off = 0
    for n, (i, j, mi, mo, alpha) in enumerate(si2.paths):
        dim = si2.irreps_in[i].ir.dim
        if (col_path[out_slices[j]] >= 0).any():
            raise ValueError('si2: more than one path per output entry')
        col_path[out_slices[j]] = n
        msg_path[in_slices[i]] = n
        paths.append([in_slices[i].start, mi, mo, dim, out_slices[j].start,
                      w_off])
        alphas.append(alpha)
        w_off += mi * mo
    # an instruction is live when a path reads its output entry
    live = [p for p in plan if msg_path[p['out_off']] >= 0]
    ins, slices, idx, coef = pack_plan(live)
    live_cols = np.concatenate(
        [np.arange(p['w_off'], p['w_off'] + p['mul']) for p in live]
        or [np.zeros(0)]).astype(np.int32)
    return TermsPlan(
        ins=ins, slices=slices, idx=idx, coef=coef, live_cols=live_cols,
        paths=np.asarray(paths, np.int32).reshape(-1, 6),
        path_alpha=np.asarray(alphas, np.float32), col_path=col_path,
        msg_path=msg_path, d_msg=d_msg, d_out=d_out)


def _r4(n: int) -> int:
    return (n + 3) & ~3


@dataclass
class TermsBwdPlan:
    """The backward's tables and launch numbers for one layer and form (see
    csrc/fused_conv_terms.cu): records of the live instructions (``bins``,
    term offsets relative to the plan's terms), of the x entries
    (``xcls``) with their users, of the si2 paths with their compact
    message offsets (``gpaths``); the live message elements ``n_msg``, the
    words of Q ``n_q``, the live columns rounded up to 4 ``nls``, the CG
    items of a tile (or a row) ``n_items``, the tile ``T``, the w pass's
    rows per item ``R`` and the shared words of a block."""
    bins: np.ndarray
    xcls: np.ndarray
    users: np.ndarray
    gpaths: np.ndarray
    n_msg: int
    n_q: int
    nls: int
    n_items: int
    T: int
    R: int
    words: int
    agg: bool


@dataclass
class TermsFwdPlan:
    """The forward's tables and launch numbers for one layer and form (see
    csrc/fused_conv_terms.cu): records of the live instructions (``fins``:
    x offset, mul, l1, l3, their block in a row's folded CG B, first live
    column, compact message offset), the fold entries (``folds``: one per
    instruction and output component p, with its terms of the pool), the si2
    paths as the product reads them (``fpaths``: the backward's gm product
    with rows and columns swapped) and the output columns no path writes
    (``unfed``); the live message elements ``n_msg``, the words of a row's B
    ``nB``, the live columns rounded up to 4 ``nls``, the tile ``T``, the w
    pass's rows per item ``R``, the CG's row groups ``s`` and the shared
    words of a block."""
    fins: np.ndarray
    folds: np.ndarray
    fpaths: np.ndarray
    unfed: np.ndarray
    n_msg: int
    nB: int
    nls: int
    T: int
    R: int
    s: int
    words: int


def fwd_words(n_fins: int, n_folds: int, n_units: int, n_paths: int,
              nb: int, T: int, s: int, nls: int, nB: int, n_msg: int,
              agg: bool) -> int:
    """Shared words of one forward block (the C side's fwd_layout)."""
    words = (_r4(n_fins * FI_STRIDE) + _r4(n_folds * FO_STRIDE)
             + _r4(2 * n_units) + _r4(n_paths * G_STRIDE) + T * SHS
             + _r4(nb * T) + _r4(T) + 2 * _H * T + T * nls + T * nB)
    return words + (s * _r4(n_msg) if agg else T * n_msg)


def cg_row_groups(n_units: int, T: int) -> int:
    """Row groups of the forward's CG (1, 2 or 4, at least 4 rows each): the
    fewest rounds of the block's warps over (unit, row group) items, a row
    counted as one and an item's start as two; ties to fewer groups."""
    best = None
    for s in (1, 2, 4):
        if T % (4 * s):
            continue
        cost = -(-n_units * s // NW) * (T // s + 2)
        if best is None or cost < best[0]:
            best = (cost, s)
    return best[1]


def terms_fwd_plan(tp: UVUTensorProductSpec, plan: TermsPlan, nb: int,
                   agg_d: int) -> Optional[TermsFwdPlan]:
    """The forward's plan at ``agg_d`` (None when no tile fits a block's
    shared memory). Tiles of 16 rows when two blocks fit on an SM, else 8."""
    agg = agg_d > 0
    full, _, _ = _plan(tp)
    live = [p for p in full if plan.msg_path[p['out_off']] >= 0]
    cin, c = [], 0
    for in_off, mi, mo, dim, out_off, w_off in plan.paths.tolist():
        cin.append(c)
        c += dim * mi
    n_msg = c
    fpaths = np.asarray([[out_off, mo, mi, dim, cin[i], w_off] for i, (
        in_off, mi, mo, dim, out_off, w_off) in enumerate(
            plan.paths.tolist())], np.int32).reshape(-1, G_STRIDE)
    p_of = (plan.idx >> 16) & 0xff
    fins, folds, col0, b = [], [], 0, 0
    for a, p in enumerate(live):
        pth = int(plan.msg_path[p['out_off']])
        in_off = int(plan.paths[pth, 0])
        d1, d3 = p['dim1'], p['dim3']
        fins.append([p['x_off'], p['mul'], d1 // 2, d3 // 2, b, col0,
                     p['out_off'] - in_off + cin[pth]])
        tf0, tf1 = plan.ins[a, 6:8].tolist()
        for pc in range(d3):
            # the forward terms are sorted by p: one run per component
            ts = np.nonzero(p_of[tf0:tf1] == pc)[0] + tf0
            t0, t1 = (int(ts[0]), int(ts[-1]) + 1) if ts.size else (tf0, tf0)
            folds.append([b + pc, _r4(d3), d1, p['sh_off'], t0, t1])
        b += d1 * _r4(d3)
        col0 += p['mul']
    # a row's B: per instruction D1 rows of its D3 components rounded up to
    # 4 (16-byte loads); rows an odd number of 16 bytes apart, so that the
    # fold's lanes (rows) spread over the banks
    nB = b + 4 if b % 8 == 0 else b
    nls = _r4(col0)
    n_units = plan.slices.shape[0]
    cands = [16, 8]

    def words(T):
        return fwd_words(len(fins), len(folds), n_units, plan.paths.shape[0],
                         nb, T, cg_row_groups(n_units, T), nls, nB, n_msg,
                         agg)

    fits = [t for t in cands if 4 * words(t) <= TWO_PER_SM] or \
        [t for t in cands[::-1] if 4 * words(t) <= MAX_SMEM]
    if not fits:
        return None
    T = fits[0]
    return TermsFwdPlan(
        fins=np.asarray(fins, np.int32).reshape(-1, FI_STRIDE),
        folds=np.asarray(folds, np.int32).reshape(-1, FO_STRIDE),
        fpaths=fpaths,
        unfed=np.nonzero(plan.col_path < 0)[0].astype(np.int32),
        n_msg=n_msg, nB=nB, nls=nls, T=T, R=w_pass_rows(nls, T),
        s=cg_row_groups(n_units, T), words=words(T))


def si2_lanes(mo: int, shift: int = 0) -> int:
    """Lanes over column groups of the forward's agg_d = 0 si2 product
    (csrc si2_lanes): the path's groups of 4 columns rounded up to a power
    of two in [8, 32], halved ``shift`` times down to 8; the warp's other
    lanes split the reduction."""
    nc4 = -(-mo // 4)
    return max(8, (32 if nc4 > 16 else 16 if nc4 > 8 else 8) >> shift)


def si2_shift(fpaths: np.ndarray, T: int, RB: int = 8) -> int:
    """How often ``si2_rows`` halves every path's lanes: until the tile has
    at least as many warp units (path, q, row block, column block) as the
    block has warps, at most twice."""
    for shift in range(3):
        units = sum(dim * (T // RB) * -(-(-(-mo // 4)) // si2_lanes(mo, shift))
                    for _, mo, _, dim, _, _ in fpaths.tolist())
        if units >= NW:
            break
    return shift


def si2_row_work(f: TermsFwdPlan, d_out: int, RB: int = 8):
    """The agg_d = 0 si2 product's work as ``si2_rows`` maps it: per warp
    unit (path, q, row block, column block) and lane, its output columns
    and reduction indices. Returns (writes, reads): writes[e, col] counts
    the stores of row e's output column, reads[(path, q, e, c)] lists the
    reduction indices summed into column c of that path's component q."""
    T = f.T
    shift = si2_shift(f.fpaths, T, RB)
    writes = np.zeros((T, d_out), np.int64)
    reads = {}
    for pth, (ocol, mo, mi, dim, cin, w_off) in enumerate(f.fpaths.tolist()):
        C = si2_lanes(mo, shift)
        ks, ncb = 32 // C, -(-(-(-mo // 4)) // C)
        for q in range(dim):
            for rb in range(T // RB):
                for cb in range(ncb):
                    for lane in range(32):
                        j, c = lane // C, 4 * (cb * C + lane % C)
                        if c >= mo:
                            continue
                        for e in range(rb * RB, (rb + 1) * RB):
                            for t in range(min(4, mo - c)):
                                reads.setdefault((pth, q, e, c + t), []
                                                 ).extend(range(j, mi, ks))
                                if j == 0:
                                    writes[e, ocol + q * mo + c + t] += 1
    return writes, reads


def terms_unsupported(tp: UVUTensorProductSpec) -> Optional[str]:
    """Why the ``terms`` pair cannot take this tensor product, or None: its
    backward keeps an instruction's SH operands in registers at ``l2^2``,
    at most 16 of them, and runs x and SH irreps of l <= 3."""
    plan, _, _ = _plan(tp)
    if tp.irreps_in2.dim > SHS:
        return (f'terms conv kernel takes at most {SHS} SH components; got '
                f'{tp.irreps_in2.dim}')
    if any(p['sh_off'] != (p['dim2'] // 2) ** 2 for p in plan):
        return ("terms conv kernel reads an instruction's SH block at "
                'l2^2: the filter irreps are not 1x0+1x1+...')
    if any(max(p['dim1'], p['dim2']) > 7 for p in plan):
        return 'terms conv kernel takes x and SH irreps of l <= 3'
    return None


def bwd_words(n_bins: int, n_x: int, n_users: int, n_paths: int,
              d_out: int, nb: int, T: int, nls: int, n_msg: int, n_q: int,
              agg: bool) -> int:
    """Shared words of one backward block (the C side's bwd_layout)."""
    tcg = T if agg else 1
    words = (_r4(n_bins * B_STRIDE) + _r4(n_x * X_STRIDE) + _r4(n_users)
             + _r4(n_paths * G_STRIDE))
    if agg:
        words += _r4(d_out) + T * nls
    else:
        words += max(T * nls, T * _r4(d_out))
    words += _r4((1 if agg else T) * n_msg) + _r4(n_q)
    words += max(2 * _H * T + NW * tcg * SHS, KS * _H * T)
    # AGG keeps the tile's dsh rows; else each row's is stored at once
    return (words + 2 * _H * T + (2 if agg else 1) * T * SHS + _r4(nb * T)
            + _r4(T))


def w_pass_rows(nls: int, T: int) -> int:
    """Rows per item of the w pass (4, 8 or 16, dividing T): the fewest
    rounds of the block's threads, a 16-byte w2 load counted as two rows of
    work; ties to the larger."""
    best = None
    for R in (4, 8, 16):
        if T % R:
            continue
        items = (nls // 4) * (T // R)
        cost = -(-items // NT) * (R + 2)
        if best is None or cost <= best[0]:
            best = (cost, R)
    return best[1]


def terms_bwd_plan(tp: UVUTensorProductSpec, plan: TermsPlan, nb: int,
                   agg_d: int) -> Optional[TermsBwdPlan]:
    """The backward's plan at ``agg_d`` (None when no tile fits a block's
    shared memory). Tiles: 16 rows at ``agg_d > 8`` when two blocks fit on
    an SM, else 8; at ``agg_d = 0`` 8 rows."""
    agg = agg_d > 0
    full, _, _ = _plan(tp)
    live = [p for p in full if plan.msg_path[p['out_off']] >= 0]
    cin, c = [], 0
    for in_off, mi, mo, dim, out_off, w_off in plan.paths.tolist():
        cin.append(c)
        c += dim * mi
    n_msg = c
    gpaths = np.asarray([[cin[i], mi, mo, dim, out_off, w_off] for i, (
        in_off, mi, mo, dim, out_off, w_off) in enumerate(
            plan.paths.tolist())], np.int32).reshape(-1, G_STRIDE)
    bins, col0, q = [], 0, 0
    for a, p in enumerate(live):
        pth = int(plan.msg_path[p['out_off']])
        in_off, mi, _, dim = plan.paths[pth, :4].tolist()
        if p['out_off'] + p['dim3'] * p['mul'] > in_off + dim * mi:
            raise ValueError('terms plan: an instruction spans two si2 '
                             'inputs')
        l1, l2 = p['dim1'] // 2, p['dim2'] // 2
        bins.append([p['x_off'], p['mul'], l1, l2, col0,
                     p['out_off'] - in_off + cin[pth], q,
                     *plan.ins[a, 8:10].tolist()])
        col0 += p['mul']
        q += p['mul'] * p['dim1'] * p['dim2']
    nls = _r4(col0)
    xcls, users, start = [], [], 0
    cands = [16, 8] if agg_d > 8 else [8]

    def words(T):
        return bwd_words(len(bins), len(tp.irreps_in1), len(live),
                         plan.paths.shape[0], plan.d_out, nb, T, nls, n_msg,
                         q, agg)

    fits = [t for t in cands if 4 * words(t) <= TWO_PER_SM] or \
        [t for t in cands[::-1] if 4 * words(t) <= MAX_SMEM]
    if not fits:
        return None
    T = fits[0]
    tcg = T if agg else 1
    for (mul, ir), sl in zip(tp.irreps_in1, tp.irreps_in1.slices()):
        us = [a for a, p in enumerate(live) if p['x_off'] == sl.start]
        lanes = 32 if mul % 32 == 0 else mul
        xcls.append([start, lanes, mul // lanes, sl.start, mul,
                     ir.dim // 2, len(us), len(users)])
        users.extend(us)
        start += -(-tcg * mul // 32) * 32
    return TermsBwdPlan(
        bins=np.asarray(bins, np.int32).reshape(-1, B_STRIDE),
        xcls=np.asarray(xcls, np.int32).reshape(-1, X_STRIDE),
        users=np.asarray(users, np.int32), gpaths=gpaths, n_msg=n_msg,
        n_q=q, nls=nls, n_items=start, T=T, R=w_pass_rows(nls, T),
        words=words(T), agg=agg)


class TermsKernels:
    """Launchers of the ``terms`` pair for one layer's specs."""

    def __init__(self, tp: UVUTensorProductSpec, mlp: FullyConnectedNetSpec,
                 si2: LinearSpec):
        self.tp, self.mlp, self.si2 = tp, mlp, si2
        self.si2_refusal = si2_unsupported(si2)
        self.plan = None if self.si2_refusal else terms_plan(tp, si2)
        self.d1, self.f = tp.irreps_in1.dim, tp.irreps_in2.dim
        self.nb, self.wn = mlp.hs[0], mlp.hs[-1]
        self._tables: Dict[torch.device, tuple] = {}
        self._bwd: Dict[int, Optional[TermsBwdPlan]] = {}
        self._bwd_tables: Dict[tuple, tuple] = {}
        self._fwd: Dict[int, Optional[TermsFwdPlan]] = {}
        self._fwd_tables: Dict[tuple, tuple] = {}
        self._w2l = None          # (w2, its version, w2l, w2l^T)

    def bwd_plan(self, agg_d: int) -> Optional[TermsBwdPlan]:
        if agg_d not in self._bwd:
            self._bwd[agg_d] = terms_bwd_plan(self.tp, self.plan, self.nb,
                                              agg_d)
        return self._bwd[agg_d]

    def fwd_plan(self, agg_d: int) -> Optional[TermsFwdPlan]:
        if agg_d not in self._fwd:
            self._fwd[agg_d] = terms_fwd_plan(self.tp, self.plan, self.nb,
                                              agg_d)
        return self._fwd[agg_d]

    def refusal(self, agg_d: int) -> Optional[str]:
        """Why the pair cannot take this layer at ``agg_d``, or None."""
        why = self.si2_refusal or terms_unsupported(self.tp)
        for name, plan in (('backward', self.bwd_plan),
                           ('forward', self.fwd_plan)):
            if why is None and plan(agg_d) is None:
                why = (f'terms conv kernel: no {name} tile fits {MAX_SMEM} '
                       'shared bytes')
        return why

    def _device_tables(self, device):
        """The CG units (the plan's slices) and the si2 paths' alphas."""
        t = self._tables.get(device)
        if t is None:
            p = self.plan
            t = self._tables[device] = (
                torch.tensor(p.slices.reshape(-1), device=device),
                torch.tensor(p.path_alpha.reshape(-1) if p.path_alpha.size
                             else np.zeros(1, np.float32), device=device))
        return t

    def scalars(self, rows: int, agg_d: int) -> list:
        """The TERMS_ARGS after the two tables: counts, shapes, the
        activation code and its constant, the layer scales."""
        act = self.mlp.act
        if act not in _ACT_CODE:
            raise ValueError(f'terms kernel: activation {act!r}')
        if len(self.mlp.hs) != 4 or self.mlp.hs[1] != _H \
                or self.mlp.hs[2] != _H:
            raise ValueError('terms kernel: two hidden layers of width 64')
        p = self.plan
        return [p.slices.shape[0], p.live_cols.size, p.paths.shape[0], rows,
                agg_d, self.d1, self.f, self.nb, p.d_out, _ACT_CODE[act],
                NORMALIZE2MOM_CST[act], 1.0 / math.sqrt(self.nb),
                1.0 / math.sqrt(_H), 1.0 / math.sqrt(_H)]

    def _args(self, device, rows: int, agg_d: int):
        return ([ctypes.c_void_p(t.data_ptr())
                 for t in self._device_tables(device)]
                + self.scalars(rows, agg_d))

    def _fwd_device_tables(self, device, agg_d: int):
        key = (device, agg_d)
        t = self._fwd_tables.get(key)
        if t is None:
            f = self.fwd_plan(agg_d)
            folds = f.folds.copy()
            folds[:, 4:6] += _POOL.place(device, self.plan.idx,
                                         self.plan.coef)
            t = self._fwd_tables[key] = tuple(
                torch.tensor(a.reshape(-1) if a.size else np.zeros(1, a.dtype),
                             device=device)
                for a in (f.fins, folds, f.fpaths, f.unfed))
        return t

    def fwd_args(self, agg_d: int, tables) -> list:
        """The forward plan's C arguments after its four tables."""
        f = self.fwd_plan(agg_d)
        return [*(_ptr(t) for t in tables), f.fins.shape[0],
                f.folds.shape[0], f.unfed.size, f.n_msg, f.nB, f.nls, f.T,
                f.R, f.s, f.words]

    def forward(self, agg_d, xg, sh, emb, ms, w0, w1, w2, si2) -> Tensor:
        """Launch ``fused_conv_terms_fwd``; inputs checked by the caller.
        ``si2``: the path weights flat, back to back."""
        rows = xg.shape[0]
        out = torch.empty((rows // max(agg_d, 1), self.plan.d_out),
                          dtype=xg.dtype, device=xg.device)
        P = _ptr
        with torch.cuda.device(xg.device):
            w2l, _ = self._live_w2(w2)
            tables = self._fwd_device_tables(xg.device, agg_d)
            err = _lib().fused_conv_terms_fwd(
                P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w2l), P(si2),
                *self._args(xg.device, rows, agg_d),
                *self.fwd_args(agg_d, tables), P(out), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_fwd')
        launch_counts['fused_conv_terms_fwd'] += 1
        return out

    def _bwd_device_tables(self, device, agg_d: int):
        key = (device, agg_d)
        t = self._bwd_tables.get(key)
        if t is None:
            b = self.bwd_plan(agg_d)
            bins = b.bins.copy()
            bins[:, 7:9] += _POOL.place(device, self.plan.idx, self.plan.coef)
            t = self._bwd_tables[key] = tuple(
                torch.tensor(a.reshape(-1) if a.size else np.zeros(1, a.dtype),
                             device=device)
                for a in (bins, b.xcls, b.users, b.gpaths))
        return t

    def _live_w2(self, w2: Tensor):
        """w2's live columns packed, zeros up to a multiple of 4, and its
        transpose (cached for the last w2 seen)."""
        c = self._w2l
        if c is None or c[0] is not w2 or c[1] != w2._version:
            nls = _r4(self.plan.live_cols.size)
            w2l = w2.new_zeros((_H, nls))
            w2l[:, :self.plan.live_cols.size] = w2[:, torch.tensor(
                self.plan.live_cols, dtype=torch.long, device=w2.device)]
            c = self._w2l = (w2, w2._version, w2l, w2l.t().contiguous())
        return c[2], c[3]

    def backward(self, agg_d, g, xg, sh, emb, ms, w0, w1, w1t, w2, si2t):
        """Launch ``fused_conv_terms_bwd``; returns (dxg, dsh, demb), every
        row written. ``si2t``: the transposed path weights flat."""
        b = self.bwd_plan(agg_d)
        dxg, dsh, demb = (torch.empty_like(t) for t in (xg, sh, emb))
        P = _ptr
        with torch.cuda.device(xg.device):
            w2l, w2lt = self._live_w2(w2)
            tables = self._bwd_device_tables(xg.device, agg_d)
            err = _lib().fused_conv_terms_bwd(
                P(g), P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w1t),
                P(w2l), P(w2lt), P(si2t),
                *self._args(xg.device, xg.shape[0], agg_d),
                *[P(t) for t in tables], b.bins.shape[0], b.xcls.shape[0],
                b.users.size, b.n_msg, b.n_q, b.nls, b.n_items, b.T, b.R,
                b.words, P(dxg), P(dsh), P(demb), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_bwd')
        launch_counts['fused_conv_terms_bwd'] += 1
        return dxg, dsh, demb

    def bwd_resources(self, agg_d: int):
        """(registers, local bytes a thread, blocks an SM) of the backward
        instance at this layer's plan (on the current device)."""
        out = (ctypes.c_int * 3)()
        cuda_build.check(_lib().fused_conv_terms_bwd_resources(
            int(agg_d > 0), self.bwd_plan(agg_d).words, out),
            'fused_conv_terms_bwd_resources')
        return tuple(out)

    def fwd_resources(self, agg_d: int):
        """The same of the forward instance."""
        out = (ctypes.c_int * 3)()
        cuda_build.check(_lib().fused_conv_terms_fwd_resources(
            int(agg_d > 0), self.fwd_plan(agg_d).words, out),
            'fused_conv_terms_fwd_resources')
        return tuple(out)


def _ptr(t: Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
