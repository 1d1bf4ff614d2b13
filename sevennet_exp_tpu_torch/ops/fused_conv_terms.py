"""The ``terms`` kernels of the fused convolution: plan, tables and
launchers of ``csrc/fused_conv_terms.cu``.

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
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from . import cuda_build
from .cuda_build import launch_counts
from .fused_tp import TermPool, _plan, device_tables, pack_plan
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
_TERMS_ARGS = [_P] * 7 + [_I] * 4 + [_L] + [_I] * 8 + [_F] * 4


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('fused_conv_terms')
    lib.fused_conv_terms_fwd.argtypes = [_P] * 8 + _TERMS_ARGS + [_P, _P]
    lib.fused_conv_terms_fwd.restype = _I
    lib.fused_conv_terms_bwd.argtypes = [_P] * 11 + _TERMS_ARGS + [_P] * 4
    lib.fused_conv_terms_bwd.restype = _I
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


def terms_plan(tp: UVUTensorProductSpec, si2: LinearSpec) -> TermsPlan:
    plan, d_msg, _ = _plan(tp)
    if si2.irreps_in.dim != d_msg:
        raise ValueError('si2 does not read the tensor product output')
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


class TermsKernels:
    """Launchers of the ``terms`` pair for one layer's specs."""

    def __init__(self, tp: UVUTensorProductSpec, mlp: FullyConnectedNetSpec,
                 si2: LinearSpec):
        self.tp, self.mlp, self.si2 = tp, mlp, si2
        self.plan = terms_plan(tp, si2)
        self.d1, self.f = tp.irreps_in1.dim, tp.irreps_in2.dim
        self.nb, self.wn = mlp.hs[0], mlp.hs[-1]
        self._tables: Dict[torch.device, tuple] = {}

    def _device_tables(self, device):
        t = self._tables.get(device)
        if t is None:
            p = self.plan
            ins, slices = device_tables(_POOL, device, p.ins, p.slices,
                                        p.idx, p.coef)

            def dt(a):
                a = a.reshape(-1)
                return torch.tensor(a if a.size else np.zeros(1, a.dtype),
                                    device=device)

            t = self._tables[device] = (
                ins, slices, dt(p.live_cols), dt(p.paths), dt(p.path_alpha),
                dt(p.col_path), dt(p.msg_path))
        return t

    def _args(self, device, rows: int, agg_d: int):
        act = self.mlp.act
        if act not in _ACT_CODE:
            raise ValueError(f'terms kernel: activation {act!r}')
        if len(self.mlp.hs) != 4 or self.mlp.hs[1] != _H \
                or self.mlp.hs[2] != _H:
            raise ValueError('terms kernel: two hidden layers of width 64')
        p = self.plan
        tables = self._device_tables(device)
        return ([ctypes.c_void_p(t.data_ptr()) for t in tables]
                + [p.ins.shape[0], p.slices.shape[0], p.live_cols.size,
                   p.paths.shape[0], rows, agg_d, self.d1, self.f, self.nb,
                   self.wn, p.d_msg, p.d_out, _ACT_CODE[act],
                   NORMALIZE2MOM_CST[act], 1.0 / math.sqrt(self.nb),
                   1.0 / math.sqrt(_H), 1.0 / math.sqrt(_H)])

    def forward(self, agg_d, xg, sh, emb, ms, w0, w1, w2, si2) -> Tensor:
        """Launch ``fused_conv_terms_fwd``; inputs checked by the caller.
        ``si2``: the path weights flat, back to back."""
        rows = xg.shape[0]
        out = torch.empty((rows // max(agg_d, 1), self.plan.d_out),
                          dtype=xg.dtype, device=xg.device)
        P = _ptr
        with torch.cuda.device(xg.device):
            err = _lib().fused_conv_terms_fwd(
                P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w2), P(si2),
                *self._args(xg.device, rows, agg_d), P(out), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_fwd')
        launch_counts['fused_conv_terms_fwd'] += 1
        return out

    def backward(self, agg_d, g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t,
                 si2t):
        """Launch ``fused_conv_terms_bwd``; returns (dxg, dsh, demb), every
        row written. ``si2t``: the transposed path weights flat."""
        dxg, dsh, demb = (torch.empty_like(t) for t in (xg, sh, emb))
        P = _ptr
        with torch.cuda.device(xg.device):
            err = _lib().fused_conv_terms_bwd(
                P(g), P(xg), P(sh), P(emb), P(ms), P(w0), P(w1), P(w1t),
                P(w2), P(w2t), P(si2t),
                *self._args(xg.device, xg.shape[0], agg_d),
                P(dxg), P(dsh), P(demb), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_bwd')
        launch_counts['fused_conv_terms_bwd'] += 1
        return dxg, dsh, demb


def _ptr(t: Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
