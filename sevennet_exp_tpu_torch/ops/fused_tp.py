"""Bare uvu tensor product per edge row: CUDA kernels, their plain PyTorch
version and the autograd wrapper.

Counterpart of ``sevennet_exp_tpu/ops/pallas_tp.py::make_fused_tp`` (the
kernels ``_fwd_kernel`` and ``_bwd_kernel``):

    msg[e] = uvu-TP(xg[e], sh[e]; w[e])

with the per-row weights ``w`` given: no radial MLP, no aggregation, no
self-interaction. The backward returns ``(dxg, dsh, dw)``. As in the JAX
package the op has no caller in the model (there it is the analog of the
reference's cuEquivariance backend); the convolutions go through
``ops/fused_conv``.

On CUDA tensors the wrapper launches the kernels of ``csrc/fused_tp.cu``
(built with nvcc at first use into ``_build/``); on CPU tensors it runs the
plain version, ``UVUTensorProductSpec.apply`` and its autograd VJP. Any
other device raises. The backward kernel compiles its CG terms in per
(l1, l2, l3) with l <= 3 and holds the sh components in registers, one
slot l2^2 + n each: it takes the specs whose sh entries are single and of
distinct l (``bwd_tables``), copying runs of 4 channels where the
multiplicities and pointers allow and single channels elsewhere. Any other
spec runs the table-driven backward of the same source, which walks the
forward's instruction records and n-sorted terms (``bwd_route``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from . import cuda_build
from .cuda_build import launch_counts
from .tensor_product import UVUTensorProductSpec

Tensor = torch.Tensor

_I_STRIDE = 10    # ints per instruction record (see csrc/fused_tp.cu)
# the backward's step record (csrc/fused_tp.cu: S_XOFF .. S_FLAGS)
S_FIELDS = ('x_off', 'mul', 'u0', 'd1', 'key', 'w_off', 'out_off', 'scale',
            'flags')
F_FIRST, F_LAST = 1, 2    # the first / last step of an x item
STEP_CHANNELS = 64        # channels a step: two a lane
NO_INS = -1               # the key of an x entry no instruction reads
_NSH = (1, 4, 9, 16)      # the backward's instances by sh components held
LMAX_BWD = 3              # and by largest l (csrc/cg_patterns.cuh's)


def _plan(spec: UVUTensorProductSpec):
    """Static contraction plan: per instruction x_off, mul, sh_off, w_off,
    out_off, dim1, dim2, dim3 and the nonzero CG terms (m, n, p, c). Every
    instruction owns ``mul`` weight columns and writes the output entry at
    ``out_off`` in the layout ``spec.apply`` returns."""
    s1 = spec.irreps_in1.slices()
    s2 = spec.irreps_in2.slices()
    out_offsets = []
    off = 0
    for mul, ir in spec.irreps_out:
        out_offsets.append(off)
        off += mul * ir.dim
    d3_total = off
    plan = []
    w_off = 0
    for (_, nz), (i1, i2, k) in zip(spec.cg_nonzeros(), spec.instructions):
        mul1, ir1 = spec.irreps_in1[i1]
        _, ir2 = spec.irreps_in2[i2]
        _, ir3 = spec.irreps_out[k]
        plan.append(dict(
            k=k, x_off=s1[i1].start, mul=mul1, sh_off=s2[i2].start,
            w_off=w_off, out_off=out_offsets[k],
            dim1=ir1.dim, dim2=ir2.dim, dim3=ir3.dim, nz=nz,
        ))
        w_off += mul1
    ks = [p['k'] for p in plan]
    if len(set(ks)) != len(ks):
        raise ValueError('uvu plan: two instructions write one output entry')
    return plan, d3_total, w_off


def pack_plan(plan: Sequence[dict]):
    """Kernel tables of a list of plan entries: instruction records, the warp
    slices (instruction, first channel: 32 channels each), and the terms
    (m | n << 8 | p << 16, coefficient) -- per instruction once sorted by p
    (the forward's order) and once by n (the backward's). Term offsets are
    relative to the start of the plan's terms."""
    ins, slices, idx, coef = [], [], [], []
    for a, p in enumerate(plan):
        if max(p['dim1'], p['dim2'], p['dim3']) > 255:
            raise ValueError('irrep dimension > 255')
        ranges = []
        for key in (2, 1):
            ranges.append(len(idx))
            for (m, n, pc, c) in sorted(p['nz'], key=lambda t: t[key]):
                idx.append(m | (n << 8) | (pc << 16))
                coef.append(c)
            ranges.append(len(idx))
        ins.append([p['x_off'], p['mul'], p['sh_off'], p['w_off'],
                    p['out_off'], p['dim3'], *ranges])
        slices.extend([a, u0] for u0 in range(0, p['mul'], 32))
    return (np.asarray(ins, np.int32).reshape(-1, _I_STRIDE),
            np.asarray(slices, np.int32).reshape(-1, 2),
            np.asarray(idx, np.int32), np.asarray(coef, np.float32))


def pattern_scale(p: dict) -> float:
    """The one factor s with ``p['nz'] = s CgPattern<l1, l2, l3>`` (the
    instruction's path normalisation; the pattern is
    ``tools/cg_patterns.pattern``, which csrc/cg_patterns.cuh is generated
    from); raises if the terms do not factor so."""
    from ..tools.cg_patterns import pattern   # its source, csrc's terms
    ls = tuple((p[k] - 1) // 2 for k in ('dim1', 'dim2', 'dim3'))
    pat = {(m, n, q): c for m, n, q, c in pattern(*ls)}
    nz = {(m, n, q): c for m, n, q, c in p['nz']}
    if set(nz) != set(pat):
        raise ValueError(f'CG terms of {ls} are not its pattern\'s')
    first = min(pat, key=lambda t: (t[2], t[0], t[1]))
    scale = nz[first] / pat[first]
    if any(abs(c - scale * pat[t]) > 1e-6 * abs(c) for t, c in nz.items()):
        raise ValueError(f'CG terms of {ls} are not one scale times its '
                         'pattern')
    return scale


def bwd_tables(spec: UVUTensorProductSpec):
    """The backward kernel's tables: (steps, slots, nsh, lm, run).
    ``steps`` is one row's (S, 9) int32 step records (fields ``S_FIELDS``)
    in the order a warp runs them: by x entry, then block of
    ``STEP_CHANNELS`` channels, then the instructions that read the entry
    (key l1 16 + l2 4 + l3, the weight and output offsets, the float32 bits
    of ``pattern_scale``); an x entry no instruction reads is one step of
    key ``NO_INS`` per block. ``flags`` marks an x item's first and last
    step. ``slots`` gives each sh column its register slot l2^2 + n,
    ``nsh`` is the instance's slot count (the least of 1, 4, 9, 16 above
    every slot), ``lm`` its largest l of an x or output entry, ``run`` the
    channels a copy (4 where every x multiplicity is a multiple of 4, else
    1). Raises ValueError for a spec the kernel does not take: an l above
    3, an sh entry of multiplicity above 1 or two of one l."""
    plan, _, _ = _plan(spec)
    ls = [ir.l for _, ir in spec.irreps_in2]
    if any(mul != 1 for mul, _ in spec.irreps_in2) or \
            len(set(ls)) != len(ls):
        raise ValueError('fused_tp backward: the sh entries must be 1x '
                         'each, of distinct l')
    lm = max([ir.l for _, ir in spec.irreps_in1]
             + [(p['dim3'] - 1) // 2 for p in plan])
    if max(lm, *ls) > LMAX_BWD:
        raise ValueError(f'fused_tp backward: l {max(lm, *ls)} > '
                         f'{LMAX_BWD}')
    slots = [ir.l ** 2 + n for _, ir in spec.irreps_in2
             for n in range(ir.dim)]
    nsh = next(n for n in _NSH if n > max(slots))
    run = 1 if any(mul % 4 for mul, _ in spec.irreps_in1) else 4
    steps = []
    for (mul, ir), sl in zip(spec.irreps_in1, spec.irreps_in1.slices()):
        users = [p for p in plan if p['x_off'] == sl.start]
        for u0 in range(0, mul, STEP_CHANNELS):
            item = [[sl.start, mul, u0, ir.dim,
                     ((p['dim1'] - 1) // 2) * 16 + ((p['dim2'] - 1) // 2) * 4
                     + (p['dim3'] - 1) // 2, p['w_off'], p['out_off'],
                     int(np.float32(pattern_scale(p)).view(np.int32)), 0]
                    for p in users] or \
                [[sl.start, mul, u0, ir.dim, NO_INS, 0, 0, 0, 0]]
            item[0][-1] |= F_FIRST
            item[-1][-1] |= F_LAST
            steps += item
    return (np.asarray(steps, np.int32).reshape(-1, len(S_FIELDS)),
            np.asarray(slots, np.int32), nsh, lm, run)


def bwd_route(spec: UVUTensorProductSpec) -> str:
    """'steps' where the step kernel takes SPEC (``bwd_tables``), else
    'table': the table-driven backward."""
    try:
        bwd_tables(spec)
    except ValueError:
        return 'table'
    return 'steps'


class TermPool:
    """Allocator of one library's ``__constant__`` term pool: each distinct
    term list is uploaded once per device and keeps its offset."""

    def __init__(self, lib_name: str, prefix: str):
        self.lib_name, self.prefix = lib_name, prefix
        self._placed: Dict[tuple, int] = {}
        self._used: Dict[int, int] = {}

    def place(self, device: torch.device, idx: np.ndarray,
              coef: np.ndarray) -> int:
        dev = device.index if device.index is not None \
            else torch.cuda.current_device()
        key = (dev, idx.tobytes(), coef.tobytes())
        off = self._placed.get(key)
        if off is None:
            lib = cuda_build.load(self.lib_name)
            upload = getattr(lib, f'{self.prefix}_upload')
            upload.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_void_p]
            upload.restype = ctypes.c_int
            off = self._used.get(dev, 0)
            size = getattr(lib, f'{self.prefix}_pool_size')()
            if off + idx.size > size:
                raise RuntimeError(
                    f'{self.prefix}: the constant pool of {size} CG terms '
                    'is full')
            idx = np.ascontiguousarray(idx, np.int32)
            coef = np.ascontiguousarray(coef, np.float32)
            with torch.cuda.device(dev):
                cuda_build.check(
                    upload(off, idx.size, idx.ctypes.data, coef.ctypes.data),
                    f'{self.prefix}_upload')
            self._used[dev] = off + idx.size
            self._placed[key] = off
        return off


def device_tables(pool: TermPool, device, ins: np.ndarray,
                  slices: np.ndarray, idx: np.ndarray, coef: np.ndarray):
    """Upload a packed plan: its terms into the pool, its instruction records
    (term offsets made absolute) and slices as device tensors."""
    base = pool.place(device, idx, coef)
    ins = ins.copy()
    ins[:, 6:10] += base
    return (torch.tensor(ins.reshape(-1), device=device),
            torch.tensor(slices.reshape(-1), device=device))


_POOL = TermPool('fused_tp', 'fused_tp')
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('fused_tp')
    dims = [_P, _P, _I, _I, _L, _I, _I, _I, _I]
    lib.fused_tp_fwd.argtypes = [_P] * 3 + dims + [_P, _P]
    lib.fused_tp_fwd.restype = _I
    lib.fused_tp_bwd.argtypes = [_P] * 4 + [_P, _P, _I, _I, _I, _I, _L, _I,
                                            _I, _I, _I] + [_P] * 4
    lib.fused_tp_bwd.restype = _I
    lib.fused_tp_bwd_table.argtypes = [_P] * 4 + dims + [_P] * 4
    lib.fused_tp_bwd_table.restype = _I
    return lib


def _ptr(t: Tensor):
    return ctypes.c_void_p(t.data_ptr())


class FusedTP:
    """fused_tp(xg, sh, w) -> (E, d3) messages with autograd; the counterpart
    of the function ``make_fused_tp(spec)`` returns. Shapes: xg (E, d1),
    sh (E, f), w (E, w_numel), any E."""

    def __init__(self, spec: UVUTensorProductSpec):
        self.spec = spec
        self.plan, self.d3, self.w_numel = _plan(spec)
        self.d1 = spec.irreps_in1.dim
        self.f = spec.irreps_in2.dim
        self._tables: Dict[torch.device, tuple] = {}
        self._bwd: Dict[torch.device, tuple] = {}
        self.bwd_route = bwd_route(spec)

    # -- plain version ------------------------------------------------
    def plain_forward(self, xg, sh, w) -> Tensor:
        return self.spec.apply(xg, sh, w)

    def plain_backward(self, g, xg, sh, w):
        """(dxg, dsh, dw): the VJP of ``plain_forward`` by autograd."""
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (xg, sh, w)]
            return torch.autograd.grad(self.plain_forward(*ins), ins, g)

    # -- kernels ------------------------------------------------------
    def kernel_tables(self, device):
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = device_tables(
                _POOL, device, *pack_plan(self.plan))
        return t

    def bwd_kernel_tables(self, device):
        """(steps on the device, slots on the device, n_steps, nsh, lm,
        run) of ``bwd_tables`` (the 'steps' route only)."""
        t = self._bwd.get(device)
        if t is None:
            steps, slots, nsh, lm, run = bwd_tables(self.spec)
            t = self._bwd[device] = (
                torch.tensor(steps.reshape(-1), device=device),
                torch.tensor(slots, device=device), steps.shape[0], nsh, lm,
                run)
        return t

    def _check(self, xg, sh, w, g=None):
        rows = xg.shape[0]
        named = {'xg': (xg, self.d1), 'sh': (sh, self.f),
                 'w': (w, self.w_numel)}
        if g is not None:
            named['g'] = (g, self.d3)
        for name, (t, width) in named.items():
            if tuple(t.shape) != (rows, width):
                raise ValueError(f'{name}: shape {tuple(t.shape)} != '
                                 f'{(rows, width)}')
            if t.device != xg.device or t.dtype != torch.float32:
                raise ValueError('fused_tp kernel takes float32 tensors on '
                                 'one CUDA device')
            if not t.is_contiguous():
                raise ValueError('fused_tp kernel takes contiguous tensors')

    def _dims(self, device, rows: int):
        ins, slices = self.kernel_tables(device)
        return [_ptr(ins), _ptr(slices), len(self.plan), slices.numel() // 2,
                rows, self.d1, self.f, self.w_numel, self.d3]

    def kernel_forward(self, xg, sh, w) -> Tensor:
        """Launch ``fused_tp_fwd`` (CUDA tensors only)."""
        self._check(xg, sh, w)
        out = torch.empty((xg.shape[0], self.d3), dtype=xg.dtype,
                          device=xg.device)
        with torch.cuda.device(xg.device):
            err = _lib().fused_tp_fwd(
                _ptr(xg), _ptr(sh), _ptr(w),
                *self._dims(xg.device, xg.shape[0]), _ptr(out),
                ctypes.c_void_p(
                    torch.cuda.current_stream(xg.device).cuda_stream))
        cuda_build.check(err, 'fused_tp_fwd')
        launch_counts['fused_tp_fwd'] += 1
        return out

    def kernel_backward(self, g, xg, sh, w):
        """Launch the backward of ``bwd_route`` (CUDA tensors only):
        ``fused_tp_bwd`` or ``fused_tp_bwd_table``; returns (dxg, dsh, dw),
        every element written."""
        g = g.contiguous()
        self._check(xg, sh, w, g)
        dxg, dsh, dw = (torch.empty_like(t) for t in (xg, sh, w))
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(xg.device).cuda_stream)
        if self.bwd_route == 'steps':
            name = 'fused_tp_bwd'
            steps, slots, n_steps, nsh, lm, run = \
                self.bwd_kernel_tables(xg.device)
            tables = [_ptr(steps), _ptr(slots), n_steps, nsh, lm, run,
                      xg.shape[0], self.d1, self.f, self.w_numel, self.d3]
        else:
            name = 'fused_tp_bwd_table'
            tables = self._dims(xg.device, xg.shape[0])
        with torch.cuda.device(xg.device):
            err = getattr(_lib(), name)(
                _ptr(g), _ptr(xg), _ptr(sh), _ptr(w), *tables, _ptr(dxg),
                _ptr(dsh), _ptr(dw), stream)
        cuda_build.check(err, name)
        launch_counts[name] += 1
        return dxg, dsh, dw

    # -- dispatch -----------------------------------------------------
    @staticmethod
    def _by_device(t: Tensor, plain, kernel):
        if t.device.type == 'cpu':
            return plain
        if t.device.type == 'cuda':
            return kernel
        raise ValueError(f'fused_tp: no kernel for device {t.device}')

    def forward(self, xg, sh, w) -> Tensor:
        return self._by_device(xg, self.plain_forward,
                               self.kernel_forward)(xg, sh, w)

    def backward(self, g, xg, sh, w):
        return self._by_device(xg, self.plain_backward,
                               self.kernel_backward)(g, xg, sh, w)

    def __call__(self, xg, sh, w) -> Tensor:
        return _FusedTPFn.apply(self, xg, sh, w)


class _FusedTPFn(torch.autograd.Function):
    """Forward: the bare tensor product. Backward: (dxg, dsh, dw)."""

    @staticmethod
    def forward(ctx, op, xg, sh, w):
        ctx.op = op
        ctx.save_for_backward(xg, sh, w)
        return op.forward(xg, sh, w)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.op.backward(g, *ctx.saved_tensors))


@functools.lru_cache(maxsize=None)
def make_fused_tp(spec: UVUTensorProductSpec) -> FusedTP:
    """The fused tensor product of one spec (cached per spec)."""
    return FusedTP(spec)


def tp_cost(spec: UVUTensorProductSpec, rows: int) -> Tuple[float, float]:
    """(forward flops, backward flops) of ``rows`` rows; a multiply-add
    counts as 2. Forward: 1.5 multiply-adds per term and channel and the
    weight product; backward: dx, dw and dsh per term."""
    plan, d3, _ = _plan(spec)
    terms = sum(p['mul'] * len(p['nz']) for p in plan)
    return 2.0 * rows * (1.5 * terms + d3), 2.0 * rows * 4.5 * terms


def tp_bytes(spec: UVUTensorProductSpec, rows: int) -> Tuple[float, float]:
    """(forward bytes, backward bytes) ``rows`` rows must move: xg, sh and
    w read once and msg written once; the backward reads those and the
    cotangent and writes dxg, dsh and dw."""
    _, d3, wn = _plan(spec)
    ins = spec.irreps_in1.dim + spec.irreps_in2.dim + wn
    return 4.0 * rows * (ins + d3), 4.0 * rows * (2 * ins + d3)
