"""Sparse CG against one dense CG product, for one i1 class of the 7net-0
mid-layer uvu tensor product, on the card.

    python -m sevennet_exp_tpu_torch.tools.bench_cgmxu [i1] [E] [B]

Counterpart of ``tools/bench_cgmxu.py`` (i1 in {1, 2}, default 1; E edges,
default 32768; B, default 256). For the instructions of the mid layer
(``sevennet_0_config(species=['Na', 'Cl'])``, third convolution) that read
x entry i1, three kernels of ``csrc/bench_cgmxu.cu`` produce the same
weighted message block in the feature-major layout of the JAX tool (rows
(k, p, u), columns are edges):

  st     the current formulation: per-instruction CT tables (St = CT^T sh),
         per-p products with x and sums over m, x the radial weight; a
         kernel per class (``ST_CLASSES``: its instructions at compile
         time), launched as ``st_plan`` says
  outer  Z = x (x) sh, (d1 f, mul E), built in registers; ONE dense CG
         product C (d3tot, d1 f) @ Z; x the radial weight; a kernel per
         class (``OUTER_SHAPES``, the classes of ``DOTS_SHAPES``), launched
         as ``outer_plan`` says
  dots   the product alone (Z at no build cost), with the JAX write pattern;
         a kernel per class (``DOTS_SHAPES``: i1 = 0, 1, 2), launched as
         ``dots_plan`` says

Prints each one's ms and ns per edge row (CUDA events), then
max|kernel - oracle| of st and outer on the first B edges against the
tool's numpy oracle. The plan is the port's ``ops/fused_conv._tp_plan``;
the inputs come from a seeded ``torch.Generator`` on the card (the JAX PRNG
stream cannot be reproduced). Needs a card: without one the tool exits
nonzero. On CPU tensors the wrappers run the plain versions (tests).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from ..ops import cuda_build
from .bench_pieces import mid_layer_conv
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

MODES = ('st', 'outer', 'dots')
COUNTER = {m: f'bench_cgmxu_{m}' for m in MODES}
# the classes (d1 f, d3tot) the dots kernel is compiled for: i1 = 0, 1, 2
DOTS_SHAPES = ((9, 9), (27, 20), (45, 22))
# the same classes as (d1, f, d3tot): those the outer kernel is compiled for
OUTER_SHAPES = ((1, 9, 9), (3, 9, 20), (5, 9, 22))
# the classes (d1, f, d3tot) the st kernel is compiled for, each with its
# instructions (sh offset, d2, d3) in plan order: csrc/bench_cgmxu.cu's
# ST_CLASS_* lists, which also carry each instruction's first row and table
# offset (``CgClass.st_tables``)
ST_CLASSES = {
    (1, 9, 9): ((0, 1, 1), (1, 3, 3), (4, 5, 5)),
    (3, 9, 20): ((1, 3, 1), (0, 1, 3), (1, 3, 3), (4, 5, 3), (1, 3, 5),
                 (4, 5, 5)),
    (5, 9, 22): ((4, 5, 1), (1, 3, 3), (4, 5, 3), (0, 1, 5), (1, 3, 5),
                 (4, 5, 5)),
}
# dots, outer and st: threads a block, edges a thread (one float4), edges a
# block
DOTS_THREADS, DOTS_EDGES, DOTS_BLOCK_EDGES = 256, 4, 128


@dataclass
class CgClass:
    """One i1 class of the mid layer: its instructions (the port's
    ``_tp_plan`` entries) and the tables of the three formulations."""
    i1: int
    instrs: List[dict]
    mul: int
    d1: int
    f: int
    d3s: List[int]
    C: np.ndarray            # (d3tot, d1 f): the dense CG operator
    cts: List[np.ndarray]    # per instruction (d2, d3 mul d1): the JAX CT
    _dev: Dict = field(default_factory=dict, repr=False)

    @property
    def d3tot(self) -> int:
        return sum(self.d3s)

    @property
    def wide(self) -> int:
        return self.d3tot * self.mul

    def row_ins(self) -> np.ndarray:
        """The instruction of each (instruction, component) row r."""
        return np.repeat(np.arange(len(self.instrs)), self.d3s).astype(
            np.int32)

    def st_tables(self):
        """(records, table): per instruction [sh_off, d2, d3, first row,
        table offset] and its CT without the copy per channel,
        T[n][p][m] = CT[n, p * W + m * mul] (W = mul d1)."""
        recs, tabs, off, row = [], [], 0, 0
        W = self.mul * self.d1
        for p_ins, ct in zip(self.instrs, self.cts):
            d2, d3 = p_ins['dim2'], p_ins['dim3']
            t = ct.reshape(d2, d3, self.d1, self.mul)[..., 0]
            assert t.shape == (d2, d3, self.d1) and ct.shape[1] == d3 * W
            recs.append([p_ins['sh_off'], d2, d3, row, off])
            tabs.append(t.reshape(-1))
            off += t.size
            row += d3
        return (np.asarray(recs, np.int32).reshape(-1),
                np.concatenate(tabs).astype(np.float32))

    def host_records(self) -> np.ndarray:
        """The st records in host memory, made once (the st C entry checks
        them against its compiled class)."""
        got = self._dev.get('host')
        if got is None:
            got = self._dev['host'] = self.st_tables()[0]
        return got

    def device_tables(self, device):
        """(st records, st table, row_ins, C) on ``device``, made once."""
        got = self._dev.get(device)
        if got is None:
            recs, tab = self.st_tables()
            got = self._dev[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (recs, tab, self.row_ins(), self.C))
        return got


def cg_class(i1: int, conv=None) -> CgClass:
    """The i1 class and its tables, built as ``bench_cgmxu.py:50-93``."""
    conv = mid_layer_conv() if conv is None else conv
    x_off = conv.tp.irreps_in1.slices()[i1].start
    instrs = [p for p in conv.plan if p['x_off'] == x_off]
    mul, d1, f = instrs[0]['mul'], instrs[0]['dim1'], conv.f
    d3s = [p['dim3'] for p in instrs]
    C = np.zeros((sum(d3s), d1 * f), np.float32)
    r = 0
    for p_ins in instrs:
        so = p_ins['sh_off']
        for (m, n, p, c) in p_ins['nz']:
            C[r + p, m * f + so + n] = c
        r += p_ins['dim3']
    cts = []
    W = mul * d1
    for p_ins in instrs:
        ct = np.zeros((p_ins['dim2'], p_ins['dim3'] * W), np.float32)
        for (m, n, p, c) in p_ins['nz']:
            ct[n, p * W + m * mul:p * W + (m + 1) * mul] = c
        cts.append(ct)
    return CgClass(i1, instrs, mul, d1, f, d3s, C, cts)


def make_inputs(cls: CgClass, E: int, device, seed: int = 0):
    """(xT, shT, wT) standard normal from one seeded generator."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device)
                 for shape in ((cls.d1 * cls.mul, E), (cls.f, E),
                               (len(cls.instrs) * cls.mul, E)))


# ---------------------------------------------------------------------
# plain versions and the oracle
# ---------------------------------------------------------------------

def outer_z(cls: CgClass, xT, shT) -> Tensor:
    """Z[(m, n), (u, b)] = x[(m, u), b] sh[n, b], (d1 f, mul E)."""
    E = xT.shape[1]
    return (xT.reshape(cls.d1, 1, cls.mul, E)
            * shT.reshape(1, cls.f, 1, E)).reshape(cls.d1 * cls.f,
                                                   cls.mul * E)


def plain(cls: CgClass, mode: str, xT, shT, wT) -> Tensor:
    """The function each kernel computes, in plain PyTorch, formulated as
    the JAX tool's kernel of the same name."""
    E = xT.shape[1]
    mul, d1 = cls.mul, cls.d1
    if mode == 'st':
        W = mul * d1
        rows = []
        for ki, (p_ins, ct) in enumerate(zip(cls.instrs, cls.cts)):
            so, d2 = p_ins['sh_off'], p_ins['dim2']
            StT = torch.as_tensor(ct, device=xT.device).t() @ shT[so:so + d2]
            wn = wT[ki * mul:(ki + 1) * mul]
            for p in range(p_ins['dim3']):
                prod = xT * StT[p * W:(p + 1) * W]
                acc = prod[0:mul]
                for m in range(1, d1):
                    acc = acc + prod[m * mul:(m + 1) * mul]
                rows.append(acc * wn)
        return torch.cat(rows, dim=0)
    C = torch.as_tensor(cls.C, device=xT.device)
    if mode == 'outer':
        out0 = (C @ outer_z(cls, xT, shT)).reshape(cls.d3tot, mul, E)
        ri = torch.as_tensor(cls.row_ins(), device=xT.device).long()
        w = wT.reshape(len(cls.instrs), mul, E)[ri]
        return (out0 * w).reshape(cls.wide, E)
    if mode == 'dots':
        Z = xT[0].repeat(mul).expand(d1 * cls.f, -1)
        out0 = C @ Z
        out = xT.new_zeros(cls.wide, E)
        out[:cls.d3tot] = out0[:, :E] + out0[:, (mul - 1) * E:]
        return out
    raise ValueError(mode)


def gathered_weight(cls: CgClass, wT) -> Tensor:
    """The radial weight of each (instruction, component) row, (d3tot,
    mul, E): ``wT``'s rows gathered by ``row_ins`` (outside any timed
    window)."""
    ri = torch.as_tensor(cls.row_ins(), device=wT.device).long()
    return wT.reshape(len(cls.instrs), cls.mul, -1)[ri]


def library(cls: CgClass, xT, shT, wg) -> Tensor:
    """The block st and outer compute, as ONE ``torch.einsum`` of the dense
    CG table C (d3tot, d1, f), x, sh and the gathered weight ``wg``
    (``gathered_weight``)."""
    E = xT.shape[1]
    C = cls.device_tables(xT.device)[3].view(cls.d3tot, cls.d1, cls.f)
    return torch.einsum('rmn,mub,nb,rub->rub', C,
                        xT.view(cls.d1, cls.mul, E), shT,
                        wg).reshape(cls.wide, E)


def oracle(cls: CgClass, xT, shT, wT, B: int) -> np.ndarray:
    """The JAX tool's numpy oracle (``bench_cgmxu.py:210-227``) on the
    first B edges."""
    mul = cls.mul
    xTn = np.asarray(xT[:, :B].cpu())
    shn = np.asarray(shT[:, :B].cpu())
    wn_ = np.asarray(wT[:, :B].cpu())
    ref = np.zeros((cls.wide, B), np.float32)
    row = 0
    for ki, p_ins in enumerate(cls.instrs):
        so = p_ins['sh_off']
        for (m, n, p, c) in p_ins['nz']:
            ref[(row + p) * mul:(row + p + 1) * mul, :] += (
                c * xTn[m * mul:(m + 1) * mul, :]
                * shn[so + n:so + n + 1, :])
        for p in range(p_ins['dim3']):
            ref[(row + p) * mul:(row + p + 1) * mul, :] *= (
                wn_[ki * mul:(ki + 1) * mul, :])
        row += p_ins['dim3']
    return ref


# ---------------------------------------------------------------------
# the dots and outer kernels' launch plans
# ---------------------------------------------------------------------

def _check_edges(cls: CgClass, E: int, mode: str):
    if E < 1 or E % 32 or cls.mul % 8 or cls.d3tot > cls.mul:
        raise ValueError(f'bench_cgmxu {mode} takes E % 32 == 0, mul % 8 == 0 '
                         'and d3tot <= mul')


def dots_plan(cls: CgClass, E: int) -> Dict:
    """The dots kernel's launch: a template instance per class (K = d1 f,
    d3tot), 256 threads a block, each 4 consecutive edges of one channel,
    8 channels a block; grid (ceil(E / 128), mul / 8). Raises on a class
    the kernel is not compiled for and on E % 32 or mul % 8."""
    K = cls.d1 * cls.f
    if (K, cls.d3tot) not in DOTS_SHAPES:
        raise ValueError(f'bench_cgmxu dots: no kernel for the class (K, '
                         f'd3tot) = ({K}, {cls.d3tot}); compiled for '
                         f'{DOTS_SHAPES}')
    _check_edges(cls, E, 'dots')
    warps = DOTS_THREADS // 32
    return {'K': K, 'd3tot': cls.d3tot, 'threads': DOTS_THREADS,
            'edges_per_thread': DOTS_EDGES,
            'grid': (-(-E // DOTS_BLOCK_EDGES), cls.mul // warps),
            'channels_per_block': warps}


def outer_plan(cls: CgClass, E: int) -> Dict:
    """The outer kernel's launch: a template instance per class (d1, f,
    d3tot), the dots kernel's threads and grid (4 consecutive edges of one
    channel a thread, u = 8 blockIdx.y + warp). Raises on a class the kernel
    is not compiled for and on E % 32 or mul % 8."""
    if (cls.d1, cls.f, cls.d3tot) not in OUTER_SHAPES:
        raise ValueError(f'bench_cgmxu outer: no kernel for the class (d1, '
                         f'f, d3tot) = ({cls.d1}, {cls.f}, {cls.d3tot}); '
                         f'compiled for {OUTER_SHAPES}')
    _check_edges(cls, E, 'outer')
    warps = DOTS_THREADS // 32
    return {'K': cls.d1 * cls.f, 'd1': cls.d1, 'f': cls.f,
            'd3tot': cls.d3tot, 'threads': DOTS_THREADS,
            'edges_per_thread': DOTS_EDGES,
            'grid': (-(-E // DOTS_BLOCK_EDGES), cls.mul // warps),
            'channels_per_block': warps}


def st_plan(cls: CgClass, E: int) -> Dict:
    """The st kernel's launch: a template instance per class (d1, f,
    d3tot) whose instructions (``ST_CLASSES``) are compiled in, the dots
    kernel's threads and grid (4 consecutive edges of one channel a thread,
    u = 8 blockIdx.y + warp). Raises on a class or an instruction list the
    kernel is not compiled for and on E % 32 or mul % 8."""
    key = (cls.d1, cls.f, cls.d3tot)
    ins = tuple((p['sh_off'], p['dim2'], p['dim3']) for p in cls.instrs)
    if ST_CLASSES.get(key) != ins:
        raise ValueError(f'bench_cgmxu st: no kernel for the class (d1, f, '
                         f'd3tot) = {key} with instructions {ins}; compiled '
                         f'for {sorted(ST_CLASSES)}')
    _check_edges(cls, E, 'st')
    warps = DOTS_THREADS // 32
    return {'K': cls.d1 * cls.f, 'd1': cls.d1, 'f': cls.f,
            'd3tot': cls.d3tot, 'instructions': ins,
            'threads': DOTS_THREADS, 'edges_per_thread': DOTS_EDGES,
            'grid': (-(-E // DOTS_BLOCK_EDGES), cls.mul // warps),
            'channels_per_block': warps}


def _columns(E: int, plan: Dict, u_of) -> np.ndarray:
    """(u, b) of every live (block, thread, edge) of a dots-layout launch,
    u = u_of(blockIdx.y, warp)."""
    gx, gy = plan['grid']
    bx, by, tid, c = np.meshgrid(np.arange(gx), np.arange(gy),
                                 np.arange(DOTS_THREADS),
                                 np.arange(DOTS_EDGES), indexing='ij')
    lane, slot = tid % 32, tid // 32
    b = bx * DOTS_BLOCK_EDGES + DOTS_EDGES * lane
    u = u_of(by, slot)
    live = b < E            # a thread's four edges are all in or all out
    return np.stack([u[live], (b + c)[live]], axis=1)


def dots_columns(cls: CgClass, E: int) -> np.ndarray:
    """The (u, b) columns each dots thread owns, as the kernel indexes
    them: (n, 2) for every live (block, thread, edge); the first slots of a
    block take u = 4 blockIdx.y + slot, the others mul - 1 - that."""
    plan = dots_plan(cls, E)
    half = plan['channels_per_block'] // 2
    return _columns(E, plan, lambda by, slot: np.where(
        slot < half, half * by + slot, cls.mul - 1 - (half * by + slot - half)))


def outer_columns(cls: CgClass, E: int) -> np.ndarray:
    """The (u, b) columns each outer thread owns, as the kernel indexes
    them: u = 8 blockIdx.y + slot."""
    plan = outer_plan(cls, E)
    return _columns(E, plan, lambda by, slot:
                    plan['channels_per_block'] * by + slot)


def st_columns(cls: CgClass, E: int) -> np.ndarray:
    """The (u, b) columns each st thread owns, as the kernel indexes them:
    u = 8 blockIdx.y + slot, as outer."""
    plan = st_plan(cls, E)
    return _columns(E, plan, lambda by, slot:
                    plan['channels_per_block'] * by + slot)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_CLS = [_I] * 5 + [_L]       # mul, d1, f, n_ins, d3tot, E


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_cgmxu')
    lib.cgmxu_st.argtypes = [_P] * 5 + [_I] + _CLS + [_P, _P]
    lib.cgmxu_outer.argtypes = [_P] * 5 + _CLS + [_P, _P]
    lib.cgmxu_dots.argtypes = [_P] * 2 + _CLS + [_P, _P]
    for fn in (lib.cgmxu_st, lib.cgmxu_outer, lib.cgmxu_dots):
        fn.restype = _I
    return lib


def kernel(cls: CgClass, mode: str, xT, shT, wT) -> Tensor:
    """Launch the mode's kernel of csrc/bench_cgmxu.cu (CUDA tensors
    only)."""
    E = xT.shape[1]
    shapes = ((cls.d1 * cls.mul, E), (cls.f, E),
              (len(cls.instrs) * cls.mul, E))
    for name, t, shape in zip(('xT', 'shT', 'wT'), (xT, shT, wT), shapes):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != xT.device:
            raise ValueError(f'{name}: want contiguous float32 {shape} on '
                             f'one device, got {tuple(t.shape)} {t.dtype}')
    if E % 32 or cls.mul % 8:
        raise ValueError('bench_cgmxu kernels take E % 32 == 0, mul % 8 == 0')
    recs, tab, row_ins, C = cls.device_tables(xT.device)
    out = torch.empty((cls.wide, E), dtype=xT.dtype, device=xT.device)
    P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    dims = (cls.mul, cls.d1, cls.f, len(cls.instrs), cls.d3tot, E)
    stream = ctypes.c_void_p(torch.cuda.current_stream(xT.device).cuda_stream)
    lib = _lib()
    if mode == 'st':
        st_plan(cls, E)
        err = lib.cgmxu_st(P(xT), P(shT), P(wT),
                           cls.host_records().ctypes.data_as(_P), P(tab),
                           tab.numel(),
                           *dims, P(out), stream)
    elif mode == 'outer':
        outer_plan(cls, E)
        err = lib.cgmxu_outer(P(xT), P(shT), P(wT), P(row_ins), P(C), *dims,
                              P(out), stream)
    elif mode == 'dots':
        dots_plan(cls, E)
        err = lib.cgmxu_dots(P(xT), P(C), *dims, P(out), stream)
    else:
        raise ValueError(mode)
    cuda_build.check(err, COUNTER[mode])
    cuda_build.launch_counts[COUNTER[mode]] += 1
    return out


def forward(cls: CgClass, mode: str, xT, shT, wT) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = xT.device.type
    if dev == 'cuda':
        return kernel(cls, mode, xT, shT, wT)
    if dev == 'cpu':
        return plain(cls, mode, xT, shT, wT)
    raise ValueError(f'bench_cgmxu: no kernel for device {dev}')


def cost(cls: CgClass, mode: str, E: int):
    """(flops, bytes) of the function the mode computes, each input read
    and the output written once. st and outer compute the weighted CG
    block: a multiply, a multiply and an add per nonzero term and channel,
    and the weight; dots computes the dense product C @ Z."""
    mul, d1, f = cls.mul, cls.d1, cls.f
    if mode == 'dots':
        return E * 2.0 * cls.d3tot * d1 * f * mul, 4.0 * E * (1 + cls.wide)
    n_nz = sum(len(p['nz']) for p in cls.instrs)
    reads = d1 * mul + f + len(cls.instrs) * mul
    return E * (3.0 * n_nz * mul + cls.wide), 4.0 * E * (reads + cls.wide)


def formulation_flops(cls: CgClass, mode: str, E: int) -> float:
    """The arithmetic each formulation does (st: its S tables per channel,
    the products and sums, the weight; outer: Z, the dense product, the
    weight; dots: the dense product); printed beside the bound, not part
    of it."""
    mul, d1, f = cls.mul, cls.d1, cls.f
    dense = 2.0 * cls.d3tot * d1 * f * mul
    if mode == 'st':
        return E * (sum(2.0 * p['dim3'] * d1 * (p['dim2'] + 1) * mul
                        for p in cls.instrs) + cls.wide)
    if mode == 'outer':
        return E * (d1 * f * mul + dense + cls.wide)
    return E * dense


def run(i1: int = 1, E: int = 32768, B: int = 256, reps: int = 20) -> Dict:
    """The three kernels once (outputs kept), then timed; prints as the JAX
    tool does, with the oracle's errors. Returns {'cls', 'inputs', 'out',
    'ms', 'oracle_err'}."""
    if E % B:
        raise ValueError(f'E = {E} is not a multiple of B = {B}')
    cls = cg_class(i1)
    print(f'i1={i1}: d1={cls.d1} mul={cls.mul} f={cls.f} '
          f'instrs={len(cls.instrs)} d3s={cls.d3s} wide={cls.wide} E={E} '
          f'B={B}', flush=True)
    inputs = make_inputs(cls, E, 'cuda')
    res = {'cls': cls, 'inputs': inputs, 'out': {}, 'ms': {},
           'oracle_err': {}}
    for mode in MODES:
        res['out'][mode] = forward(cls, mode, *inputs)
        ms = cuda_ms(lambda: forward(cls, mode, *inputs), reps=reps)
        res['ms'][mode] = ms
        print(f'{mode:6s}: {ms:8.3f} ms  {ms / E * 1e6:7.2f} ns/row   '
              f'(CUDA events)', flush=True)
    ref = oracle(cls, *inputs, B)
    for mode in ('st', 'outer'):
        err = float(np.abs(res['out'][mode][:, :B].cpu().numpy() - ref).max())
        res['oracle_err'][mode] = err
        print(f'max|{mode}-oracle| = {err:.3e}  '
              f'(max|oracle| = {np.abs(ref).max():.3e})', flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('bench_cgmxu'):
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    i1 = int(argv[0]) if len(argv) > 0 else 1
    E = int(argv[1]) if len(argv) > 1 else 32768
    B = int(argv[2]) if len(argv) > 2 else 256
    run(i1, E, B)
    return 0


if __name__ == '__main__':
    sys.exit(main())
