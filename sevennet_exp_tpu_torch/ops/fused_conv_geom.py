"""Launch shape and work mapping of the geometry-fused conv kernels
(``csrc/fused_conv_geom.cu``), in Python.

The kernels choose their tile, their row groups and their i1 classes on
the host side of the C entry (``geom_shape``) and inside the block; this
module holds the same arithmetic so that the CPU tests can check that every
live column and every x channel of every row is covered exactly once, and so
that a numpy replay can run the kernels' loop order. On the card
``kernel_shape`` asks the C entry ``fused_conv_geom_shape`` for the numbers
it launches with (``tests/test_torch_cuda.py`` holds the two equal).

    T     rows per tile: at most 16, D rounded up to 4 when that is fewer
    s     row groups per live column (1, 2 or 4; T / s rows each, a
          multiple of 4): the fewest rounds of the block's 256 threads, a w2
          column load counted as 4 rows, within two blocks per SM
    nap   live columns rounded up to 4 (row stride of the per-row w / dw)
    cq    pass D: live columns per quarter, a multiple of 4
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple

import numpy as np

from . import cuda_build

NT = 256          # threads per block
H = 64            # radial MLP hidden width
TF, TB = 16, 16   # rows per tile at most: forward, backward
SHP = 16          # sh row stride
SLAB = 16         # pass D: w2^T columns a thread holds
QD = NT // H      # pass D: column quarters
NW = NT // 32     # warps per block
MAX_XENT = 16
I_STRIDE = 34     # ints per instruction record (ops/fused_conv.py)
TWO_PER_SM = (233472 - 2 * 1024) // 2


class Shape(NamedTuple):
    T: int
    s: int
    nap: int
    cq: int
    smem: int     # dynamic shared bytes of one block


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _table_words(n_ins: int, n_nz: int) -> int:
    return (n_ins * I_STRIDE + 2 * n_nz + 3) & ~3


def tile_rows(D: int, tmax: int) -> int:
    return min(tmax, _r4(D))


def _words(dims: Dict[str, int], T: int, s: int, nap: int, bwd: bool) -> int:
    d = dims
    base = _table_words(d['n_ins'], d['n_nz']) + _r4(d['n_ins'])
    if not bwd:
        return (base + _r4(T * SHP) + _r4(T * d['nb'])
                + _r4(T * 3) + _r4(T) + 2 * _r4(T * H) + _r4(T * nap)
                + _r4(s * d['agg_dim']) + _r4(d['d_out']))
    return (base + _r4(MAX_XENT * 5) + _r4(d['d_out']) + _r4(d['agg_dim'])
            + _r4(TB * nap + SLAB) + 4 * _r4(T * H) + _r4(QD * T * H)
            + _r4(NW * T * SHP) + 2 * _r4(T * SHP) + _r4(T * d['nb'])
            + _r4(T * 3) + _r4(T))


def shape(dims: Dict[str, int], bwd: bool) -> Shape:
    """The launch shape of one layer: ``dims`` holds D, d1, nb, d_out,
    n_ins, n_active, agg_dim, n_nz (``layer_dims``)."""
    T = tile_rows(dims['D'], TB if bwd else TF)
    nap = _r4(dims['n_active'])
    cq = _r4(-(-dims['n_active'] // QD))
    best, s_best = None, 1
    s = 1
    while s <= 4:
        if T % (4 * s):
            break
        if s > 1 and 4 * _words(dims, T, s, nap, bwd) > TWO_PER_SM:
            break
        rounds = -(-dims['n_active'] * s // NT)
        cost = rounds * (T // s + 4)
        if best is None or cost < best:
            best, s_best = cost, s
        s *= 2
    return Shape(T, s_best, nap, cq, 4 * _words(dims, T, s_best, nap, bwd))


def layer_dims(conv, D: int) -> Dict[str, int]:
    """The plan numbers of a ``FusedConv`` that the launch shape reads."""
    t = conv.kernel_tables(_cpu())
    return dict(D=D, d1=conv.d1, nb=conv.nb, d_out=conv.d_out,
                n_ins=t.n_ins, n_active=t.n_active, agg_dim=t.agg_dim,
                n_nz=t.n_nz)


def _cpu():
    import torch
    return torch.device('cpu')


def column_items(n_active: int, T: int, s: int, rows: int) -> List[List]:
    """Per thread, its (live column, first row, end row) items of one tile
    of ``rows`` rows: item j = tid + k NT is column j % n_active, row group
    j // n_active (rows [g T/s, (g+1) T/s) cut at ``rows``)."""
    R = T // s
    out: List[List] = [[] for _ in range(NT)]
    for j in range(n_active * s):
        c, g = j % n_active, j // n_active
        e0, e1 = g * R, min(g * R + R, rows)
        if e0 < e1:
            out[j % NT].append((c, e0, e1))
    return out


class XClass(NamedTuple):
    start: int    # first item
    lanes: int    # items per row (32, or the multiplicity under 32)
    uit: int      # channels a thread covers (32 apart)
    xe: int       # x entry
    l1: int


def classes(xent: np.ndarray, T: int) -> List[XClass]:
    """The backward's i1 classes: every x entry (one without live users
    writes its zero dxg columns), each an item range of T * lanes items
    padded to a warp."""
    out, start = [], 0
    for xe, (off, mul, dim, n_ins, _) in enumerate(np.asarray(xent)):
        lanes = 32 if mul % 32 == 0 else int(mul)
        uit = int(mul) // 32 if mul % 32 == 0 else 1
        out.append(XClass(start, lanes, uit, xe, (int(dim) - 1) // 2))
        start += -(-T * lanes // 32) * 32
    return out


def class_items(xent: np.ndarray, T: int, rows: int):
    """Per warp, its items of one tile: (x entry, row, channels) for every
    valid lane, in the order the warp runs them. A warp takes items
    j0 = 32 warp + k NT; lane l is item j0 + l."""
    cls = classes(xent, T)
    n_items = (cls[-1].start + -(-T * cls[-1].lanes // 32) * 32) if cls else 0
    per_warp: List[List] = [[] for _ in range(NW)]
    for warp in range(NW):
        for j0 in range(32 * warp, n_items, NT):
            k = max(i for i, c in enumerate(cls) if c.start <= j0)
            C = cls[k]
            for lane in range(32):
                loc = j0 + lane - C.start
                e, lane_u = divmod(loc, C.lanes)
                if e < rows:
                    per_warp[warp].append(
                        (C.xe, e, tuple(lane_u + 32 * it
                                        for it in range(C.uit))))
    return per_warp


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('fused_conv_geom')
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_conv_geom_shape.argtypes = ([I] + [P] * 9 + [I] * 14 + [F] * 4
                                          + [P])
    lib.fused_conv_geom_shape.restype = I
    return lib


def kernel_shape(dims: Dict[str, int], bwd: bool) -> Shape:
    """The shape the C entry launches with (needs the built library, not a
    card)."""
    out = (ctypes.c_int * 5)()
    d = dims
    n_atoms = 1
    args = [int(bwd)] + [None] * 9 + [
        n_atoms, d['D'], d['d1'], 0, d['nb'], 0, d['d_out'], d['n_ins'],
        d['n_active'], 0, 0, d['agg_dim'], d['n_nz'], 0, 0.0, 0.0, 0.0, 0.0]
    err = _lib().fused_conv_geom_shape(*args, out)
    cuda_build.check(err, 'fused_conv_geom_shape')
    return Shape(*out)
