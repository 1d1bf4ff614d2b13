"""Launch shape and work mapping of the conv kernels of
``csrc/fused_conv_geom.cu``, in Python: the geometry-fused pair
(``geom=True``) and the dense-grid pair, kernels 1-2 (``geom=False``), one
template there, which differ only in the shared words of the edge vectors;
and that template's third mode, the edge pair, kernels 1-2 at ``agg_d = 0``
(``edge=True``), whose tiles are any rows of the edge list and whose si2 is
a product over the tile's rows (``product_plan``).

The kernels choose their tile, their row groups and their i1 classes on
the host side of the C entry (``geom_shape``) and inside the block; this
module holds the same arithmetic so that the CPU tests can check that every
live column and every x channel of every row is covered exactly once, and so
that a numpy replay can run the kernels' loop order. On the card
``kernel_shape`` asks the C entry ``fused_conv_geom_shape`` for the numbers
it launches with (``tests/test_torch_cuda.py`` holds the two equal), and
``kernel_resources`` the compiled instance's registers, local memory and
blocks an SM.

    T     rows per tile: at most 16, D rounded up to 4 when that is fewer
    s     row groups per live column (1, 2 or 4; T / s rows each, a
          multiple of 4): the fewest rounds of the block's 256 threads, a w2
          column load counted as 4 rows, within two blocks per SM
    nap   live columns rounded up to 4 (row stride of the per-row w / dw)
    cq    pass D: live columns per quarter, a multiple of 4

The edge pair (the template's third mode): its forward gets the shared
words of two blocks an SM and fits its tile into them inside the block
(``edge_fwd_plan``: up to ``TEF`` rows, set by the widest si2 group's
columns and the largest group's messages), then runs si2 group by group:
the w pass over the group's columns, its CG into the group's message tile,
the product with its W. Its backward takes T = TE with one message
cotangent per row and, in the words of the MLP's rows, the rows'
cotangents g; its products keep their partial sums in those words
(``edge_red_words``).
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
TWO_PER_SM = (233472 - 2 * 1024) // 2     # shared bytes a block, 2 an SM
THREE_PER_SM = (233472 - 3 * 1024) // 3   # the same, 3 an SM
MAX_SMEM = 232448                         # shared bytes a block at most
TE = 8            # edge backward: rows per tile
TEF = 16          # edge forward: rows per tile (at most)
KS_MAX = 8        # edge products: threads that share one block
RB = 8            # edge products: rows of a thread's block
EDGE_FWD_WORDS = TWO_PER_SM // 4   # edge forward: shared words a block
TX = 32           # external-weight backward: rows per tile at most


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


def _edge_words(dims: Dict[str, int], T: int, nap: int, bwd: bool) -> int:
    d = dims
    if not bwd:
        return EDGE_FWD_WORDS
    head = (_table_words(d['n_ins'], d['n_nz']) + _r4(d['n_ins'])
            + _r4(T * d['agg_dim']) + _r4(T * SHP) + _r4(T * d['nb'])
            + _r4(T))
    mlp = (4 + QD) * T * H + NW * T * SHP
    wdw = max(TE * nap + SLAB, T * _r4(d['d_out']) - mlp)
    return head + _r4(MAX_XENT * 5) + _r4(T * SHP) + _r4(wdw) + mlp


def edge_red_words(dims: Dict[str, int]) -> int:
    """The words the edge backward's products keep their parts' partial
    sums in: w / dw to the pass-D partials past the tile's g rows (the
    forward's are its w rows, ``EdgeFwdPlan.red_words``)."""
    T, nap = TE, _r4(dims['n_active'])
    mlp = (4 + QD) * T * H + NW * T * SHP
    ds = T * _r4(dims['d_out'])
    return _r4(max(TE * nap + SLAB, ds - mlp)) + mlp - ds


class EdgeGroup(NamedTuple):
    c0: int       # first live column (the group's columns are consecutive)
    nc: int       # live columns
    K: int
    mo: int
    d3: int
    a0: int       # offset of the group's slice in the plain chain's layout
    o_off: int    # first output column
    w_off: int    # offset of W in the flat si2 weights


def edge_groups(tables) -> List[EdgeGroup]:
    """The si2 groups of a layer's kernel tables (``FusedConv
    .kernel_tables``) with their live columns, as ``group_columns`` finds
    them: every instruction whose slice offset lies in the group's."""
    ins = tables.ins.cpu().numpy().reshape(tables.n_ins, -1)
    out = []
    for K, mo, d3, o_off, a0, w_off in \
            tables.grp.cpu().numpy().reshape(tables.n_grp, -1).tolist():
        mine = [r for r in ins if a0 <= r[7] < a0 + d3 * K]
        lo = min((int(r[9]) for r in mine), default=tables.n_active)
        hi = max((int(r[9] + r[1]) for r in mine), default=0)
        out.append(EdgeGroup(lo, max(hi - lo, 0), K, mo, d3, a0, o_off,
                             w_off))
    return out


class EdgeFwdPlan(NamedTuple):
    T: int          # rows per tile (0: not even RB fit)
    nc4: int        # the widest group's columns, rounded up to 4
    slice4: int     # the largest group's message words a row, rounded up
    red_words: int  # the products' partial sums: the w rows, T * nc4
    groups: List[EdgeGroup]


def edge_fwd_plan(dims: Dict[str, int], tables) -> EdgeFwdPlan:
    """The edge forward's tile (``edge_fwd_tiles`` / ``edge_fwd_rows``):
    the most rows, a multiple of RB up to TEF, whose sh, emb, ms, h1, w of
    the widest group and the larger of h0 and the largest group's messages
    fit EDGE_FWD_WORDS after the tables, the factors and the unwritten
    columns' list."""
    groups = edge_groups(tables)
    nc4 = max((_r4(g.nc) for g in groups), default=0)
    slice4 = max((_r4(g.d3 * g.K) for g in groups), default=0)
    fixed = (_table_words(dims['n_ins'], dims['n_nz']) + _r4(dims['n_ins'])
             + _r4(dims['d_out'] + 1))
    per_row = SHP + dims['nb'] + 1 + H + nc4 + max(H, slice4)
    T = next((t for t in range(TEF, 0, -RB)
              if fixed + t * per_row <= EDGE_FWD_WORDS), 0)
    return EdgeFwdPlan(T, nc4, slice4, T * nc4, groups)


def w_row_groups(nc: int, T: int) -> int:
    """Row groups of the edge forward's w pass over nc columns: the rule
    of ``shape``."""
    best, s_best, s = None, 1, 1
    while s <= 4 and T % (4 * s) == 0:
        cost = -(-nc * s // NT) * (T // s + 4)
        if best is None or cost < best:
            best, s_best = cost, s
        s *= 2
    return s_best


def cg_parts(nc: int) -> int:
    """Parts of the rows the edge forward's CG splits a column's rows into
    (1, 2 or 4): doubled while the items fit the block's threads."""
    sp = 1
    while sp < 4 and nc * sp * 2 <= NT:
        sp *= 2
    return sp


def _words(dims: Dict[str, int], T: int, s: int, nap: int, bwd: bool,
           geom: bool, edge: bool = False) -> int:
    if edge:
        return _edge_words(dims, T, nap, bwd)
    d = dims
    base = _table_words(d['n_ins'], d['n_nz']) + _r4(d['n_ins'])
    vec = _r4(T * 3) if geom else 0
    if not bwd:
        return (base + _r4(T * SHP) + _r4(T * d['nb'])
                + vec + _r4(T) + 2 * _r4(T * H) + _r4(T * nap)
                + _r4(s * d['agg_dim']) + _r4(d['d_out']))
    return (base + _r4(MAX_XENT * 5) + _r4(d['d_out']) + _r4(d['agg_dim'])
            + _r4(TB * nap + SLAB) + 4 * _r4(T * H) + _r4(QD * T * H)
            + _r4(NW * T * SHP) + 2 * _r4(T * SHP) + _r4(T * d['nb'])
            + vec + _r4(T))


def shape(dims: Dict[str, int], bwd: bool, geom: bool = True,
          edge: bool = False) -> Shape:
    """The launch shape of one layer: ``dims`` holds D, d1, nb, d_out,
    n_ins, n_active, agg_dim, n_nz (``layer_dims``); ``geom`` False for the
    dense-grid pair; ``edge`` the edge pair (D not read)."""
    T = ((TE if bwd else TEF) if edge
         else tile_rows(dims['D'], TB if bwd else TF))
    nap = _r4(dims['n_active'])
    cq = _r4(-(-dims['n_active'] // QD))
    best, s_best = None, 1
    # the edge forward picks its row groups per si2 group (w_row_groups)
    s = 5 if edge and not bwd else 1
    while s <= 4:
        if T % (4 * s):
            break
        if s > 1 and 4 * _words(dims, T, s, nap, bwd, geom,
                                edge) > TWO_PER_SM:
            break
        rounds = -(-dims['n_active'] * s // NT)
        cost = rounds * (T // s + 4)
        if best is None or cost < best:
            best, s_best = cost, s
        s *= 2
    return Shape(T, s_best, nap, cq,
                 4 * _words(dims, T, s_best, nap, bwd, geom, edge))


def edge_tiles(n_rows: int, grid: int, T: int = TE) -> List[List]:
    """Per block of a persistent grid, its (first row, rows) tiles of the
    edge pair: tile t = block + k grid covers rows [t T, t T + T) cut at
    n_rows (T: TE backward, the forward's ``edge_fwd_plan``)."""
    n_tiles = -(-n_rows // T)
    return [[(t * T, min(T, n_rows - t * T))
             for t in range(b, n_tiles, grid)] for b in range(grid)]


class ProductPlan(NamedTuple):
    items: int    # blocks of sums: RB rows (of one p) by 4 columns
    ks: int       # threads that share a block (each every ks-th 4 k)


def product_plan(T: int, d3: int, kred: int, n: int,
                 red_words: int) -> ProductPlan:
    """The blocks of the edge pair's per-group product (``row_product``):
    kred-deep sums for T * d3 rows and n columns, the parts' partial sums
    ((ks - 1) blocks of 4 RB each) within red_words."""
    items = (T * d3 // RB) * (-(-n // 4))
    ks = 1 if items >= NT else min(NT // items, KS_MAX,
                                   1 + red_words // (4 * RB * items))
    return ProductPlan(items, ks)


def product_ks(plan: ProductPlan, part: int, kred: int) -> List[int]:
    """The k that part ``part`` of a block sums, in order: every ks-th
    group of 4 below the last multiple of 4, part 0 then the tail."""
    k4 = kred & ~3
    ks = [k + kk for k in range(4 * part, k4, 4 * plan.ks)
          for kk in range(4)]
    return ks + (list(range(k4, kred)) if part == 0 else [])


def layer_dims(conv, D: int) -> Dict[str, int]:
    """The plan numbers of a ``FusedConv`` that the launch shape reads."""
    t = conv.kernel_tables(_cpu())
    return dict(D=D, d1=conv.d1, nb=conv.nb, d_out=conv.d_out,
                n_ins=t.n_ins, n_active=t.n_active, agg_dim=t.agg_dim,
                n_nz=t.n_nz)


def extw_dims(conv) -> Dict[str, int]:
    """``layer_dims`` at the conv's grid degree with what the external-weight
    backward's shared words read besides: the x entries and the weight
    width."""
    t = conv.kernel_tables(_cpu())
    return dict(layer_dims(conv, conv.agg_d), n_xent=t.n_xent,
                wn=conv.w_numel)


def extw_words(dims: Dict[str, int], T: int) -> int:
    """Shared words of one block of the external-weight backward at T rows
    (the tables, the pattern scales, the x-entry classes, the weight-column
    map, g, gm, w / dw, the dsh partials per warp, sh and the live
    marks)."""
    d = dims
    return (_table_words(d['n_ins'], d['n_nz']) + _r4(d['n_ins'])
            + _r4((d['n_xent'] + 1) * 5) + _r4(d['wn']) + _r4(d['d_out'])
            + _r4(d['agg_dim']) + T * _r4(d['n_active']) + NW * T * SHP
            + T * SHP + _r4(T))


def extw_tile(dims: Dict[str, int]) -> int:
    """Rows per tile of the external-weight backward: the largest of 32, 16
    and 8 (not past D rounded up to 8) whose block fits two an SM, else 8
    if one fits, else 0 (refused)."""
    T = min(TX, (dims['D'] + 7) & ~7)
    while T >= 8:
        if 4 * extw_words(dims, T) <= TWO_PER_SM:
            return T
        T //= 2
    return 8 if 4 * extw_words(dims, 8) <= MAX_SMEM else 0


def extw_fwd_words(dims: Dict[str, int], T: int, s: int) -> int:
    """Shared words of one block of the external-weight forward at T rows
    and s row groups (the tables, the pattern scales, the live columns'
    weight columns, sh, w, the partial aggregates and the output row)."""
    d = dims
    nap = _r4(d['n_active'])
    return (_table_words(d['n_ins'], d['n_nz']) + _r4(d['n_ins']) + nap
            + T * SHP + T * nap + s * _r4(d['agg_dim']) + _r4(d['d_out']))


def extw_fwd_shape(dims: Dict[str, int]):
    """(T, s) of the external-weight forward: the most rows, D rounded up to
    4 at most 16, whose block fits three an SM (else two, else one) with one
    row group; then the row groups (1, 2 or 4, each a multiple of 4 rows)
    with the fewest rounds of the block's threads, a column's start counted
    as 4 rows, within the same blocks an SM. (0, 0): no tile fits."""
    for lim in (THREE_PER_SM, TWO_PER_SM, MAX_SMEM):
        for T in range(tile_rows(dims['D'], TF), 3, -4):
            if 4 * extw_fwd_words(dims, T, 1) > lim:
                continue
            best = None
            for s in (1, 2, 4):
                if T % (4 * s) or 4 * extw_fwd_words(dims, T, s) > lim:
                    break
                cost = -(-dims['n_active'] * s // NT) * (T // s + 4)
                if best is None or cost < best[0]:
                    best = (cost, s)
            return T, best[1]
    return 0, 0


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
    for fn in (lib.fused_conv_geom_shape, lib.fused_conv_geom_resources):
        fn.argtypes = [I, I] + [P] * 9 + [I] * 14 + [F] * 4 + [P]
        fn.restype = I
    return lib


def _plan_args(dims: Dict[str, int], f: int = 0) -> list:
    """The plan arguments the host side reads (no tables: nothing is
    launched)."""
    d = dims
    return [None] * 9 + [
        1, d['D'], d['d1'], f, d['nb'], 0, d['d_out'], d['n_ins'],
        d['n_active'], 0, 0, d['agg_dim'], d['n_nz'], 0, 0.0, 0.0, 0.0, 0.0]


def _mode(geom: bool, edge: bool) -> int:
    """The C entries' pair: 0 dense, 1 geometry-fused, 2 edge."""
    return 2 if edge else int(geom)


def kernel_shape(dims: Dict[str, int], bwd: bool, geom: bool = True,
                 edge: bool = False) -> Shape:
    """The shape the C entry launches with (needs the built library, not a
    card)."""
    out = (ctypes.c_int * 5)()
    err = _lib().fused_conv_geom_shape(int(bwd), _mode(geom, edge),
                                       *_plan_args(dims), out)
    cuda_build.check(err, 'fused_conv_geom_shape')
    return Shape(*out)


class Resources(NamedTuple):
    registers: int
    local_bytes: int    # local memory a thread (spills, stack arrays)
    blocks_per_sm: int
    smem: int           # dynamic shared bytes of one block


def kernel_resources(dims: Dict[str, int], f: int, bwd: bool,
                     geom: bool = True, edge: bool = False) -> Resources:
    """The compiled kernel a layer with ``f`` SH components launches: its
    registers, local bytes, blocks an SM at its shared bytes (on the current
    card)."""
    out = (ctypes.c_int * 4)()
    err = _lib().fused_conv_geom_resources(int(bwd), _mode(geom, edge),
                                           *_plan_args(dims, f), out)
    cuda_build.check(err, 'fused_conv_geom_resources')
    return Resources(*out)
