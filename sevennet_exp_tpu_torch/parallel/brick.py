"""Staged brick decomposition for domain-decomposed MD (host side).

Counterpart of ``sevennet_exp_tpu/parallel/brick.py``, numpy only (the
port's own copy). One decomposition covers slabs (P,), pencils (Pa, Pb)
and full 3-D bricks (Pa, Pb, Pc): the analog of LAMMPS comm_brick's
staged swaps (comm_brick.cpp:1057-1125: two swaps per dimension, corner
ghosts ride the later phases). Ghosts arrive in K phases, one mesh axis
each: phase k sends rows selected from everything accumulated so far
([local | phase<k ghosts]), so edge and corner regions need no diagonal
messages. The engine refreshes them before every convolution
(``parallel/mdbrick.py``).

Each brick's neighbor graph is symmetric over its whole view (local and
ghost atoms are all centers: a ghost center's output rows are replaced by
the next halo refresh, and the extra rows buy the scatter-free dense grid:
every aggregation is a reshape-sum and every gather's transpose rides the
reverse-edge permutation, ``ops/scatter.py``). Rows follow the dense grid
contract ``row = center*D + k`` with masked self-edge pads. The JAX
package rounds the row count up to its TPU kernels' aggregation block
(``agg_block_unit``); the port's kernels want ``rows % D == 0``
(``FusedConv._check_rows``) and the model one row block per view atom, so
here ``rows = cap_all * deg_cap`` exactly. The degree grows in steps of 4,
which the dense-grid kernels take (their tile is D rounded up to 4).

Periodic images along an axis that the mesh does not decompose are not
copied as ghosts: the engine takes those edge vectors by the minimum image
(``mic_axes``), which needs that cell width to be at least twice the build
cutoff (``check_mic_width``): else two images of one pair both lie inside
the build cutoff, the grid holds the pair twice, and the minimum image
gives both rows one vector.

Replaces the reference's comm_brick index maps + pair_e3gnn_parallel
neighbor handling (pair_e3gnn_parallel.cpp:684-730).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..data.graph import Atoms
from ..data.neighborlist import neighbor_list as host_nl


@dataclass
class BrickSpec:
    """Per-device arrays; leading axis = flat device index (row-major
    over the mesh multi-index)."""
    mesh: Tuple[int, ...]        # (P0[, P1[, P2]])
    axes: Tuple[int, ...]        # decomposition axes, one per mesh dim
    cell: np.ndarray             # (3, 3) global cell
    cap_loc: int
    cap_g: Tuple[int, ...]       # per-phase ghost capacity (per side)
    # ownership
    owner_perm: np.ndarray       # (n_atoms,) original index of packed atoms
    pos: np.ndarray              # (D, cap_loc, 3)
    z: np.ndarray                # (D, cap_loc)
    loc_mask: np.ndarray         # (D, cap_loc)
    n_loc: np.ndarray            # (D,)
    # halo phases: send_idx[k] indexes rows [0, off_k) of the view
    send_idx: List[np.ndarray]   # K x (D, 2, cap_g[k])
    send_mask: List[np.ndarray]  # K x (D, 2, cap_g[k])
    shift: List[np.ndarray]      # K x (D, 2, cap_g[k], 3)
    # dense-grid edge layout over the view (symmetric, dst-sorted)
    edge_idx: np.ndarray         # (D, 2, rows); [0]=dst=row//deg, [1]=src
    edge_mask: np.ndarray        # (D, rows)
    edge_rev: np.ndarray         # (D, rows) reverse-edge permutation
    deg_cap: int = 0             # grid degree D (rows per center)
    rows: int = 0                # grid row count: cap_all * deg_cap

    @property
    def n_phases(self) -> int:
        return len(self.mesh)

    @property
    def cap_all(self) -> int:
        return self.cap_loc + 2 * int(np.sum(self.cap_g))

    def phase_offset(self, k: int) -> int:
        """Row count of the view BEFORE phase k's ghosts arrive."""
        return self.cap_loc + 2 * int(np.sum(self.cap_g[:k]))

    @property
    def mic_axes(self) -> Tuple[int, ...]:
        """Cartesian axes whose images no ghost carries (not decomposed,
        or over one brick): edge vectors take the minimum image there."""
        return tuple(c for c in range(3)
                     if not any(P > 1 and ax == c
                                for P, ax in zip(self.mesh, self.axes)))


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _plane_width(cell, axis):
    vol = abs(np.linalg.det(cell))
    j, k = (axis + 1) % 3, (axis + 2) % 3
    return vol / np.linalg.norm(np.cross(cell[j], cell[k]))


def _grid_layout(all_edges, cap_all, deg_cap, margin=1.15):
    """Symmetric per-device edge lists -> dense neighbor-grid arrays.

    all_edges: per device (gi, gj) with BOTH directions present (the
    symmetric-view contract). Returns (deg_cap, rows, edge_idx,
    edge_mask, rev): the previous deg_cap kept while it fits, and
    ``rows = cap_all * deg_cap`` (the port's row rule, module docstring).
    """
    deg_max = 1
    for gi, _ in all_edges:
        if len(gi):
            deg_max = max(
                deg_max, int(np.bincount(gi, minlength=cap_all).max())
            )
    if deg_max > deg_cap:
        deg_cap = int(np.ceil((deg_max * margin + 2) / 4.0) * 4)
    rows = cap_all * deg_cap

    n_dev = len(all_edges)
    base = np.minimum(np.arange(rows) // deg_cap, cap_all - 1)
    base = base.astype(np.int32)
    edge_idx = np.zeros((n_dev, 2, rows), dtype=np.int32)
    edge_mask = np.zeros((n_dev, rows), dtype=np.float32)
    rev = np.zeros((n_dev, rows), dtype=np.int32)
    for d, (gi, gj) in enumerate(all_edges):
        order = np.argsort(gi, kind='stable')
        gi, gj = gi[order], gj[order]
        counts = np.bincount(gi, minlength=cap_all)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(len(gi)) - starts[gi]
        if len(gi) and rank.max() >= deg_cap:
            raise ValueError('deg_cap overflow in _grid_layout')
        row = gi * deg_cap + rank
        src = base.copy()
        src[row] = gj
        edge_idx[d, 0] = base
        edge_idx[d, 1] = src
        edge_mask[d, row] = 1.0
        # reverse-edge permutation (ops/scatter.py contract): stable
        # double lexsort pairs (src, dst) with (dst, src); self-edge
        # pads map to themselves
        a = np.lexsort((base, src))   # primary src, secondary dst
        b = np.lexsort((src, base))   # primary dst, secondary src
        r = np.empty(rows, dtype=np.int32)
        r[a] = b
        rev[d] = r
    return deg_cap, rows, edge_idx, edge_mask, rev


def check_mic_width(cell, mesh, axes, build_cutoff):
    """Raise ValueError where an axis the mesh leaves to the minimum image
    is narrower than twice the build cutoff (see the module docstring)."""
    cell = np.asarray(cell, dtype=np.float64)
    axes = tuple(axes) if axes is not None else tuple(range(len(mesh)))
    split = {ax for P, ax in zip(mesh, axes) if P > 1}
    for c in range(3):
        width = _plane_width(cell, c)
        if c not in split and width < 2 * build_cutoff:
            raise ValueError(
                f'cell width {width:.2f} along undecomposed axis {c} < '
                f'2 x build cutoff {build_cutoff}: the minimum image would '
                f'count a pair twice; decompose that axis or take a larger '
                f'cell')


def decompose_brick(
    atoms: Atoms,
    mesh: Tuple[int, ...],
    cutoff: float,
    axes: Optional[Tuple[int, ...]] = None,
    cap_margin: float = 1.25,
    prev: Optional[BrickSpec] = None,
) -> BrickSpec:
    """Staged K-phase decomposition over `mesh` (K = 1, 2, or 3 axes).

    prev: previous spec whose capacities are kept while they still fit
    (shapes stable across rebuilds; regrown otherwise).
    """
    mesh = tuple(int(p) for p in mesh)
    K = len(mesh)
    assert 1 <= K <= 3
    axes = tuple(axes) if axes is not None else tuple(range(K))
    assert len(set(axes)) == K
    cell = np.asarray(atoms.cell, dtype=np.float64)
    pos = np.asarray(atoms.pos, dtype=np.float64)
    z = np.asarray(atoms.atomic_numbers)
    n = len(atoms)
    D = int(np.prod(mesh))
    inv = np.linalg.inv(cell)
    frac = (pos @ inv) % 1.0
    pos_w = frac @ cell

    for P, ax in zip(mesh, axes):
        width = _plane_width(cell, ax)
        if P > 1 and width / P < cutoff:
            raise ValueError(
                f'brick width {width / P:.2f} along axis {ax} < '
                f'cutoff {cutoff}: use fewer devices along that axis'
            )

    # flat device index, row-major over the mesh multi-index
    idx_k = [
        np.minimum((frac[:, ax] * P).astype(np.int64), P - 1)
        for P, ax in zip(mesh, axes)
    ]
    dev_of = np.zeros(n, dtype=np.int64)
    for i, P in zip(idx_k, mesh):
        dev_of = dev_of * P + i
    counts = np.bincount(dev_of, minlength=D)

    if prev is not None:
        cap_loc = prev.cap_loc
        cap_g = list(prev.cap_g)
        deg_cap = prev.deg_cap
        if counts.max() > cap_loc:
            cap_loc = _round_up(int(counts.max() * cap_margin) + 8, 8)
    else:
        cap_loc = _round_up(int(counts.max() * cap_margin) + 8, 8)
        cap_g = [0] * K
        deg_cap = 0

    spec_pos = np.zeros((D, cap_loc, 3))
    spec_z = np.zeros((D, cap_loc), dtype=np.int64)
    loc_mask = np.zeros((D, cap_loc), dtype=np.float32)
    n_loc = np.zeros(D, dtype=np.int64)
    owner_perm = np.zeros(n, dtype=np.int64)

    off = 0
    for d in range(D):
        sel = np.nonzero(dev_of == d)[0]
        m = len(sel)
        assert m <= cap_loc
        spec_pos[d, :m] = pos_w[sel]
        spec_z[d, :m] = z[sel]
        loc_mask[d, :m] = 1.0
        n_loc[d] = m
        owner_perm[off:off + m] = sel
        off += m

    def midx(d, k):
        """Mesh index of flat device d along mesh dim k."""
        for kk in range(K - 1, k, -1):
            d //= mesh[kk]
        return d % mesh[k]

    def flat_with(d, k, ik):
        """Flat device index of d with its k-th mesh index replaced."""
        coords = [midx(d, kk) for kk in range(K)]
        coords[k] = ik
        f = 0
        for c, P in zip(coords, mesh):
            f = f * P + c
        return f

    # staged phases: view grows [local | ph0_lo | ph0_hi | ph1_lo | ...]
    # view_atom[d, r] = original atom index of view row r (-1 invalid)
    cap_all0 = cap_loc  # grows per phase
    view_pos = spec_pos.copy()
    view_atom = np.full((D, cap_loc), -1, dtype=np.int64)
    for d in range(D):
        m = int(n_loc[d])
        view_atom[d, :m] = owner_perm[
            int(np.sum(n_loc[:d])):int(np.sum(n_loc[:d])) + m
        ]

    send_idx: List[np.ndarray] = []
    send_mask: List[np.ndarray] = []
    shift: List[np.ndarray] = []
    for k in range(K):
        P, ax = mesh[k], axes[k]
        width = _plane_width(cell, ax)
        frac_cut = cutoff / width * P
        sends = [[None, None] for _ in range(D)]
        empty = np.zeros(0, dtype=np.int64)
        for d in range(D):
            if P == 1:
                # undecomposed mesh axis: minimum-image convention
                # covers it (pbc_eff stays True below) — self-image
                # ghosts here would double-count every boundary pair
                sends[d][0] = sends[d][1] = empty
                continue
            rows_v = np.nonzero(view_atom[d] >= 0)[0]
            u = frac[view_atom[d, rows_v], ax] * P - midx(d, k)
            for side, cond in ((0, u < frac_cut), (1, u > 1 - frac_cut)):
                sends[d][side] = rows_v[np.nonzero(cond)[0]]
        need = max(
            [1] + [len(sends[d][s]) for d in range(D) for s in (0, 1)]
        )
        if need > cap_g[k]:
            cap_g[k] = _round_up(int(need * cap_margin) + 8, 8)
        cg = cap_g[k]
        si = np.zeros((D, 2, cg), dtype=np.int64)
        sm = np.zeros((D, 2, cg), dtype=np.float32)
        sh = np.zeros((D, 2, cg, 3))
        for d in range(D):
            ik = midx(d, k)
            for side in (0, 1):
                snd = sends[d][side]
                si[d, side, :len(snd)] = snd
                sm[d, side, :len(snd)] = 1.0
                s = np.zeros(3)
                if side == 0 and ik == 0:
                    s = cell[ax]
                if side == 1 and ik == P - 1:
                    s = -cell[ax]
                sh[d, side, :len(snd)] = s
        send_idx.append(si)
        send_mask.append(sm)
        shift.append(sh)

        # simulate arrival: lo slots receive (ik+1)'s side-0 sends,
        # hi slots receive (ik-1)'s side-1 sends
        new_cap = cap_all0 + 2 * cg
        vp = np.zeros((D, new_cap, 3))
        va = np.full((D, new_cap), -1, dtype=np.int64)
        vp[:, :cap_all0] = view_pos
        va[:, :cap_all0] = view_atom
        for d in range(D):
            ik = midx(d, k)
            for slot, (src_ik, side) in enumerate(
                (((ik + 1) % P, 0), ((ik - 1) % P, 1))
            ):
                src = flat_with(d, k, src_ik)
                base_r = cap_all0 + slot * cg
                snd = sends[src][side]
                r = si[src, side, :len(snd)]
                vp[d, base_r:base_r + len(snd)] = (
                    view_pos[src, r] + sh[src, side, :len(snd)]
                )
                va[d, base_r:base_r + len(snd)] = view_atom[src, r]
        view_pos, view_atom, cap_all0 = vp, va, new_cap

    # symmetric edge lists over the full view (ALL valid atoms are
    # centers; see module docstring), periodic images suppressed along
    # decomposed axes with P > 1 (ghost copies carry them)
    pbc_eff = [True, True, True]
    for P, ax in zip(mesh, axes):
        if P > 1:
            pbc_eff[ax] = False
    all_edges = []
    for d in range(D):
        vi = np.nonzero(view_atom[d] >= 0)[0]
        ei, ej, _, _ = host_nl(view_pos[d, vi], cell, pbc_eff, cutoff)
        all_edges.append((vi[ei], vi[ej]))

    deg_cap, rows, edge_idx, edge_mask, edge_rev = _grid_layout(
        all_edges, cap_all0, deg_cap
    )

    return BrickSpec(
        mesh=mesh, axes=axes, cell=cell,
        cap_loc=cap_loc, cap_g=tuple(cap_g),
        owner_perm=owner_perm, pos=spec_pos, z=spec_z,
        loc_mask=loc_mask, n_loc=n_loc,
        send_idx=send_idx, send_mask=send_mask, shift=shift,
        edge_idx=edge_idx, edge_mask=edge_mask, edge_rev=edge_rev,
        deg_cap=deg_cap, rows=rows,
    )
