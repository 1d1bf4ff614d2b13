"""On-device migration and neighbor rebuild for the brick engine.

Counterpart of ``sevennet_exp_tpu/parallel/devrebuild.py``: the analog of
LAMMPS' reneighboring triad -- pbc() wrap, comm exchange() (atom
migration), comm borders() (ghost selection) and the neighbor build --
in torch on the bricks' devices, with no host round trip but the one read
of the overflow flag:

  1. wrap positions into the box,
  2. per decomposed mesh axis, migrate atoms whose home brick changed to
     the adjacent brick (positions, velocities, forces, atomic numbers and
     global atom ids ride one message; staged per-axis passes resolve
     corner moves with no diagonal messages),
  3. rebuild the per-phase halo send selections from the new positions
     (boundary tests in brick-fractional coordinates),
  4. rebuild each brick's symmetric dense neighbor grid (EDGE_REV and the
     grid degree, ``parallel/brick.py``'s layout) with a mixed-boundary
     cell list: open bins along decomposed axes (ghost copies carry the
     images), minimum image along the others.

Every array keeps the static capacities of the host decomposition it
starts from (``RebuildGeom``); an atom or an edge that does not fit sets
the overflow flag, and the engine then re-decomposes on the host with
fresh margins and retries (``mdbrick.BrickMolecularDynamics._run_dev``).
That is the JAX engine's capacity fallback; it selects no kernel.

One controller drives every brick (``mdbrick.py``): a message from brick
s to brick d is the sender's packed rows moved with ``.to(d's device)``.
The index bookkeeping follows the host decomposition's contracts, so both feed
the same force path.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .brick import _plane_width
from ..ops.scatter import reverse_permutation

Tensor = torch.Tensor


class RebuildGeom(NamedTuple):
    """Static (host-computed) geometry for the device rebuild."""
    mesh: Tuple[int, ...]      # (P0[, P1[, P2]])
    axes: Tuple[int, ...]
    fc: Tuple[float, ...]      # per-phase cutoff in brick-fraction units
    # mixed cell list over the view, per cartesian axis 0..2:
    nb: Tuple[int, int, int]            # bin count
    open_axis: Tuple[bool, bool, bool]  # open (decomposed) vs periodic
    lo: Tuple[float, float, float]      # region lower bound (brick frac
    #                                     for open axes, 0 for periodic)
    w: Tuple[float, float, float]       # bin width in region units
    cell_cap: int
    cap_loc: int
    cap_g: Tuple[int, ...]
    deg_cap: int
    rows: int


def make_geom(spec, cell: np.ndarray, cutoff: float,
              cell_cap_margin: float = 2.5) -> RebuildGeom:
    """The static rebuild geometry of a host ``BrickSpec`` (JAX
    ``make_geom``)."""
    mesh, axes = spec.mesh, spec.axes
    fc = [cutoff / _plane_width(cell, ax) * P for P, ax in zip(mesh, axes)]
    nb, open_axis = [1, 1, 1], [False, False, False]
    lo, w = [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]
    ax_to_phase = {ax: k for k, ax in enumerate(axes)}
    for c in range(3):
        width = _plane_width(cell, c)
        if c in ax_to_phase and mesh[ax_to_phase[c]] > 1:
            f = fc[ax_to_phase[c]]
            open_axis[c] = True
            extent = 1.0 + 2.0 * f
            nb[c] = max(1, int(extent / f))
            lo[c] = -f
            w[c] = extent / nb[c]
        else:
            # periodic: the wrapped stencil needs >= 3 bins (2 would visit
            # one neighbour bin twice)
            fr = cutoff / width
            n = int(1.0 / fr) if fr < 1.0 else 1
            nb[c] = n if n >= 3 else 1
            w[c] = 1.0 / nb[c]
    # per-bin capacity from the density over the bin volume
    n_atoms = int(spec.loc_mask.sum())
    vol = abs(np.linalg.det(cell))
    bin_vol = vol
    for c in range(3):
        bin_vol *= w[c] / mesh[ax_to_phase[c]] if open_axis[c] else w[c]
    cell_cap = int(np.ceil(n_atoms / vol * bin_vol * cell_cap_margin + 8))
    return RebuildGeom(
        mesh=tuple(mesh), axes=tuple(axes), fc=tuple(fc), nb=tuple(nb),
        open_axis=tuple(open_axis), lo=tuple(lo), w=tuple(w),
        cell_cap=cell_cap, cap_loc=spec.cap_loc, cap_g=tuple(spec.cap_g),
        deg_cap=spec.deg_cap, rows=spec.rows)


class LocalState(NamedTuple):
    """One brick's own atoms, ``cap_loc`` rows (pad rows: mask 0)."""
    pos: Tensor        # (cap_loc, 3)
    vel: Tensor
    forces: Tensor
    z: Tensor          # (cap_loc,) int64
    ids: Tensor        # (cap_loc,) int64 global atom ids (-1 pad)
    loc_mask: Tensor   # (cap_loc,) float


class BrickView(NamedTuple):
    """One brick's halo phases and dense grid over its view."""
    send_idx: Tuple[Tensor, ...]   # K x (2, cap_g[k]) int64
    send_mask: Tuple[Tensor, ...]  # K x (2, cap_g[k]) float
    shift: Tuple[Tensor, ...]      # K x (2, cap_g[k], 3) float
    edge_idx: Tensor               # (2, rows) int64
    edge_mask: Tensor              # (rows,) float
    edge_rev: Tensor               # (rows,) int64


def first_true(mask: Tensor, cap: int):
    """(idx, ok, count): the indices of the first ``cap`` True entries of
    ``mask`` in order (``len(mask)`` past the count), which slots hold one,
    and the count; by a cumulative sum, with no host synchronisation."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.long(), 0) - 1
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), n, dtype=torch.long, device=mask.device)
    # every slot below cap is written once; the spare slot cap takes the rest
    idx[slot] = torch.arange(n, device=mask.device)
    idx = idx[:cap]
    return idx, idx < n, mask.long().sum()


def _select_pack(mask: Tensor, cap: int, arrays: Sequence[Tensor]):
    """The rows where ``mask`` holds packed into ``cap`` slots (zeros past
    the count): (packed arrays, slot mask, overflow)."""
    idx, ok, cnt = first_true(mask, cap)
    safe = torch.clamp(idx, max=max(mask.shape[0] - 1, 0))
    out = []
    for a in arrays:
        okr = ok.reshape((cap,) + (1,) * (a.ndim - 1))
        out.append(torch.where(okr, a[safe], torch.zeros_like(a[:1])))
    return out, ok, cnt > cap


def _pack_front(mask: Tensor, arrays: Sequence[Tensor]):
    """Stable partition: rows with ``mask`` first, in order; (arrays,
    count)."""
    n = mask.shape[0]
    m = mask.long()
    cnt = m.sum()
    dest = torch.where(mask, torch.cumsum(m, 0) - 1,
                       cnt + torch.cumsum(1 - m, 0) - 1)
    order = torch.empty(n, dtype=torch.long, device=mask.device)
    order[dest] = torch.arange(n, device=mask.device)
    return [a[order] for a in arrays], cnt


def _mesh_index(b: int, k: int, mesh: Tuple[int, ...]) -> int:
    """Mesh index of flat brick b along mesh dim k (row-major)."""
    for kk in range(len(mesh) - 1, k, -1):
        b //= mesh[kk]
    return b % mesh[k]


def device_rebuild(geom: RebuildGeom, cell: np.ndarray, cutoff: float,
                   local: List[LocalState], nbr, devices):
    """Migrate, select halos and rebuild every brick's grid.

    local: the bricks' ``LocalState``; nbr[k][b] = (the brick above b
    along mesh dim k, the one below); devices[b]: brick b's device.
    Returns (new LocalState list, BrickView list, overflow): overflow is a
    bool tensor on brick 0's device, true when any capacity overflowed
    (the result is then unusable)."""
    mesh, axes, K = geom.mesh, geom.axes, len(geom.mesh)
    D = len(local)
    cap_loc, deg, rows = geom.cap_loc, geom.deg_cap, geom.rows
    f32 = local[0].pos.dtype

    def consts(dev):
        return (torch.as_tensor(cell, dtype=f32, device=dev),
                torch.as_tensor(np.linalg.inv(cell), dtype=f32, device=dev))

    cells = [consts(dev) for dev in devices]
    over = [torch.zeros((), dtype=torch.bool, device=dev) for dev in devices]

    # -- 1. wrap into the box (LAMMPS pbc()) ---------------------------
    st = []
    for b, s in enumerate(local):
        c, inv = cells[b]
        st.append(s._replace(pos=torch.remainder(s.pos @ inv, 1.0) @ c))

    # -- 2. migrate per decomposed axis (LAMMPS exchange()) ------------
    for k in range(K):
        P, ax, cg = mesh[k], axes[k], geom.cap_g[k]
        if P == 1:
            continue
        sends, kept = [], []
        for b, s in enumerate(st):
            c, inv = cells[b]
            valid = s.loc_mask > 0
            u = torch.remainder(s.pos @ inv, 1.0)[:, ax] * P \
                - _mesh_index(b, k, mesh)
            # centred wrap: u in [-0.5, P - 0.5) => delta in {-1, 0, +1}
            shifted = torch.remainder(u + 0.5, P) - 0.5
            delta = torch.clamp(torch.floor(shifted), -1, 1).long()
            delta = torch.where(valid, delta, torch.zeros_like(delta))
            # an atom more than one brick away since the last rebuild
            # cannot move by adjacent swaps: flag it
            over[b] = over[b] | torch.any(
                valid & (torch.abs(shifted - torch.clamp(shifted, -1.0, 2.0))
                         > 0))
            payload = (s.pos, s.vel, s.forces, s.z, s.ids)
            side = []
            for d_val in (-1, 1):
                packed, ok, ovf = _select_pack(delta == d_val, cg, payload)
                over[b] = over[b] | ovf
                side.append((packed, ok))
            sends.append(side)
            arrs, cnt = _pack_front(valid & (delta == 0), payload)
            kept.append((arrs, cnt))
        new = []
        for b in range(D):
            (pos, vel, forces, z, ids), n_here = kept[b]
            dev = devices[b]
            hi, lo = nbr[k][b]
            # side 0 (delta -1) came down from the brick above, side 1 up
            # from the brick below: the JAX ppermute order
            for src, side in ((hi, 0), (lo, 1)):
                packed, ok = sends[src][side]
                packed = [a.to(dev) for a in packed]
                ok = ok.to(dev)
                rows_to = n_here + torch.cumsum(ok.long(), 0) - 1
                rows_to = torch.where(ok & (rows_to < cap_loc), rows_to,
                                      torch.full_like(rows_to, cap_loc))
                bufs = []
                for a, p in zip((pos, vel, forces, z, ids), packed):
                    buf = torch.cat([a, a[:1]])
                    buf[rows_to] = p
                    bufs.append(buf[:cap_loc])
                pos, vel, forces, z, ids = bufs
                n_arr = ok.long().sum()
                over[b] = over[b] | (n_here + n_arr > cap_loc)
                n_here = torch.clamp(n_here + n_arr, max=cap_loc)
            valid = torch.arange(cap_loc, device=dev) < n_here
            new.append(LocalState(pos, vel, forces, z, ids,
                                  valid.to(f32)))
        st = new
    # pad rows hold what left them: clear them, as the host decomposition
    # leaves its pads (the thermostat then counts real atoms only)
    for b, s in enumerate(st):
        valid = s.loc_mask > 0
        m = s.loc_mask[:, None]
        st[b] = s._replace(
            pos=s.pos * m, vel=s.vel * m, forces=s.forces * m,
            z=torch.where(valid, s.z, torch.zeros_like(s.z)),
            ids=torch.where(valid, s.ids, torch.full_like(s.ids, -1)))

    # -- 3. halo send selections (LAMMPS borders()) --------------------
    view_pos = [s.pos for s in st]
    view_ok = [s.loc_mask > 0 for s in st]
    sel = [([], [], []) for _ in range(D)]
    for k in range(K):
        P, ax, cg, fc = mesh[k], axes[k], geom.cap_g[k], geom.fc[k]
        msgs = []
        for b in range(D):
            c, inv = cells[b]
            m = _mesh_index(b, k, mesh)
            vp, vok = view_pos[b], view_ok[b]
            n_view = vp.shape[0]
            if P == 1:
                # an undecomposed axis: the minimum image covers it
                lo_sel = hi_sel = torch.zeros_like(vok)
            else:
                # ghosts of earlier phases carry explicit shifts: test in
                # brick units relative to this brick, wrapped
                u = torch.remainder((vp @ inv)[:, ax], 1.0) * P - m
                u = torch.remainder(u + 0.5, P) - 0.5
                lo_sel = vok & (u < fc)
                hi_sel = vok & (u > 1.0 - fc)
            il, ml, cl = first_true(lo_sel, cg)
            ih, mh, ch = first_true(hi_sel, cg)
            over[b] = over[b] | (cl > cg) | (ch > cg)
            si = torch.stack([torch.clamp(il, max=n_view - 1),
                              torch.clamp(ih, max=n_view - 1)])
            sm = torch.stack([ml, mh]).to(f32)
            # the receiver's image: side 0 wraps at mesh index 0, side 1
            # at P - 1
            s0 = c[ax] * float(m == 0)
            s1 = -c[ax] * float(m == P - 1)
            sh = torch.stack([s0.expand(cg, 3), s1.expand(cg, 3)])
            sel[b][0].append(si)
            sel[b][1].append(sm)
            sel[b][2].append(sh)
            msgs.append(((vp[si[0]] + sh[0]) * sm[0][:, None], ml,
                         (vp[si[1]] + sh[1]) * sm[1][:, None], mh))
        # the arrival, to extend each view for the next phase
        for b in range(D):
            dev = devices[b]
            hi, lo = nbr[k][b]
            view_pos[b] = torch.cat([view_pos[b], msgs[hi][0].to(dev),
                                     msgs[lo][2].to(dev)])
            view_ok[b] = torch.cat([view_ok[b], msgs[hi][1].to(dev),
                                    msgs[lo][3].to(dev)])

    # -- 4. mixed-boundary cell list and the dense grid ----------------
    views = []
    for b in range(D):
        c, inv = cells[b]
        edge_idx, emask, ovf = _grid(geom, b, view_pos[b], view_ok[b], c,
                                     inv, cutoff)
        over[b] = over[b] | ovf
        views.append(BrickView(
            send_idx=tuple(sel[b][0]), send_mask=tuple(sel[b][1]),
            shift=tuple(sel[b][2]), edge_idx=edge_idx,
            edge_mask=emask.to(f32),
            edge_rev=reverse_permutation(edge_idx, view_pos[b].shape[0])))
    overflow = torch.stack([o.to(devices[0]) for o in over]).any()
    return st, views, overflow


def _grid(geom: RebuildGeom, b: int, view_pos: Tensor, view_ok: Tensor,
          cell: Tensor, inv: Tensor, cutoff: float):
    """One brick's dense grid from its view: (edge_idx, edge mask,
    overflow)."""
    mesh, axes = geom.mesh, geom.axes
    dev = view_pos.device
    nv = view_pos.shape[0]
    deg, rows = geom.deg_cap, geom.rows
    fv = view_pos @ inv     # not wrapped: open axes need the shifts
    bins_axis, stencils = [], []
    for c in range(3):
        nb = geom.nb[c]
        if geom.open_axis[c]:
            k = axes.index(c)
            u = fv[:, c] * mesh[k] - _mesh_index(b, k, mesh)
            bc = torch.floor((u - geom.lo[c]) / geom.w[c])
            bc = torch.clamp(bc, 0, nb - 1).long()
            stencils.append((-1, 0, 1) if nb >= 2 else (0,))
        else:
            fw = torch.remainder(fv[:, c], 1.0)
            bc = torch.clamp((fw * nb).long(), 0, nb - 1)
            stencils.append((-1, 0, 1) if nb >= 3 else (0,))
        bins_axis.append(bc)
    nbx, nby, nbz = geom.nb
    nbins = nbx * nby * nbz
    bin_id = (bins_axis[0] * nby + bins_axis[1]) * nbz + bins_axis[2]
    bin_id = torch.where(view_ok, bin_id, torch.full_like(bin_id, nbins))
    order = torch.argsort(bin_id, stable=True)
    sorted_bins = bin_id[order]
    rank = torch.arange(nv, device=dev) - torch.searchsorted(
        sorted_bins, sorted_bins, side='left')
    ccap = geom.cell_cap
    over = torch.any((rank >= ccap) & (sorted_bins < nbins))
    bins = torch.full((nbins + 1, ccap), nv, dtype=torch.long, device=dev)
    bins[sorted_bins, torch.clamp(rank, max=ccap - 1)] = order

    def nb_bin(bc, c, o):
        if o == 0:
            return bc
        if geom.open_axis[c]:
            t = bc + o
            return torch.where((t < 0) | (t >= geom.nb[c]),
                               torch.full_like(t, -1), t)
        return torch.remainder(bc + o, geom.nb[c])

    # candidates by whole-bin row gathers per stencil offset; the minimum
    # image along periodic axes per pair (the view is a mixed local and
    # ghost frame, not wrapped into one cell)
    pos_pad = torch.cat([view_pos, view_pos.new_zeros((1, 3))])
    xb = [pos_pad[:, c][bins] for c in range(3)]       # (nbins + 1, ccap)
    ok_pad = torch.cat([view_ok, view_ok.new_zeros(1)])
    ar = torch.arange(nv, device=dev)
    mic = torch.tensor([0.0 if geom.open_axis[a] else 1.0 for a in range(3)],
                       dtype=view_pos.dtype, device=dev)
    ok_parts, cand_parts = [], []
    for ox in stencils[0]:
        for oy in stencils[1]:
            for oz in stencils[2]:
                bx, by, bz = (nb_bin(bins_axis[0], 0, ox),
                              nb_bin(bins_axis[1], 1, oy),
                              nb_bin(bins_axis[2], 2, oz))
                oob = (bx < 0) | (by < 0) | (bz < 0)
                cb = (bx * nby + by) * nbz + bz
                cb = torch.where(oob | ~view_ok, torch.full_like(cb, nbins),
                                 cb)
                cand = bins[cb]                                  # (nv, ccap)
                d = torch.stack([xb[c][cb] - view_pos[:, c][:, None]
                                 for c in range(3)], -1)
                g = d @ inv
                g = g - torch.round(g) * mic
                wv = g @ cell
                d2 = torch.sum(wv * wv, -1)
                ok = ((cand < nv) & (d2 < cutoff * cutoff)
                      & (cand != ar[:, None]) & view_ok[:, None]
                      & ok_pad[torch.clamp(cand, max=nv)])
                ok_parts.append(ok)
                cand_parts.append(cand)
    n_cand = len(ok_parts) * bins.shape[1]
    flat = torch.cat(ok_parts, 1).reshape(-1)        # (nv * S * ccap,)
    cand = torch.cat(cand_parts, 1).reshape(-1)

    # -- the dense grid (parallel/brick.py contract), on the device ----
    idx, evalid, count = first_true(flat, rows)
    over = over | (count > rows)
    safe = torch.clamp(idx, max=flat.shape[0] - 1)
    gi = torch.where(evalid, safe // n_cand, torch.full_like(idx, nv - 1))
    gj = torch.where(evalid, cand[safe], torch.full_like(idx, nv - 1))
    # rank within the center's segment (gi ascends: row-major flat)
    ckeep = torch.cumsum(evalid.long(), 0)
    starts = torch.searchsorted(gi, ar)
    pref = torch.where(starts > 0,
                       ckeep[torch.clamp(starts - 1, min=0)],
                       torch.zeros_like(starts))
    seg_rank = (ckeep - 1) - pref[gi]
    ok_row = evalid & (seg_rank < deg)
    over = over | torch.any(evalid & (seg_rank >= deg))
    grow = torch.where(ok_row, gi * deg + seg_rank,
                       torch.full_like(gi, rows))
    base = torch.clamp(torch.arange(rows, device=dev) // deg, max=nv - 1)
    src = torch.cat([base, base[:1]])
    src[grow] = gj
    emask = torch.zeros(rows + 1, dtype=torch.bool, device=dev)
    emask[grow] = True
    return torch.stack([base, src[:rows]]), emask[:rows], over
