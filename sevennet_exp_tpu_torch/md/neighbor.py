"""Neighbor lists with static capacities, in torch.

Counterpart of ``sevennet_exp_tpu/md/neighbor.py``: a fixed edge
capacity with an overflow flag instead of dynamic growth (the engine
grows the capacity on the host and rebuilds).

  - ``dense_neighbor_list``: O(N^2) minimum image, for small systems
  - ``cell_list_neighbor_list``: O(N) binning on a fractional grid

Both need every cell width >= 2 * cutoff (minimum-image convention).
Edges come out sorted by center atom; pad rows point at the last atom
(i = j = N - 1) and are invalid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


class NeighborState(NamedTuple):
    edge_idx: Tensor            # (2, E) int64; [0] = center i, [1] = neighbor j
    valid: Tensor               # (E,) bool
    overflow: Tensor            # () bool -- Verlet build capacity overflow
    ref_pos: Tensor             # (N, 3) positions at build / compaction
    rev: Optional[Tensor] = None          # grid-row reverse permutation
    #   (set by engine._compact_nl only: its presence marks a dense grid)
    overflow_deg: Optional[Tensor] = None  # () bool -- grid degree overflow
    overflow_bin: Optional[Tensor] = None  # () bool -- cell-list bin overflow
    build_rev: Optional[Tensor] = None    # reverse permutation of the build list
    half: Optional[Tensor] = None         # (E//2,) half list of the grid and
    pair: Optional[Tensor] = None         # (E,) its pair index (engine option
    #   half_mlp; ops/scatter.half_pair_indices); None after a degree overflow


def mic_displacements(pos_i, pos_j, cell, inv_cell):
    """Minimum-image pos_j - pos_i for a (possibly triclinic) cell."""
    d = pos_j - pos_i
    frac = d @ inv_cell
    frac = frac - torch.round(frac)
    return frac @ cell


def _pack_edges(flat_ok: Tensor, e_cap: int, n: int, row_width: int,
                cand: Optional[Tensor] = None):
    """First e_cap set positions of a flattened (N, row_width) mask ->
    (i, j, valid, count); pads at (n-1, n-1)."""
    count = flat_ok.sum()
    (idx,) = torch.nonzero(flat_ok, as_tuple=True)
    idx = idx[:e_cap]
    pad = e_cap - idx.shape[0]
    if pad:
        idx = torch.cat([idx, idx.new_zeros(pad)])
    i = idx // row_width
    j = idx % row_width if cand is None else cand.reshape(-1)[idx]
    valid = torch.arange(e_cap, device=idx.device) < count
    last = torch.full_like(i, n - 1)
    return (torch.where(valid, i, last), torch.where(valid, j.long(), last),
            valid, count)


def dense_neighbor_list(pos: Tensor, cell: Tensor, cutoff: float,
                        e_cap: int) -> NeighborState:
    n = pos.shape[0]
    inv_cell = torch.linalg.inv(cell)
    d = mic_displacements(pos[:, None, :], pos[None, :, :], cell, inv_cell)
    d2 = torch.sum(d * d, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    mask = (d2 < cutoff * cutoff) & ~eye
    i, j, valid, count = _pack_edges(mask.reshape(-1), e_cap, n, n)
    return NeighborState(
        edge_idx=torch.stack([i, j]), valid=valid, overflow=count > e_cap,
        ref_pos=pos, overflow_bin=torch.zeros((), dtype=torch.bool,
                                              device=pos.device))


def cell_list_neighbor_list(pos: Tensor, cell: Tensor, cutoff: float,
                            e_cap: int, grid, cell_cap: int
                            ) -> NeighborState:
    """O(N) binned list; grid = (nx, ny, nz), each >= 3 and each bin at
    least ``cutoff`` wide; cell_cap = max atoms per bin. Candidates in the
    27 neighbor bins are measured on the wrapped positions with the
    lattice shift that the bin wrap implies (no per-pair rounding)."""
    n = pos.shape[0]
    dev = pos.device
    nx, ny, nz = grid
    nbins = nx * ny * nz
    inv_cell = torch.linalg.inv(cell)
    frac = torch.remainder(pos @ inv_cell, 1.0)
    pos = frac @ cell
    gx = torch.clamp((frac[:, 0] * nx).long(), 0, nx - 1)
    gy = torch.clamp((frac[:, 1] * ny).long(), 0, ny - 1)
    gz = torch.clamp((frac[:, 2] * nz).long(), 0, nz - 1)
    bin_id = (gx * ny + gy) * nz + gz
    order = torch.argsort(bin_id, stable=True)
    sorted_bins = bin_id[order]
    rank = (torch.arange(n, device=dev)
            - torch.searchsorted(sorted_bins, sorted_bins, side='left'))
    bin_overflow = torch.any(rank >= cell_cap)
    bins = torch.full((nbins, cell_cap), n, dtype=torch.long, device=dev)
    bins[sorted_bins, torch.clamp(rank, 0, cell_cap - 1)] = order
    pos_pad = torch.cat([pos, pos.new_zeros((1, 3))])
    xb = [pos_pad[:, a][bins] for a in range(3)]     # (nbins, cap) planes
    arange_n = torch.arange(n, device=dev)
    ok_parts, cand_parts = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                rx, ry, rz = gx + ox, gy + oy, gz + oz
                cb = ((rx % nx) * ny + ry % ny) * nz + rz % nz
                wx = torch.div(rx, nx, rounding_mode='floor')
                wy = torch.div(ry, ny, rounding_mode='floor')
                wz = torch.div(rz, nz, rounding_mode='floor')
                cand_o = bins[cb]                          # (N, cap)
                d2_o = 0.0
                for a in range(3):
                    shift = (wx * cell[0, a] + wy * cell[1, a]
                             + wz * cell[2, a])[:, None]
                    da = xb[a][cb] + shift - pos[:, a][:, None]
                    d2_o = d2_o + da * da
                ok_o = ((cand_o < n) & (d2_o < cutoff * cutoff)
                        & (cand_o != arange_n[:, None]))
                ok_parts.append(ok_o)
                cand_parts.append(cand_o)
    ok = torch.cat(ok_parts, dim=1)                      # (N, 27 * cap)
    cand = torch.cat(cand_parts, dim=1)
    i, j, valid, count = _pack_edges(ok.reshape(-1), e_cap, n,
                                     27 * cell_cap, cand=cand)
    return NeighborState(
        edge_idx=torch.stack([i, j]), valid=valid, overflow=count > e_cap,
        ref_pos=pos, overflow_bin=bin_overflow)


def choose_grid(cell: np.ndarray, cutoff: float):
    """Static grid dims: bins at least ``cutoff`` wide along each axis
    (plane-to-plane distance)."""
    cell = np.asarray(cell, dtype=np.float64)
    vol = abs(np.linalg.det(cell))
    dims = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        width = vol / np.linalg.norm(np.cross(cell[j], cell[k]))
        dims.append(max(1, int(width / cutoff)))
    return tuple(min(d, 64) for d in dims)
