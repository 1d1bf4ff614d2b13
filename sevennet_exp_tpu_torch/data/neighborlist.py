"""Host-side neighbor list (numpy + scipy) for single-point graphs.

Counterpart of ``sevennet_exp_tpu/data/neighborlist.py`` (reference
behaviour sevenn/train/dataload.py:32-88): the full directed list of pairs
closer than the cutoff, periodic images included, the zero-shift self pair
excluded; non-periodic directions are open.

Algorithm: replicate the atoms over the integer shifts whose image cell
can reach the home cell within ``cutoff`` (bounded by the plane
distances), then one cKDTree ball query. As in the JAX package,
``neighbor_list`` first asks the native C++ cell list (``data/native.py``:
the same edge set, grouped by center but ordered by cell bin within a
center); ``SEVENN_NO_NATIVE=1`` selects the cKDTree path. ``ROUTE`` counts
the calls by route and names the last one. The MD engine does not use
this: it builds its lists on the device (``md/neighbor.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from .native import native_neighbor_list

# calls by route ('native' or 'ckdtree') and the last route taken
ROUTE = {'last': None, 'native': 0, 'ckdtree': 0}


def _took(route: str):
    ROUTE['last'] = route
    ROUTE[route] += 1


def _n_repeats(cell: np.ndarray, pbc, cutoff: float) -> np.ndarray:
    """Images needed per axis: ceil(cutoff / plane distance)."""
    n = np.zeros(3, dtype=np.int64)
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        assert not any(pbc), 'periodic system with singular cell'
        return n
    for i in range(3):
        if not pbc[i]:
            continue
        j, k = (i + 1) % 3, (i + 2) % 3
        area = np.linalg.norm(np.cross(cell[j], cell[k]))
        n[i] = int(np.ceil(cutoff / (vol / area)))
    return n


def neighbor_list(pos: np.ndarray, cell: np.ndarray, pbc, cutoff: float
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Directed neighbor pairs within cutoff.

    Returns (edge_i, edge_j, edge_vec, shift):
      edge_i: (E,) center atom index, ascending
      edge_j: (E,) neighbor atom index
      edge_vec: (E, 3) = pos[j] + shift @ cell - pos[i]
      shift: (E, 3) integer cell shifts of the neighbor image
    """
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    n = len(pos)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros((0, 3)), np.zeros((0, 3)))
    pbc = [bool(b) for b in np.atleast_1d(pbc).tolist()]
    if len(pbc) == 1:
        pbc = pbc * 3

    res = native_neighbor_list(pos, cell, pbc, cutoff)
    if res is not None:
        _took('native')
        return res
    _took('ckdtree')
    if any(pbc):
        # wrap into the home cell along the periodic axes, so that the
        # image count holds; the vectors are recomputed from pos below
        frac = pos @ np.linalg.inv(cell)
        base_shift = -np.where(pbc, np.floor(frac), 0.0).astype(np.int64)
        pos_wrapped = (frac + base_shift) @ cell
        reps = _n_repeats(cell, pbc, cutoff)
    else:
        base_shift = np.zeros((n, 3), dtype=np.int64)
        pos_wrapped = pos
        reps = np.zeros(3, np.int64)
    rng = [np.arange(-reps[i], reps[i] + 1) for i in range(3)]
    shifts = np.array(np.meshgrid(*rng, indexing='ij')).reshape(3, -1).T

    images = (pos_wrapped[None, :, :]
              + (shifts @ cell)[:, None, :]).reshape(-1, 3)   # (S*N, 3)
    hits = cKDTree(images).query_ball_point(pos_wrapped, cutoff,
                                            return_sorted=True)
    counts = np.fromiter((len(h) for h in hits), dtype=np.int64, count=n)
    edge_i = np.repeat(np.arange(n, dtype=np.int64), counts)
    flat = (np.concatenate([np.asarray(h, dtype=np.int64) for h in hits])
            if counts.sum() else np.zeros(0, np.int64))
    s_idx, edge_j = np.divmod(flat, n)
    shift = shifts[s_idx].reshape(-1, 3)
    not_self = ~((edge_j == edge_i) & ~shift.any(axis=1))
    edge_i, edge_j, shift = edge_i[not_self], edge_j[not_self], shift[not_self]
    shift = shift + base_shift[edge_j] - base_shift[edge_i]
    edge_vec = pos[edge_j] + shift @ cell - pos[edge_i]
    # strict < cutoff; prune hits on the boundary
    keep = np.einsum('ij,ij->i', edge_vec, edge_vec) < cutoff * cutoff
    return edge_i[keep], edge_j[keep], edge_vec[keep], shift[keep]
