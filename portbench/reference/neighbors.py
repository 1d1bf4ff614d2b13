"""Pairs inside a cutoff in a periodic cell, under the minimum image, on
any device: a cell list when every axis holds three bins or more, else
all pairs. Needs every cell width >= 2 * cutoff."""

from __future__ import annotations

import itertools

import torch

ATOM_BLOCK = 8192


def _widths(cell: torch.Tensor) -> torch.Tensor:
    vol = torch.abs(torch.linalg.det(cell))
    return torch.stack([vol / torch.linalg.norm(
        torch.linalg.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        for i in range(3)])


def edge_list(pos: torch.Tensor, cell: torch.Tensor, cutoff: float):
    """(dst, src, shift): every ordered pair i != j with |r_ij| < cutoff,
    r_ij = pos[src] - pos[dst] + shift the minimum image; sorted by dst.
    The search runs, and ``shift`` is, in float64."""
    dev = pos.device
    p = pos.detach().double()
    c = cell.detach().double().to(dev)
    inv = torch.linalg.inv(c)
    widths = _widths(c)
    if bool(torch.any(widths < 2 * cutoff)):
        raise ValueError('cell narrower than twice the cutoff')
    n = p.shape[0]
    g = torch.floor(widths / cutoff).long().clamp(min=1)
    frac = torch.remainder(p @ inv, 1.0)
    if bool(torch.all(g >= 3)):
        b = torch.minimum((frac * g).long(), g - 1)
        cid = (b[:, 0] * g[1] + b[:, 1]) * g[2] + b[:, 2]
        n_cells = int(torch.prod(g))
        order = torch.argsort(cid, stable=True)
        counts = torch.bincount(cid, minlength=n_cells)
        starts = torch.cumsum(counts, 0) - counts
        cap = int(counts.max())
        table = torch.full((n_cells, cap), -1, dtype=torch.long, device=dev)
        cs = cid[order]
        table[cs, torch.arange(n, device=dev) - starts[cs]] = order
        offs = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                            device=dev)

        def candidates(i0, i1):
            nb = torch.remainder(b[i0:i1, None, :] + offs[None], g)
            ncid = (nb[..., 0] * g[1] + nb[..., 1]) * g[2] + nb[..., 2]
            return table[ncid].reshape(i1 - i0, -1)
    else:
        every = torch.arange(n, device=dev)

        def candidates(i0, i1):
            return every[None].expand(i1 - i0, n)

    dst, src, shift = [], [], []
    for i0 in range(0, n, ATOM_BLOCK):
        i1 = min(n, i0 + ATOM_BLOCK)
        cand = candidates(i0, i1)
        ii = torch.arange(i0, i1, device=dev)[:, None].expand_as(cand)
        ok = (cand >= 0) & (cand != ii)
        ii, jj = ii[ok], cand[ok]
        d = p[jj] - p[ii]
        s = -torch.round(d @ inv) @ c
        dm = d + s
        keep = torch.sum(dm * dm, dim=-1) < cutoff * cutoff
        dst.append(ii[keep])
        src.append(jj[keep])
        shift.append(s[keep])
    return (torch.cat(dst), torch.cat(src), torch.cat(shift))
