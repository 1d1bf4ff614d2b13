"""Dense-grid gathers with scatter-free backwards, in torch.

Counterpart of ``sevennet_exp_tpu/ops/scatter.py`` (``scatter_sum``,
``gather_rev``, ``gather_pair``, ``reverse_permutation`` and the half-list
helpers ``half_pair_indices``, ``half_gather``, ``pair_spread``). The MD edge
lists follow the dense neighbor-grid contract: row ``i*D + k`` holds atom
i's k-th incident edge, pad rows are masked self-edges, and ``rev[e]`` is
the row of the reverse edge. Then aggregation by destination is a static
``reshape(N, D, F).sum(1)`` and the transpose of a gather by source is a
gather by ``rev`` followed by that same reduction -- no scatter-add in
either direction.

Off the grid (the calculator's plain edge list) ``scatter_sum`` without
``dense_d`` is an ``index_add_`` and ``x[edge_src]`` a plain gather whose
backward autograd scatters. On CUDA ``index_add_`` adds by atomics in no
fixed order, so such sums differ from run to run in the last bits.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def scatter_sum(src: Tensor, index: Tensor, num_segments: int,
                dense_d: Optional[int] = None) -> Tensor:
    """Sum src rows into ``num_segments`` buckets by index (first axis).

    dense_d: rows follow the dense-grid contract (row ``i*dense_d + k``
    belongs to segment i, index is ignored) -- a reshape + sum.
    """
    if dense_d is not None:
        body = src[:num_segments * dense_d]
        return body.reshape((num_segments, dense_d) + src.shape[1:]).sum(1)
    out = src.new_zeros((num_segments,) + src.shape[1:])
    return out.index_add_(0, index, src)


def _dense_rev_sum(ct: Tensor, rev: Tensor, n: int, dense_d: int) -> Tensor:
    """sum over v's grid rows of ct[rev]: the transpose of ``x[src]``."""
    return scatter_sum(ct[rev], None, n, dense_d=dense_d)


class _GatherRev(torch.autograd.Function):
    """x[src] whose backward is the rev-gather reshape-reduction."""

    @staticmethod
    def forward(ctx, x, src, rev, dense_d):
        ctx.save_for_backward(rev)
        ctx.n = x.shape[0]
        ctx.dense_d = dense_d
        return x[src]

    @staticmethod
    def backward(ctx, ct):
        (rev,) = ctx.saved_tensors
        return _dense_rev_sum(ct, rev, ctx.n, ctx.dense_d), None, None, None


def gather_rev(x: Tensor, src: Tensor, rev: Tensor, dense_d: int) -> Tensor:
    """x[src] with a scatter-free backward on the dense grid:

        dx[v] = sum_{e: src[e]=v} g[e] = sum_{e in v's rows} g[rev[e]]
    """
    return _GatherRev.apply(x, src, rev, dense_d)


class _GatherPair(torch.autograd.Function):
    """(pos[dst], pos[src]) whose backward aggregates by destination."""

    @staticmethod
    def forward(ctx, pos, dst, src, rev, dense_d):
        ctx.save_for_backward(rev)
        ctx.n = pos.shape[0]
        ctx.dense_d = dense_d
        return pos[dst], pos[src]

    @staticmethod
    def backward(ctx, ct_i, ct_j):
        (rev,) = ctx.saved_tensors
        n, d = ctx.n, ctx.dense_d
        grad = scatter_sum(ct_i, None, n, dense_d=d)
        grad = grad + _dense_rev_sum(ct_j, rev, n, d)
        return grad, None, None, None, None


def gather_pair(pos: Tensor, edge_idx: Tensor, rev: Tensor, dense_d: int):
    """(pos[dst], pos[src]) with scatter-free backwards (dense grid)."""
    return _GatherPair.apply(pos, edge_idx[0], edge_idx[1], rev, dense_d)


def reverse_permutation(edge_idx: Tensor, n_nodes: int) -> Tensor:
    """rev[e] = index of the reverse edge (dst[e], src[e]).

    Requires a symmetric list over ``n_nodes`` atoms; pad edges must be
    self-edges (i, i). Stable sorts by (src, dst) and by (dst, src) pair
    the e-th entries as mutual reverses.
    """
    dst, src = edge_idx[0].long(), edge_idx[1].long()
    n = max(int(n_nodes), 1)
    a = torch.argsort(src * n + dst, stable=True)   # primary src, then dst
    b = torch.argsort(dst * n + src, stable=True)   # primary dst, then src
    rev = torch.empty_like(a)
    rev[a] = b
    return rev


def half_pair_indices(rev: Tensor):
    """Static-shape half list over a symmetric edge list, built without a
    host synchronisation (cumulative sum and gathers at the static sizes;
    no ``nonzero``).

    Contract (``md/engine.py::_compact_nl``): real edges pair
    (e, rev[e]) with rev[e] != e; pad rows are self-edges and fixed points
    of ``rev``, so exactly n_real/2 <= E//2 rows satisfy e < rev[e].
    Returns

      half (E//2,) -- the representative edge of each pair, ascending;
          the unused tail holds the sentinel E;
      pair (E,) -- position of each edge's representative in ``half``.
          Pad rows keep pair = 0: their mask scale is 0, so the weight
          row they read multiplies to zero forward and backward.
    """
    e_cap = rev.shape[0]
    n_half = e_cap // 2
    iota = torch.arange(e_cap, dtype=rev.dtype, device=rev.device)
    is_rep = iota < rev
    pos = torch.cumsum(is_rep.to(rev.dtype), 0) - 1   # a representative's slot
    # representatives write their own slot, every other row the spare last
    # slot, which is cut off
    slot = torch.where(is_rep, pos, torch.full_like(pos, n_half))
    half = torch.full((n_half + 1,), e_cap, dtype=rev.dtype,
                      device=rev.device)
    half[torch.clamp(slot, max=n_half)] = torch.where(
        is_rep, iota, torch.full_like(iota, e_cap))
    half = half[:n_half]
    pair = torch.where(is_rep, pos, torch.where(
        rev < iota, pos[rev], torch.zeros_like(pos)))
    return half, pair


class _HalfGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, half, pair):
        ctx.save_for_backward(half, pair)
        return rows[torch.clamp(half, max=pair.shape[0] - 1)]

    @staticmethod
    def backward(ctx, ct):
        half, pair = ctx.saved_tensors
        e_cap = pair.shape[0]
        iota = torch.arange(e_cap, dtype=half.dtype, device=half.device)
        is_rep = torch.clamp(half, max=e_cap - 1)[pair] == iota
        return (torch.where(is_rep[:, None], ct[pair],
                            torch.zeros_like(ct[:1])), None, None)


def half_gather(rows: Tensor, half: Tensor, pair: Tensor) -> Tensor:
    """(E, W) per-edge rows -> (E//2, W) representative rows, with a
    scatter-free backward: the cotangent of edge e is its pair's cotangent
    if e is the representative (half[pair[e]] == e), else zero -- a
    gather and a mask, where a plain ``rows[half]`` would scatter-add into
    the (E, W) input on every force backward."""
    return _HalfGather.apply(rows, half, pair)


class _PairSpread(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_half, pair, half, rev):
        ctx.save_for_backward(pair, half, rev)
        return w_half[pair]

    @staticmethod
    def backward(ctx, ct):
        pair, half, rev = ctx.saved_tensors
        e_cap = pair.shape[0]
        hs = torch.clamp(half, max=e_cap - 1)
        d = ct[hs] + ct[rev[hs]]
        return (torch.where((half < e_cap)[:, None], d,
                            torch.zeros_like(d[:1])), None, None, None)


def pair_spread(w_half: Tensor, pair: Tensor, half: Tensor,
                rev: Tensor) -> Tensor:
    """(E//2, W) per-pair rows -> (E, W) per-edge rows by the pair index,
    with a scatter-free backward: a half row's cotangent is the sum of its
    two directed edges' cotangents, both plain gathers."""
    return _PairSpread.apply(w_half, pair, half, rev)
