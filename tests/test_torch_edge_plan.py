"""The edge pair of csrc/fused_conv_geom.cu -- kernels 1-2 at agg_d = 0,
the calculator's edge list: one output row per input row, si2 a product
over a tile's rows -- held on the CPU where it cannot run:

  - its launch shape (ops/fused_conv_geom.py, the C entry's arithmetic) on
    the checkpoint's five layers and the tiny config's: the forward's tile
    fitted into two blocks' shared words, TE-row tiles backward;
  - the si2 groups own consecutive live columns, and the forward's w pass
    and CG items cover each group's (column, row) pairs exactly once;
  - the persistent tiles cover every row exactly once (301 rows, a ragged
    last tile, and the 1k calculator's 31,232);
  - the per-group product (row_product): its parts sum every k exactly
    once, its blocks cover every (row, column), the parts' partial sums fit
    the words set aside for them;
  - a numpy replay of the kernels' loop order (tests/test_torch_geom_plan.py
    ``_Replay.forward_edge`` / ``backward_edge``: group by group the w
    pass over its columns, one message per row into the group's message
    tile and the product by parts; gm per row into the dense pair's class
    pass and passes D-F)
    reproduces
    ``FusedConv(..., 0).plain_forward`` / ``plain_backward`` within 1e-5 of
    max|plain|, pad rows exactly zero.

The kernels run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
from test_torch_geom_plan import (  # noqa: F401  (checkpoint_convs: fixture)
    REL, _plan, _Replay, _tiny_plans, checkpoint_convs)

torch.set_num_threads(2)

LAYERS = ['checkpoint:0', 'checkpoint:1', 'checkpoint:2', 'checkpoint:3',
          'checkpoint:4', 'tiny:0', 'tiny:1', 'mul:3']


def _odd_plan(mul):
    """A plan of multiplicity ``mul`` at l <= 3 (3: si2 groups whose sizes
    and offsets are not multiples of 4), random weights."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    from test_torch_geom_plan import _random_weights
    x = Irreps('+'.join(f'{mul}x{l}{"eo"[l % 2]}' for l in range(4)))
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    return (pfc.FusedConv(tp, mlp, si2, 0), *_random_weights(mlp, si2, mul))


def _edge(which, checkpoint_convs):
    if which.startswith('mul:'):
        return _odd_plan(int(which[4:]))
    return _plan(which, checkpoint_convs, 0, geom=False)


@pytest.mark.parametrize('which', LAYERS)
def test_edge_launch_shape_fits_two_blocks_each_way(checkpoint_convs, which):
    conv, _, _ = _edge(which, checkpoint_convs)
    assert pfc.edge_unsupported(conv) is None
    dims = fcg.layer_dims(conv, 0)
    for bwd in (False, True):
        S = fcg.shape(dims, bwd, edge=True)
        assert S.T == (fcg.TE if bwd else fcg.TEF)
        assert S.s in (1, 2) and S.T % (4 * S.s) == 0
        assert S.nap == -(-dims['n_active'] // 4) * 4
        assert S.smem <= fcg.TWO_PER_SM
    # backward: the message cotangent rows, and the products' partial sums
    assert fcg.shape(dims, True, edge=True).smem >= \
        4 * fcg.TE * dims['agg_dim']
    assert fcg.edge_red_words(dims) >= 16
    # forward: two blocks' words, the tile fitted into them
    assert fcg.shape(dims, False, edge=True).smem == fcg.TWO_PER_SM
    F = fcg.edge_fwd_plan(dims, conv.kernel_tables(torch.device('cpu')))
    assert fcg.RB <= F.T <= fcg.TEF and F.T % fcg.RB == 0
    assert F.red_words == F.T * F.nc4 >= 16
    for G in F.groups:
        assert G.nc <= F.nc4 and G.d3 * G.K <= F.slice4
    # pass D's quarters over the live columns
    S = fcg.shape(dims, True, edge=True)
    assert S.cq % 4 == 0 and fcg.QD * S.cq >= dims['n_active']


def test_edge_checkpoint_shared_bytes(checkpoint_convs):
    """The checkpoint's mid layer: the forward's 16-row tiles in two
    blocks' 115,712 shared bytes (w of the
    widest group, 256 columns, and the messages of the largest, 5 x 256
    words a row), 105,408 backward shared bytes; 4,096 and 5,136 words for
    the products' partial sums."""
    dims = dict(D=0, d1=480, nb=8, d_out=576, n_ins=9, n_active=576,
                agg_dim=1920, n_nz=261)
    assert [fcg.shape(dims, b, edge=True).smem for b in (0, 1)] == \
        [115712, 105408]
    conv, _, _ = _edge('checkpoint:1', checkpoint_convs)
    assert fcg.layer_dims(conv, 0) == dims
    F = fcg.edge_fwd_plan(dims, conv.kernel_tables(torch.device('cpu')))
    assert (F.T, F.nc4, F.slice4) == (16, 256, 1280)
    assert [(G.c0, G.nc) for G in F.groups] == [(0, 160), (160, 160),
                                               (320, 256)]
    assert (F.red_words, fcg.edge_red_words(dims)) == (4096, 5136)


@pytest.mark.parametrize('which', LAYERS)
def test_edge_groups_own_consecutive_columns(checkpoint_convs, which):
    """Every live column in exactly one si2 group's range, every
    instruction of a group inside the group's slice: the forward's w pass
    and CG run group by group over them."""
    conv, _, _ = _edge(which, checkpoint_convs)
    t = conv.kernel_tables(torch.device('cpu'))
    groups = fcg.edge_groups(t)
    seen = np.zeros(t.n_active, int)
    for G in groups:
        seen[G.c0:G.c0 + G.nc] += 1
    assert (seen == 1).all()
    col_ins = t.col_ins.numpy()
    ins = t.ins.numpy().reshape(t.n_ins, -1)
    for G in groups:
        for c in range(G.c0, G.c0 + G.nc):
            rec = ins[col_ins[c]]
            # the instruction's block [p][u] lies in the group's slice
            assert G.a0 <= rec[7] and \
                rec[7] + rec[6] * rec[8] <= G.a0 + G.d3 * G.K


@pytest.mark.parametrize('which', ['checkpoint:0', 'checkpoint:1',
                                   'checkpoint:4', 'tiny:1', 'mul:3'])
@pytest.mark.parametrize('rows', [16, 13, 5])
def test_edge_forward_items_cover_every_group_column_and_row_once(
        checkpoint_convs, which, rows):
    """Per group, the forward's w pass (column, row group) items and its
    CG (column, part of the rows) items each cover every (column, row) of
    a tile of ``rows`` live rows exactly once."""
    conv, _, _ = _edge(which, checkpoint_convs)
    dims = fcg.layer_dims(conv, 0)
    F = fcg.edge_fwd_plan(dims, conv.kernel_tables(torch.device('cpu')))
    rows = min(rows, F.T)
    for G in F.groups:
        s = fcg.w_row_groups(G.nc, F.T)
        assert F.T % (4 * s) == 0
        seen = np.zeros((G.nc, F.T), int)
        for items in fcg.column_items(G.nc, F.T, s, rows):
            for lc, e0, e1 in items:
                seen[lc, e0:e1] += 1
        assert (seen[:, :rows] == 1).all() and (seen[:, rows:] == 0).all()
        sp = fcg.cg_parts(G.nc)
        assert G.nc * sp <= max(fcg.NT, G.nc) and F.T % sp == 0
        R = F.T // sp
        seen[:] = 0
        for j in range(G.nc * sp):
            lc, q = j % G.nc, j // G.nc
            seen[lc, q * R:min(q * R + R, rows)] += 1
        assert (seen[:, :rows] == 1).all()


@pytest.mark.parametrize('rows', [301, 31232, 7, 8])
@pytest.mark.parametrize('grid', [264, 37, 1])
@pytest.mark.parametrize('T', [fcg.TE, fcg.TEF, 12])
def test_edge_tiles_cover_every_row_once(rows, grid, T):
    seen = np.zeros(rows, int)
    for tiles in fcg.edge_tiles(rows, grid, T):
        for row0, n in tiles:
            assert row0 % T == 0 and 0 < n <= T
            seen[row0:row0 + n] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize('which', ['checkpoint:0', 'checkpoint:1',
                                   'checkpoint:4', 'tiny:1', 'mul:3'])
def test_edge_products_cover_every_sum_once(checkpoint_convs, which):
    """Both directions' products of every si2 group: each (row, column)
    block owned once, each k of each block summed by exactly one part, the
    parts' partial sums within the words set aside for them."""
    conv, _, _ = _edge(which, checkpoint_convs)
    dims = fcg.layer_dims(conv, 0)
    F = fcg.edge_fwd_plan(dims, conv.kernel_tables(torch.device('cpu')))
    red_b = fcg.edge_red_words(dims)
    for g in conv.groups:
        for T, kred, n, red in ((F.T, g['K'], g['mo'], F.red_words),
                                (fcg.TE, g['mo'], g['K'], red_b)):
            plan = fcg.product_plan(T, g['dim3'], kred, n, red)
            assert T % fcg.RB == 0
            assert plan.items == T * g['dim3'] // fcg.RB * (-(-n // 4))
            assert plan.ks * min(plan.items, fcg.NT) <= fcg.NT
            assert (plan.ks - 1) * plan.items * 4 * fcg.RB <= red
            got = sorted(k for q in range(plan.ks)
                         for k in fcg.product_ks(plan, q, kred))
            assert got == list(range(kred))


def _edge_inputs(conv, rows, seed, tail_pads=0):
    """xg, sh, emb, ms (a fifth of the rows pads, and the last tail_pads
    rows, as the calculator pads its list) and a cotangent per row."""
    rng = np.random.default_rng(seed)
    ms = rng.uniform(0.01, 0.05, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0
    if tail_pads:
        ms[-tail_pads:] = 0.0
    return (rng.normal(size=(rows, conv.d1)).astype(np.float32),
            rng.normal(size=(rows, conv.f)).astype(np.float32),
            rng.normal(size=(rows, conv.nb)).astype(np.float32), ms,
            rng.normal(size=(rows, conv.d_out)).astype(np.float32))


@pytest.mark.parametrize('which,rows,tail', [
    ('checkpoint:0', 43, 0), ('checkpoint:1', 37, 16),
    ('checkpoint:4', 41, 9), ('tiny:0', 29, 0), ('tiny:1', 33, 8),
    ('mul:3', 27, 5), ('mul:4', 19, 0)])
def test_edge_replay_reproduces_plain(checkpoint_convs, which, rows, tail):
    """The replay of the edge pair against plain_forward / plain_backward
    at 1e-5 of max|plain|; a ragged last tile, tiles of pads only, and the
    pad rows' outputs and gradients exactly zero."""
    conv, mlp_ws, si2_ws = _edge(which, checkpoint_convs)
    assert conv.agg_d == 0 and pfc.edge_unsupported(conv) is None
    xg, sh, emb, ms, g = _edge_inputs(conv, rows, len(which) + rows, tail)
    rep = _Replay(conv, 1, mlp_ws, si2_ws, geom=False)
    ins = [torch.tensor(a) for a in (xg, sh, emb, ms)]
    y_p = conv.plain_forward(*ins, mlp_ws, si2_ws).numpy()
    y_r = rep.forward_edge(xg, emb, sh, ms)
    assert y_r.shape == y_p.shape == (rows, conv.d_out)
    np.testing.assert_allclose(y_r, y_p, rtol=0,
                               atol=REL * np.abs(y_p).max())
    pad = ms[:, 0] == 0
    assert pad.any() and np.abs(y_r[pad]).max() == 0
    d_p = conv.plain_backward(torch.tensor(g), *ins, mlp_ws, si2_ws)
    d_r = rep.backward_edge(g, xg, emb, sh, ms)
    for a, b in zip(d_r, d_p):
        b = b.numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())
        assert np.abs(a[pad]).max() == 0


def test_edge_kernels_refuse_plans_they_cannot_hold():
    """The edge pair takes what the dense pair takes; the conv reports the
    rest as its ``kernel_refusal`` when it is built, and the model sends
    such a layer down the plain chain (tests/test_torch_conv_routes.py)."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o')
    sh = Irreps('1x1o+1x0e')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 1, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    si2 = LinearSpec(tp.irreps_out, x)
    conv = pfc.FusedConv(tp, mlp, si2, 0)
    assert 'l2^2' in pfc.edge_unsupported(conv)
    assert conv.kernel_refusal == pfc.edge_unsupported(conv)
    # a plan it takes
    tp, mlp, si2, _ = _tiny_plans()[0]
    assert pfc.edge_unsupported(pfc.FusedConv(tp, mlp, si2, 0)) is None
