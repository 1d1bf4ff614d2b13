"""The frozen yardstick equals the program's own arithmetic today: the
conv pairs' operations and bytes at the cells' shapes (the training
cell's edge rows, and the grids of the MD mixes kept for later), and the
node linears' operations; the roofline readers' share is the least time
over the pair's device time."""

import json
import os

import numpy as np
import pytest
import torch
from conftest import ROOT

from portbench.costs import conv as cc
from portbench.costs import model as cm
from portbench.reference.model import build_specs

CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
# (atoms, grid degree, rows a launch, live rows a launch, geometry-fused):
# a training batch's edge rows (16 structures of 64 atoms, ~41 edges an
# atom); the 97k chunk of 524,280 rows and the 8k whole grid, the sizes of
# the NVT mixes kept for later
SHAPES = [(1024, 0, 41984, 41984.0, False),
          (97336, 40, 524280, 419424.0, True),
          (8000, 40, 320000, 240000.0, False)]


@pytest.fixture(scope='module')
def program_model():
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    return SevenNetCheckpoint(CKPT).build_model('cpu')[0]


@pytest.fixture(scope='module')
def specs():
    with open(os.path.join(ROOT, 'portbench', 'configs',
                           'sevennet-0.nacl.json')) as fh:
        return build_specs(json.load(fh)['model'])


@pytest.mark.parametrize('shape', SHAPES, ids=['train-b16', '97k', '8k'])
def test_conv_counts_equal_the_program(program_model, specs, shape):
    from sevennet_exp_tpu_torch.ops.fused_conv import conv_bytes, conv_cost
    _, dd, rows, live, geom = shape
    ms = torch.zeros((rows, 1))
    ms[:int(live)] = 1.0
    mine = cm.conv_shapes(specs, dd)
    for t, shape_t in enumerate(mine):
        conv = program_model.layers[f'{t}_convolution']._conv(dd)
        assert conv.kernel_refusal is None
        f, b, real = conv_cost(conv, ms, geom=geom)
        assert real == live
        assert cc.conv_cost(shape_t, rows, live, geom=geom) == (f, b)
        assert cc.conv_bytes(shape_t, rows, live, geom=geom) == \
            conv_bytes(conv, ms, geom=geom)


def test_node_linears_equal_the_program(program_model, specs):
    n = 1000
    for c in specs['convs']:
        t = c.t
        for mine, name in ((c.sc, f'{t}_self_connection_intro'),
                           (c.si1, f'{t}_self_interaction_1')):
            theirs = program_model.layers[name].spec
            assert mine.paths == theirs.paths
            assert cc.linear_flops(mine, n) == sum(
                2.0 * n * mi * mo * theirs.irreps_in[i].ir.dim
                for i, _, mi, mo, _ in theirs.paths)
    flops = cm.force_call_flops(specs, np.full(n, 26), 32, 0, False)
    assert flops['total'] == (flops['conv'] + flops['nodes']
                              + flops['edges'])
    assert flops['conv'] > flops['nodes'] > 0


def test_chunks_cover_the_grid():
    deg = np.arange(100) % 7
    chunks = cc.chunk_live(deg, 8, 24)
    assert sum(r for r, _ in chunks) == 800
    assert sum(lv for _, lv in chunks) == deg.sum()
    assert cc.chunk_live(deg, 8, 0) == [(800, float(deg.sum()))]


@pytest.mark.parametrize('geom', [False, True])
def test_pair_share_is_the_least_time_over_the_device_time(specs, geom):
    from portbench.costs import peaks
    from portbench.metrics._pair import share
    deg = np.full(1000, 36)
    deg_cap, chunk_rows = 40, (8000 if geom else 0)
    bound = 0.0
    for shape in cm.conv_shapes(specs, deg_cap):
        for rows, live in cc.chunk_live(deg, deg_cap, chunk_rows):
            f = cc.conv_cost(shape, rows, live, geom=geom)
            b = cc.conv_bytes(shape, rows, live, geom=geom)
            bound += sum(cc.roofline_s(f[i], b[i], peaks.FP32_FLOPS,
                                       peaks.HBM_BYTES)[0] for i in (0, 1))
    calls = 7
    launches = calls * len(specs['convs']) * len(
        cc.chunk_live(deg, deg_cap, chunk_rows))
    ctx = {'kind': 'md', 'geom': geom, 'specs': specs, 'degrees': deg,
           'deg_cap': deg_cap, 'chunk_rows': chunk_rows,
           'launches': {'fwd': launches},
           'trace': {'kernel_s': {'k_fwd<0>': 2.0 * bound * calls,
                                  'k_bwd<9, 0>': 2.0 * bound * calls,
                                  'other': 1.0}}}
    got = share(ctx, geom, 'fwd', r'k_fwd<0>', r'k_bwd<\d+, ?0>')
    assert got == pytest.approx(25.0)
    assert share(ctx, not geom, 'fwd', 'k_fwd', 'k_bwd') is None
