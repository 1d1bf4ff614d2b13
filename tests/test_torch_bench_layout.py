"""The ``bench_layout`` plain versions against the JAX tool's own Pallas
kernels, run in interpret mode on the CPU.

``tools/bench_layout.py`` is loaded by path; ``BENCH_LAYOUT_INTERPRET=1``
makes its ``build`` interpret the kernels, and its ``GRID`` is cut to 2
blocks (512 edge rows), so each kernel runs in about a second here. The same
numpy inputs go through the three Pallas kernels (row-major, col-major on
the tool's feature-major layout ``x.T.reshape(GRID * D, B)``, in-kernel
transpose) and through the port's plain versions, within 1e-5 max|ref|:
the JAX kernels add the 24 passes one by one, the plain versions take 24
times one pass. The CUDA kernels are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.tools import bench_layout

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = 2


@pytest.fixture
def tool(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        'jax_bench_layout', os.path.join(ROOT, 'tools', 'bench_layout.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setenv('BENCH_LAYOUT_INTERPRET', '1')
    monkeypatch.setattr(mod, 'GRID', GRID)
    return mod


def _inputs():
    x, y = bench_layout.make_inputs('cpu', grid=GRID, seed=5)
    return x.numpy(), y.numpy()


def test_constants_equal_the_tool(tool):
    for name in ('B', 'MUL', 'NSLICE', 'R'):
        assert getattr(bench_layout, name) == getattr(tool, name), name
    assert bench_layout.GRID == 128 and bench_layout.D == 512
    assert bench_layout.macs() == 128 * 256 * 512 * 24


def test_colmajor_inputs_equal_the_tools_layout(tool):
    x, _ = _inputs()
    got = bench_layout.colmajor_inputs(torch.tensor(x)).numpy()
    want = x.T.reshape(GRID * tool.MUL * tool.NSLICE, tool.B)  # :92-93
    assert got.shape == want.shape
    assert np.array_equal(got, want)
    # not a transpose per block: block 0's rows are features 0..3 of all
    # 512 edges, 256 at a time
    assert np.array_equal(got[:2, :], x[:, 0].reshape(2, 256))


def _pallas(tool, variant, x, y):
    B, MUL, D = tool.B, tool.MUL, tool.MUL * tool.NSLICE
    if variant == 'colmajor':
        f = tool.build(tool.colmajor_kernel, (GRID * D, B), (GRID * MUL, B),
                       (D, B), (MUL, B))
    else:
        kern = (tool.rowmajor_kernel if variant == 'rowmajor'
                else tool.transpose_kernel)
        f = tool.build(kern, (GRID * B, D), (GRID * B, MUL), (B, D),
                       (B, MUL))
    return np.asarray(f(x, y))


@pytest.mark.parametrize('variant', bench_layout.VARIANTS)
def test_plain_matches_the_pallas_kernel(tool, variant):
    x, y = _inputs()
    xv, yv = bench_layout.inputs_for(variant, torch.tensor(x),
                                     torch.tensor(y))
    ref = _pallas(tool, variant, xv.numpy(), yv.numpy())
    got = bench_layout.forward(variant, xv, yv).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_colmajor_is_not_the_blocked_transpose_of_rowmajor():
    """The tool's col-major inputs interleave edges across blocks, so its
    output is another function of x and y than the row-major one."""
    x, y = (torch.tensor(a) for a in _inputs())
    rm = bench_layout.plain('rowmajor', x, y)
    cm = bench_layout.plain('colmajor', *bench_layout.inputs_for(
        'colmajor', x, y))
    blocked = rm.reshape(GRID, 256, 32).transpose(1, 2).reshape(GRID * 32,
                                                                256)
    assert (cm - blocked).abs().max() > 1.0


@pytest.mark.parametrize('variant', bench_layout.VARIANTS)
def test_library_is_one_pass(variant):
    x, y = (torch.tensor(a) for a in _inputs())
    xv, yv = bench_layout.inputs_for(variant, x, y)
    lib = bench_layout.library(variant, xv, yv)
    ref = bench_layout.plain(variant, xv, yv)
    assert torch.allclose(lib * bench_layout.R, ref, rtol=0,
                          atol=1e-5 * float(ref.abs().max()))


def test_cost_is_bound_by_bytes():
    flops, nbytes = bench_layout.cost()
    assert nbytes == 4.0 * (2 * 32768 * 512 + 32768 * 32)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0413
    assert flops == 2.0 * 402653184
    assert flops / 67e12 < nbytes / 3.35e12


def _cu_constants():
    """The transpose kernel's constants, read from csrc/bench_layout.cu."""
    import re
    path = os.path.join(ROOT, 'sevennet_exp_tpu_torch', 'csrc',
                        'bench_layout.cu')
    with open(path) as fh:
        text = fh.read()
    vals = {}
    for name in ('MUL', 'NSLICE', 'R', 'TR', 'PIECE', 'STAGES'):
        (v,) = re.findall(rf'\b{name} = (\d+)[,;]', text)
        vals[name] = int(v)
    return vals


@pytest.mark.parametrize('grid', [132, 5])
def test_transpose_kernel_schedule_replay(grid):
    """Replays csrc/bench_layout.cu's layout_transpose_kernel in numpy on
    E = 32 x 133 rows: block b walks tiles b, b + grid, ...; each tile's
    pieces pass through the ring; thread (warp w, lane) reads row lane,
    channel u = (w + lane) mod 32 of each staged piece (32 distinct banks a
    warp) and writes o_s[lane][u]; every output is written once and the
    result is the plain version's."""
    c = _cu_constants()
    TR, MUL, PW = c['TR'], c['MUL'], c['PIECE'] * c['MUL']
    npiece, stages = c['NSLICE'] // c['PIECE'], c['STAGES']
    assert (MUL, c['NSLICE'], c['R']) == (bench_layout.MUL,
                                          bench_layout.NSLICE, bench_layout.R)
    E = 32 * 133
    x, y = bench_layout.make_inputs('cpu', grid=17, seed=9)
    x, y = x[:E].numpy(), y[:E].numpy()
    out = np.full((E, MUL), np.nan, np.float32)
    n_tiles = E // TR
    lane = np.arange(32)
    for b in range(grid):
        my_tiles = (n_tiles - b + grid - 1) // grid
        ring = np.zeros((stages, 2, TR, PW), np.float32)
        for t in range(my_tiles):
            tile = b + t * grid
            xv = np.zeros((32, 32, c['NSLICE']), np.float32)   # (w, lane, s)
            yv = np.zeros_like(xv)
            for piece in range(npiece):
                j = t * npiece + piece
                rows = slice(tile * TR, tile * TR + TR)
                cols = slice(piece * PW, piece * PW + PW)
                ring[j % stages] = (x[rows, cols], y[rows, cols])
                st = ring[j % stages].reshape(2, TR * PW)
                for w in range(32):
                    u = (w + lane) % MUL
                    for s in range(c['PIECE']):
                        addr = lane * PW + s * MUL + u
                        assert len(set(addr % 32)) == 32       # no conflict
                        xv[w, :, piece * c['PIECE'] + s] = st[0, addr]
                        yv[w, :, piece * c['PIECE'] + s] = st[1, addr]
            for w in range(32):
                u = (w + lane) % MUL
                assert len(set((lane * MUL + u) % 32)) == 32   # o_s write
                r = tile * TR + lane
                assert np.isnan(out[r, u]).all()
                out[r, u] = c['R'] * (xv[w] * yv[w]).sum(1)
    assert not np.isnan(out).any()
    ref = bench_layout.plain('transpose', torch.tensor(x),
                             torch.tensor(y)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
