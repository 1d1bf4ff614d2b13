"""The ``bench_cgmxu`` tables and plain versions against the JAX package.

For i1 = 1 and 2 of the 7net-0 mid layer, the dense CG operator C and the
per-instruction CT tables must equal those ``tools/bench_cgmxu.py:50-93``
builds from the JAX ``pallas_conv._tp_plan``, and the plain ``st`` and
``outer`` formulations must equal that tool's numpy oracle
(``bench_cgmxu.py:210-227``) computed from the JAX plan, on numpy inputs
at small E. ``dots`` must follow the tool's write pattern. The CUDA kernels
are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu.presets import sevennet_0_config
from sevennet_exp_tpu_torch.tools import bench_cgmxu

torch.set_num_threads(2)
E = 64


@pytest.fixture(scope='module')
def jax_mid_conv():
    model = build_e3_equivariant_model(sevennet_0_config(species=['Na',
                                                                  'Cl']))
    return [lay for _, lay in model.layers
            if isinstance(lay, JL.IrrepsConvolution)][2]


def _jax_class(conv, i1):
    """bench_cgmxu.py:54-93 on the JAX plan: (instrs, f, C, cts)."""
    plan, _ = pallas_conv._tp_plan(conv.tp)
    x_off = conv.tp.irreps_in1.slices()[i1].start
    instrs = [p for p in plan if p['x_off'] == x_off]
    mul, d1 = instrs[0]['mul'], instrs[0]['dim1']
    f = conv.tp.irreps_in2.dim
    d3tot = sum(p['dim3'] for p in instrs)
    C = np.zeros((d3tot, d1 * f), np.float32)
    r = 0
    for p_ins in instrs:
        so = p_ins['sh_off']
        for (m, n, p, c) in p_ins['nz']:
            C[r + p, m * f + so + n] = c
        r += p_ins['dim3']
    cts = []
    for p_ins in instrs:
        W = mul * d1
        ct = np.zeros((p_ins['dim2'], p_ins['dim3'] * W), np.float32)
        for (m, n, p, c) in p_ins['nz']:
            ct[n, p * W + m * mul:p * W + (m + 1) * mul] = c
        cts.append(ct)
    return instrs, f, C, cts


def _jax_oracle(instrs, xTn, shn, wn_):
    """bench_cgmxu.py:210-227 on the JAX plan."""
    mul = instrs[0]['mul']
    wide = sum(p['dim3'] for p in instrs) * mul
    ref = np.zeros((wide, xTn.shape[1]), np.float32)
    row = 0
    for ki, p_ins in enumerate(instrs):
        so = p_ins['sh_off']
        for (m, n, p, c) in p_ins['nz']:
            ref[(row + p) * mul:(row + p + 1) * mul, :] += (
                c * xTn[m * mul:(m + 1) * mul, :]
                * shn[so + n:so + n + 1, :])
        for p in range(p_ins['dim3']):
            ref[(row + p) * mul:(row + p + 1) * mul, :] *= (
                wn_[ki * mul:(ki + 1) * mul, :])
        row += p_ins['dim3']
    return ref


@pytest.mark.parametrize('i1', [1, 2])
def test_tables_equal_jax(jax_mid_conv, i1):
    instrs, f, C, cts = _jax_class(jax_mid_conv, i1)
    cls = bench_cgmxu.cg_class(i1)
    assert cls.f == f and cls.d3s == [p['dim3'] for p in instrs]
    assert [(p['k'], p['sh_off'], p['w_off']) for p in cls.instrs] == \
        [(p['k'], p['sh_off'], p['w_off']) for p in instrs]
    assert sum(len(p['nz']) for p in cls.instrs) == \
        {1: 50, 2: 78}[i1] == np.count_nonzero(C)
    np.testing.assert_allclose(cls.C, C, rtol=0, atol=1e-7)
    for got, ref in zip(cls.cts, cts):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    # the st kernel's table is the CT without its copy per channel
    recs, tab = cls.st_tables()
    W = cls.mul * cls.d1
    for ki, ct in enumerate(cts):
        so, d2, d3, row, off = recs[5 * ki:5 * ki + 5]
        t = tab[off:off + d2 * d3 * cls.d1].reshape(d2, d3, cls.d1)
        for m in range(cls.d1):
            for p in range(d3):
                np.testing.assert_array_equal(
                    ct[:, p * W + m * cls.mul:p * W + (m + 1) * cls.mul],
                    np.repeat(t[:, p, m:m + 1], cls.mul, axis=1))


@pytest.mark.parametrize('mode', ['st', 'outer'])
@pytest.mark.parametrize('i1', [1, 2])
def test_plain_matches_jax_oracle(jax_mid_conv, i1, mode):
    instrs, _, _, _ = _jax_class(jax_mid_conv, i1)
    cls = bench_cgmxu.cg_class(i1)
    rng = np.random.default_rng(i1)
    xT = rng.normal(size=(cls.d1 * cls.mul, E)).astype(np.float32)
    shT = rng.normal(size=(cls.f, E)).astype(np.float32)
    wT = rng.normal(size=(len(cls.instrs) * cls.mul, E)).astype(np.float32)
    ref = _jax_oracle(instrs, xT, shT, wT)
    got = bench_cgmxu.forward(cls, mode, *(torch.tensor(a)
                                           for a in (xT, shT, wT)))
    assert tuple(got.shape) == (cls.wide, E)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(
        bench_cgmxu.oracle(cls, *(torch.tensor(a) for a in (xT, shT, wT)),
                           E), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('i1', [1, 2])
def test_dots_write_pattern(i1):
    cls = bench_cgmxu.cg_class(i1)
    xT, shT, wT = bench_cgmxu.make_inputs(cls, E, 'cpu')
    got = bench_cgmxu.forward(cls, 'dots', xT, shT, wT).numpy()
    x0 = xT[0].numpy().astype(np.float64)
    want = 2.0 * cls.C.astype(np.float64).sum(1)[:, None] * x0[None, :]
    np.testing.assert_allclose(got[:cls.d3tot], want, rtol=0, atol=1e-5)
    assert not got[cls.d3tot:].any()


@pytest.mark.parametrize('i1', [1, 2])
def test_cost_bound(i1):
    """st and outer are bound by bytes (~244 MB per launch at i1 = 1); dots
    reads one x row, so at i1 = 2 its dense product bounds it."""
    cls = bench_cgmxu.cg_class(i1)
    for mode in bench_cgmxu.MODES:
        flops, nbytes = bench_cgmxu.cost(cls, mode, 32768)
        by_ops = flops / 67e12 > nbytes / 3.35e12
        assert by_ops == (mode == 'dots' and i1 == 2)
        if mode != 'dots':
            n_nz = sum(len(p['nz']) for p in cls.instrs)
            assert flops == 32768 * (3.0 * n_nz * cls.mul + cls.wide)
            assert bench_cgmxu.formulation_flops(cls, mode, 32768) > flops
    if i1 == 1:
        assert abs(bench_cgmxu.cost(cls, 'st', 32768)[1] - 244.4e6) < 1e5
