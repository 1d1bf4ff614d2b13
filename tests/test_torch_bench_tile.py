"""The ``bench_tile`` plain versions against the JAX tool's arithmetic.

``tools/bench_tile.py`` builds its kernels as closures inside ``main()``,
pinned to TPU memory, so the test copies their arithmetic (``:34-90``) into
jnp: the ones-block T, the group sum and the four formulations (d: per
slice; a: ``jnp.repeat``; b: broadcast + concatenate; c: ``dot_general``
with T). The same numpy inputs go through them and through the port's plain
versions, within 1e-5 max|ref|; T must equal the tool's exactly. The CUDA
kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.tools import bench_tile

torch.set_num_threads(2)
E = 96
B, mul, d1 = 32, 32, 5          # B: rows of the copied kernel blocks
W = mul * d1
reps = 8


def _jax_T():
    Tm = np.zeros((d1, W), np.float32)                      # :34-36
    for m in range(d1):
        Tm[m, m * mul:(m + 1) * mul] = 1.0
    return Tm


def _groupsum(prod):
    acc = prod[:, 0:mul]
    for m in range(1, d1):
        acc = acc + prod[:, m * mul:(m + 1) * mul]
    return acc


def _kern_a(x, s, t):
    acc = None
    for r in range(reps):
        st = jnp.repeat(s * (1.0 + r), mul, axis=1)
        g = _groupsum(x * st)
        acc = g if acc is None else acc + g
    return acc


def _kern_b(x, s, t):
    acc = None
    for r in range(reps):
        st = jnp.concatenate([
            jnp.broadcast_to(s[:, m:m + 1] * (1.0 + r), (x.shape[0], mul))
            for m in range(d1)
        ], axis=1)
        g = _groupsum(x * st)
        acc = g if acc is None else acc + g
    return acc


def _kern_c(x, s, t):
    acc = None
    for r in range(reps):
        st = jax.lax.dot_general(
            s * (1.0 + r), t, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        g = _groupsum(x * st)
        acc = g if acc is None else acc + g
    return acc


def _kern_d(x, s, t):
    acc = None
    for r in range(reps):
        g = None
        for m in range(d1):
            tt = x[:, m * mul:(m + 1) * mul] * (s[:, m:m + 1] * (1.0 + r))
            g = tt if g is None else g + tt
        acc = g if acc is None else acc + g
    return acc


JAX = {'d:per-slice': _kern_d, 'a:repeat': _kern_a, 'b:bcast+cat': _kern_b,
       'c:mxu-tile': _kern_c}


def _jax(variant, x, s):
    """The kernel on each block of B rows, as the grid runs it."""
    f = jax.jit(JAX[variant])
    t = jnp.asarray(_jax_T())
    return np.concatenate([np.asarray(f(jnp.asarray(x[i:i + B]),
                                        jnp.asarray(s[i:i + B]), t))
                           for i in range(0, x.shape[0], B)])


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(E, W)).astype(np.float32),
            rng.normal(size=(E, d1)).astype(np.float32))


def test_constants_and_ones_block_equal_the_tool():
    assert (bench_tile.MUL, bench_tile.D1, bench_tile.W, bench_tile.REPS,
            bench_tile.B) == (mul, d1, W, reps, 256)
    T = bench_tile.ones_block()
    assert T.dtype == np.float32 and np.array_equal(T, _jax_T())


@pytest.mark.parametrize('variant', bench_tile.VARIANTS)
def test_plain_matches_the_jax_arithmetic(variant):
    x, s = _inputs()
    ref = _jax(variant, x, s)
    got = bench_tile.forward(variant, torch.tensor(x), torch.tensor(s))
    assert tuple(got.shape) == (E, mul)
    # fp32 at outputs up to ~150, where one ulp is 1.5e-5: XLA contracts
    # the products into FMAs, PyTorch rounds each
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # and every formulation is the per-slice one within the tool's 1e-3
    np.testing.assert_allclose(got.numpy(), _jax('d:per-slice', x, s),
                               rtol=0, atol=1e-3)


def test_c_reads_the_given_block():
    """c multiplies by T, it does not assume it: another block gives
    another result (on the card T is read from device memory)."""
    x, s = (torch.tensor(a) for a in _inputs(4))
    T = torch.tensor(bench_tile.ones_block())
    base = bench_tile.forward('c:mxu-tile', x, s, T)
    T2 = T.clone()
    T2[0, 0] = 2.0
    other = bench_tile.forward('c:mxu-tile', x, s, T2)
    assert torch.equal(other[:, 1:], base[:, 1:])
    assert (other[:, 0] - base[:, 0]).abs().max() > 1e-3


def test_library_is_one_pass():
    x, s = (torch.tensor(a) for a in _inputs(5))
    lib = bench_tile.library(x, s)
    ref = bench_tile.plain('d:per-slice', x, s)
    # sum_r (1 + r) = 36 passes' worth of the r = 0 pass
    np.testing.assert_allclose((36.0 * lib).numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


def test_cost_is_bound_by_bytes_but_c_formulation():
    flops, nbytes = bench_tile.cost(32768)
    assert nbytes == 4.0 * 32768 * (160 + 5 + 32)
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0077
    assert flops == 2.0 * 8 * 5 * 32 * 32768
    assert flops / 67e12 < nbytes / 3.35e12
    fc = bench_tile.formulation_flops('c:mxu-tile', 32768)
    assert fc - flops == 2.0 * 8 * 5 * 160 * 32768       # 210 M FMA
    assert bench_tile.formulation_flops('a:repeat', 32768) == flops
    # the rotating copies exceed the 50 MB L2
    assert bench_tile.COPIES * nbytes > 50e6 and bench_tile.COPIES >= 3


def test_rotating_copies():
    x, s = bench_tile.make_inputs(8, 'cpu')
    copies = bench_tile.input_copies(x, s)
    assert len(copies) == bench_tile.COPIES
    assert all(c[0].data_ptr() != x.data_ptr() for c in copies)
    seen = []
    f = bench_tile.rotate(lambda xi, si: seen.append(xi.data_ptr()), copies)
    for _ in range(2 * len(copies)):
        f()
    assert seen == [c[0].data_ptr() for c in copies] * 2
