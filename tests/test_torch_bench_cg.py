"""The ``bench_cg`` tables and plain versions against the JAX package.

C (5, 25) and T (25, 800) must equal the tables ``tools/bench_cg.py:59-69``
builds from the JAX ``wigner_3j(2, 2, 2)``, and the three plain
formulations must equal a per-term jnp computation of the instruction
within 1e-5, on numpy inputs at small E. The CUDA kernels are held against
these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu.ops.wigner import wigner_3j as jax_wigner_3j
from sevennet_exp_tpu_torch.tools import bench_cg

torch.set_num_threads(2)
E = 96


def _jax_nz():
    w3j = np.asarray(jax_wigner_3j(2, 2, 2))
    return [(m, n, p, float(w3j[m, n, p]))
            for m in range(5) for n in range(5) for p in range(5)
            if abs(w3j[m, n, p]) > 1e-12]


def _jax_tables():
    mul, d1, d2, d3 = 32, 5, 5, 5
    W = mul * d1
    C = np.zeros((d2, d1 * d3), np.float32)
    for (m, n, p, c) in _jax_nz():
        C[n, m * d3 + p] = c
    T = np.zeros((d1 * d3, d3 * W), np.float32)
    for m in range(d1):
        for p in range(d3):
            T[m * d3 + p, p * W + m * mul:p * W + (m + 1) * mul] = 1.0
    return C, T


def test_terms_and_tables_equal_jax():
    assert [t[:3] for t in bench_cg.terms()] == [t[:3] for t in _jax_nz()]
    np.testing.assert_allclose([t[3] for t in bench_cg.terms()],
                               [t[3] for t in _jax_nz()], rtol=0, atol=1e-7)
    for got, ref in zip(bench_cg.tables(), _jax_tables()):
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)


def _jax_per_term(x, y):
    x, y = jnp.asarray(x), jnp.asarray(y)
    out = [jnp.zeros((x.shape[0], 32), jnp.float32) for _ in range(5)]
    for (m, n, p, c) in _jax_nz():
        out[p] = out[p] + c * x[:, m * 32:(m + 1) * 32] * y[:, n:n + 1]
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize('variant', bench_cg.VARIANTS)
def test_plain_matches_jax_per_term(variant):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(E, 160)).astype(np.float32)
    y = rng.normal(size=(E, 5)).astype(np.float32)
    got = bench_cg.forward(variant, torch.tensor(x), torch.tensor(y))
    assert tuple(got.shape) == (E, 160)
    np.testing.assert_allclose(got.numpy(), _jax_per_term(x, y), rtol=0,
                               atol=1e-5)


def test_cost_is_bound_by_bytes_but_c():
    """The bound is the function's, the same for a, b and c: bound by
    bytes. Only c's own formulation (the dense S @ T tiling) would be
    bound by operations; it is printed beside the bound, not in it."""
    flops, nbytes = bench_cg.cost(32768)
    assert nbytes == 4.0 * 32768 * (160 + 5 + 160)
    assert flops == 32768 * 3.0 * 25 * 32
    assert flops / 67e12 < nbytes / 3.35e12
    for variant in bench_cg.VARIANTS:
        f = bench_cg.formulation_flops(variant, 32768)
        assert (f / 67e12 > nbytes / 3.35e12) == (variant == 'c:full-width')


def test_library_einsum_matches_jax_per_term():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(E, 160)).astype(np.float32)
    y = rng.normal(size=(E, 5)).astype(np.float32)
    got = bench_cg.library(torch.tensor(x), torch.tensor(y))
    assert tuple(got.shape) == (E, 160)
    np.testing.assert_allclose(got.numpy(), _jax_per_term(x, y), rtol=0,
                               atol=1e-5)
