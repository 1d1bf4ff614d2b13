"""The plain versions of the ``bench_dot`` kernels against
``jax.lax.dot_general``, as ``tools/bench_dot.py`` calls it per grid step:
C^T Z[g] with fp32 inputs, and with both inputs cast to bf16 and an fp32
result. Same numpy inputs, small N and G, every shape's K and M of the
tool. The CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.tools import bench_dot

torch.set_num_threads(2)
N, G = 256, 3


def _jax_dot(C, Z, dtype):
    c, z = jnp.asarray(C), jnp.asarray(Z)
    if dtype == 'bf16':
        c, z = c.astype(jnp.bfloat16), z.astype(jnp.bfloat16)
    return np.stack([np.asarray(jax.lax.dot_general(
        c, z[g], (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)) for g in range(Z.shape[0])])


@pytest.mark.parametrize('dtype', bench_dot.DTYPES)
@pytest.mark.parametrize('K,M', sorted({(k, m) for k, m, _ in
                                        bench_dot.SHAPES}))
def test_plain_matches_jax_dot_general(K, M, dtype):
    rng = np.random.default_rng(K * 1000 + M)
    C = rng.normal(size=(K, M)).astype(np.float32)
    Z = rng.normal(size=(G, K, N)).astype(np.float32)
    ref = _jax_dot(C, Z, dtype)
    got = bench_dot.forward(dtype, torch.tensor(C), torch.tensor(Z)).numpy()
    assert got.shape == (G, M, N)
    # fp32 sums in another order; bf16 products are exact in fp32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * K * np.abs(ref).max())
    if dtype == 'fp32':
        lib = bench_dot.library(torch.tensor(C), torch.tensor(Z)).numpy()
        np.testing.assert_allclose(lib, ref, rtol=0,
                                   atol=1e-5 * K * np.abs(ref).max())


def test_bf16_rounds_the_inputs():
    """The bf16 version differs from fp32 by the rounding of its inputs,
    not by its sums: equal to the fp32 product of the rounded inputs."""
    rng = np.random.default_rng(1)
    C = rng.normal(size=(27, 20)).astype(np.float32)
    Z = rng.normal(size=(G, 27, N)).astype(np.float32)
    b = bench_dot.plain('bf16', torch.tensor(C), torch.tensor(Z))
    f = bench_dot.plain('fp32', torch.tensor(C), torch.tensor(Z))
    Cr = np.asarray(jnp.asarray(C).astype(jnp.bfloat16).astype(jnp.float32))
    Zr = np.asarray(jnp.asarray(Z).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(b.numpy(), np.einsum('km,gkn->gmn', Cr, Zr),
                               rtol=0, atol=1e-5)
    assert 1e-3 < float((b - f).abs().max()) < 0.2


def test_cost_counts_the_shape():
    flops, nbytes, peak = bench_dot.cost(27, 20, 16384, 'fp32')
    assert flops == 2.0 * 128 * 27 * 20 * 16384 and peak == 67e12
    assert nbytes == 4.0 * (27 * 20 + 128 * (27 + 20) * 16384)
    assert bench_dot.cost(27, 20, 16384, 'bf16')[2] == 989e12
