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


# -- the launch plans (bench_dot.plan) -------------------------------------
# the kernels cannot run here; the plans, the staged C layout and a walk of
# the planned tiles can

RAGGED = [(1, 1, 128), (33, 17, 384), (127, 129, 256), (128, 8, 128)]
THIN = [s for s in bench_dot.SHAPES if s != (128, 128, 16384)]


@pytest.mark.parametrize('shape', bench_dot.SHAPES)
def test_plan_class_follows_the_bound(shape):
    """The nine thin shapes are bound by bytes and stream; (128, 128,
    16384) is bound by operations and takes the register-blocked tile."""
    p = bench_dot.plan(*shape)
    assert p['cls'] == ('tile' if shape == (128, 128, 16384) else 'stream')
    flops, nbytes, peak = bench_dot.cost(*shape, 'fp32')
    assert (p['cls'] == 'stream') == (nbytes / bench_dot.PEAK_BYTES
                                      >= flops / peak)


@pytest.mark.parametrize('shape,dtype', [(s, 'fp32') for s in THIN]
                         + [(s, 'bf16') for s in bench_dot.SHAPES])
def test_stream_plan_reads_z_once(shape, dtype):
    """A stream block holds all of M for its N tile (one tile per (slice,
    N range), none per M range), pads M by less than a row per thread group
    and K not at all. The bf16 kernel (every shape bound by bytes) holds
    all of M too, in M16 strips, and cuts K only into whole k16 steps."""
    K, M, N = shape
    p = bench_dot.plan(*shape, dtype=dtype)
    assert p['kc'] * (p['nkc'] - 1) < K <= p['kc'] * p['nkc']
    if dtype == 'bf16':
        # persistent: one block an SM on the deep ring where a tile is one
        # or two K chunks of K <= 64, else two on the short ring, walk the
        # tiles
        deep = p['nkc'] <= 2 and K <= 64
        assert deep == (shape not in ((45, 22, 8192), (128, 128, 16384),
                                      (128, 8, 16384)))
        assert p['stages'] == (8 if deep else 4)
        assert p['cls'] == 'bf16' and p['mtiles'] == 1
        assert p['grid'] == ((1 if deep else 2) * bench_dot.N_SM, 1, 1)
        assert p['tiles'] == bench_dot.G * N // p['bn'] and N % p['bn'] == 0
        assert p['mp'] == 16 * p['strips'] >= M > p['mp'] // 2 or \
            p['strips'] == 1
        assert p['strips'] * p['wn'] == bench_dot.WARPS
        assert p['bn'] == p['wn'] * 8 * p['nt8'] and p['nt8'] * 8 >= 32
        assert 16 * p['ks'] >= K and p['ks'] in bench_dot.BF16_KS
        assert p['nkc'] == 1 or p['kc'] % 16 == 0
        assert 4 * p['kc'] * p['bn'] <= bench_dot.BF16_STAGE_BYTES
        # C^T's A fragments and the sums fit a thread's registers
        assert 4 * (p['ks'] + p['nt8']) <= 64
        return
    # persistent: two blocks an SM walk the tiles
    assert p['grid'] == (2 * bench_dot.N_SM, 1, 1)
    assert p['tiles'] == bench_dot.G * N // p['bn'] and N % p['bn'] == 0
    assert p['mp'] == p['tm'] * p['tmg'] >= M and p['mp'] - M < p['tmg']
    assert p['tmg'] * p['bn'] // p['cw'] == p['threads'] == 256
    assert 4 * p['kc'] * p['bn'] <= bench_dot.STAGE_BYTES
    assert p['tm'] in (bench_dot.STREAM_TMS_CW8 if p['cw'] == 8
                       else bench_dot.STREAM_TMS)
    # 8 columns a thread only where the FFMAs near the bytes' time
    assert (p['cw'] == 8) == (shape == (64, 64, 16384))


@pytest.mark.parametrize('dtype', bench_dot.DTYPES)
@pytest.mark.parametrize('shape', list(bench_dot.SHAPES) + RAGGED)
def test_plan_shared_memory_fits(shape, dtype):
    p = bench_dot.plan(*shape, dtype=dtype)
    assert 0 < p['smem'] <= bench_dot.SMEM_BLOCK
    if p['cls'] == 'stream':
        K = shape[0]
        c_len = -(-K * p['tmg'] * bench_dot.tm_pad(p['tm']) // 4) * 4
        assert p['smem'] == 4 * (c_len + p['stages'] * p['kc'] * p['bn'])
    elif p['cls'] == 'bf16':
        # the ring, the warps' staging tiles (8 rows of sw + 8 floats, sw
        # the columns a warp stages at a time), two landed pieces in bf16
        assert p['sw'] == min(8 * p['nt8'], 64)
        assert p['smem'] == 4 * (p['stages'] * p['kc'] * p['bn']
                                 + 8 * 8 * (p['sw'] + 8)) \
            + 2 * 2 * p['kcp'] * (p['bn'] + 8)
        assert p['kcp'] % 16 == 0 and p['kc'] <= p['kcp'] < p['kc'] + 16
        # the short ring fits two blocks an SM
        blocks = 1 if p['stages'] == 8 else 2
        assert blocks * (p['smem'] + bench_dot.SMEM_RESERVED) <= \
            bench_dot.SMEM_SM
    else:
        assert p['smem'] == 4 * bench_dot.TILE_STAGES * 8 * (128 + 128)


@pytest.mark.parametrize('dtype', bench_dot.DTYPES)
@pytest.mark.parametrize('bad', [(27, 20, 200), (27, 20, 64), (27, 20, 0),
                                 (0, 20, 128), (27, 0, 128)])
def test_plan_raises(bad, dtype):
    with pytest.raises(ValueError):
        bench_dot.plan(*bad, dtype=dtype)
    with pytest.raises(ValueError):
        bench_dot.plan(27, 20, 128, 0, dtype=dtype)
    with pytest.raises(ValueError):
        bench_dot.plan(27, 20, 128, dtype='fp16')
    if dtype == 'bf16':
        # C^T is held in registers: K <= 128
        bench_dot.plan(128, 20, 128, dtype=dtype)
        with pytest.raises(ValueError, match='K <= 128'):
            bench_dot.plan(129, 20, 128, dtype=dtype)


@pytest.mark.parametrize('dtype', bench_dot.DTYPES)
@pytest.mark.parametrize('shape', RAGGED + [(45, 22, 256), (64, 64, 256)])
def test_walk_of_the_plan_equals_plain(shape, dtype):
    """The planned tiles, replayed on the CPU with the plan's padding and
    offsets (every tile exactly once), give the plain product; a ragged
    shape of each class and the stream's K chunks (128, 8) and (64, 64).
    bf16: the replay rounds C and Z to bf16 as the kernel does, (127, 129)
    takes two blocks of M, and the last N tile of (33, 17, 384) is half."""
    K, M, N = shape
    rng = np.random.default_rng(K * 7 + M)
    C = torch.tensor(rng.normal(size=(K, M)).astype(np.float32))
    Z = torch.tensor(rng.normal(size=(G, K, N)).astype(np.float32))
    p = bench_dot.plan(K, M, N, G, dtype=dtype)
    if dtype == 'bf16':
        assert p['cls'] == 'bf16'
        assert p['mtiles'] == (2 if shape == (127, 129, 256) else 1)
    else:
        assert p['cls'] == ('tile' if shape == (127, 129, 256) else 'stream')
    got = bench_dot.walk(p, C, Z)
    ref = bench_dot.plain(dtype, C, Z)
    atol = (1e-5 * float(ref.abs().max()) if dtype == 'bf16' else
            1e-5 * K ** 0.5 * float(ref.abs().max()))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=atol)


def test_stream_c_layout():
    """The stream kernel's staged C: thread group mg's rows mg tm .. mg tm
    + tm - 1 of C^T, zero past M and in the vector padding."""
    C = torch.arange(1.0, 1.0 + 5 * 17).reshape(5, 17)
    p = bench_dot.plan(5, 17, 384, 2)
    cs = bench_dot.stream_c(p, C)
    assert tuple(cs.shape) == (5, p['tmg'], bench_dot.tm_pad(p['tm']))
    for mg in range(p['tmg']):
        for i in range(cs.shape[2]):
            m = mg * p['tm'] + i
            want = C[:, m] if i < p['tm'] and m < 17 else torch.zeros(5)
            assert torch.equal(cs[:, mg, i], want)
