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


def test_c_formulation_bound():
    """c's tiling product, 25 multiply-adds a lane and pass on top of the
    function's 5, at the fp32 peak: 0.0075 ms at E = 32,768, just under
    the 0.0077 ms of the bytes; the other formulations add nothing."""
    assert round(bench_tile.formulation_bound_ms('c:mxu-tile', 32768),
                 4) == 0.0075
    flops, nbytes = bench_tile.cost(32768)
    assert bench_tile.formulation_bound_ms('c:mxu-tile', 32768) < \
        nbytes / bench_tile.PEAK_BYTES * 1e3
    for v in ('d:per-slice', 'a:repeat', 'b:bcast+cat'):
        assert bench_tile.formulation_bound_ms(v, 32768) == \
            flops / bench_tile.PEAK_FP32 * 1e3


def test_b_shared_memory_floor():
    """b writes the whole tiled row and reads it back in each of its 8
    passes: 2 x 8 x 160 x 4 bytes a row, 0.0100 ms at E = 32,768 on 132
    SMs at 128 bytes a clock and 1.98 GHz, above the 0.0077 ms of the
    bytes b reads and writes in device memory."""
    assert bench_tile.b_shared_bytes(32768) == 2 * 8 * 160 * 4 * 32768
    floor = bench_tile.b_shared_floor_ms(32768)
    assert round(floor, 4) == 0.0100
    assert floor > bench_tile.cost(32768)[1] / bench_tile.PEAK_BYTES * 1e3


def test_b_staging_writes_the_tiled_row_without_bank_conflicts():
    """csrc/bench_tile.cu::tile_b_kernel's staging, replayed: in pass r
    lane u writes columns 4 u .. 4 u + 3 (one 16-byte store of s[u / 8]
    (1 + r)) and column 128 + u (s[4] (1 + r)) of its warp's staging row
    r & 1, then reads columns 32 m + u. The row is the broadcast +
    concatenate tile, every column written once, and each access of the
    warp is conflict-free (a 16-byte store in four phases of 8 lanes)."""
    rng = np.random.default_rng(6)
    s = rng.normal(size=d1).astype(np.float32)
    lanes = np.arange(32)
    for r in range(reps):
        row = np.full(W, np.nan, np.float32)
        writes = np.zeros(W, int)
        for u in lanes:
            row[4 * u:4 * u + 4] = s[u // 8] * (1.0 + r)
            writes[4 * u:4 * u + 4] += 1
            row[4 * mul + u] = s[4] * (1.0 + r)
            writes[4 * mul + u] += 1
        assert (writes == 1).all()
        want = np.concatenate([np.full(mul, s[m] * (1.0 + r), np.float32)
                               for m in range(d1)])
        assert np.array_equal(row, want)
        got = np.stack([row[m * mul + lanes] for m in range(d1)])
        assert np.array_equal(got, want.reshape(d1, mul))
    # banks of the words each instruction touches
    for phase in range(4):                     # the 16-byte store
        words = np.concatenate([4 * u + np.arange(4)
                                for u in range(8 * phase, 8 * phase + 8)])
        assert len(set(words % 32)) == 32
    assert len(set((4 * mul + lanes) % 32)) == 32
    for m in range(d1):
        assert len(set((m * mul + lanes) % 32)) == 32
    # two staging rows a warp keep every row 16-byte aligned
    assert (W * 4) % 16 == 0


def test_card_tool_modes_of_c_and_b():
    """``bwd_ab.py --tile-c`` / ``--tile-b`` build an earlier tree's
    bench_tile.cu, ``bwd_passes.py --tile-b`` / ``--tile-c`` stub the
    port's own (an earlier tree's is refused); one kind at a time, and a
    card is needed."""
    from sevennet_exp_tpu_torch.tools import bwd_ab, bwd_passes
    assert bwd_ab.MICRO['tile_c'] == bwd_ab.MICRO['tile_b'] == 'bench_tile.cu'
    assert bwd_ab.main(['csrc', '--tile-c', '--tile-b']) == 2
    assert bwd_passes.main(['--tile-c', '--tile-b']) == 2
    with pytest.raises(ValueError):
        bwd_passes.plan('tile_b', 'other/csrc')
    if not torch.cuda.is_available():
        for kind in ('--tile-c', '--tile-b'):
            assert bwd_ab.main(['csrc', kind]) == 2
            assert bwd_passes.main([kind]) == 2


def _bench_tile_source():
    from sevennet_exp_tpu_torch.ops import cuda_build
    with open(cuda_build.source_path('bench_tile')) as fh:
        return fh.read()


@pytest.mark.parametrize('E', [1, 7, 100, 1003, 32768 + 5])
@pytest.mark.parametrize('grid', [1, 3, 264, 792])
def test_b_and_c_walks_write_every_output_once(E, grid):
    """The persistent walks of csrc/bench_tile.cu, replayed: b's warp w of
    NW = 8 grid writes rows w, w + NW, ... (all 32 channels); c's warp w of
    NW = 4 grid takes row pairs w, w + NW, ..., its lane l row
    2 p + l / 16 (none past E) and channels l % 16 and l % 16 + 16. Every
    output (row, channel) is written exactly once, also with fewer rows
    than warps and an odd E."""
    src = _bench_tile_source()
    for line in ('constexpr int NTC = 128, ROWS_C = NTC / 32;',
                 'long e = (long)blockIdx.x * ROWS + warp;',
                 'long p = (long)blockIdx.x * ROWS_C + (threadIdx.x >> 5);',
                 'const long pairs = (E + 1) / 2;',
                 'const long e = 2 * p + h;'):
        assert line in src
    b = np.zeros((E, mul), int)
    for w in range(8 * grid):
        b[w:E:8 * grid] += 1
    c = np.zeros((E, mul), int)
    lane = np.arange(32)
    for w in range(4 * grid):
        for p in range(w, (E + 1) // 2, 4 * grid):
            e, v = 2 * p + lane // 16, lane % 16
            keep = e < E
            np.add.at(c, (e[keep], v[keep]), 1)
            np.add.at(c, (e[keep], v[keep] + 16), 1)
    assert (b == 1).all() and (c == 1).all()
