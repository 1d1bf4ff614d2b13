"""CUDA kernels of the port against their plain PyTorch versions, on the
card. The kernels have no CPU mode, so off the card every test here
skips. Run on a machine with an NVIDIA GPU (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def model(cuda):
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    return SevenNetCheckpoint(CKPT).build_model(device=cuda)[0]


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_fused_conv_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree)
    mw, sw = cl.weight_nn_p.as_dict(), cl.si2_p.as_dict()
    mlp_ws = tuple(mw[f'w{i}'] for i in range(3))
    si2_ws = tuple(sw[f'w{n}'] for n in range(len(sw)))
    rng = np.random.default_rng(layer)
    n = 37
    rows = n * degree

    def t(*shape, lo=None):
        a = (rng.uniform(0.0, lo, size=shape) if lo
             else rng.normal(size=shape))
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    xg, sh, emb = t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb)
    ms = t(rows, 1, lo=0.05)
    ms[torch.rand(rows, device=cuda) < 0.2] = 0.0
    g = t(n, conv.d_out)
    y_k = conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                         si2_ws),
                    conv.plain_backward(g, xg, sh, emb, ms, mlp_ws,
                                        si2_ws)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


def test_fused_conv_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    conv = FusedConv(tp, mlp, si2, 16)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    n = 11
    rows = n * 16
    xg, shv, emb = t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb)
    ms = torch.full((rows, 1), 0.05, device=cuda)
    g = t(n, conv.d_out)
    y_k = conv.kernel_forward(xg, shv, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, shv, emb, ms, mlp_ws, si2_ws)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(conv.kernel_backward(g, xg, shv, emb, ms, mlp_ws,
                                         si2_ws),
                    conv.plain_backward(g, xg, shv, emb, ms, mlp_ws,
                                        si2_ws)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


def test_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32)
    mw, sw = cl.weight_nn_p.as_dict(), cl.si2_p.as_dict()
    rows = 4 * 32
    xg = torch.randn(rows, conv.d1, device=cuda, requires_grad=True)
    sh = torch.randn(rows, conv.f, device=cuda)
    emb = torch.randn(rows, conv.nb, device=cuda)
    ms = torch.full((rows, 1), 0.04, device=cuda)
    fc.reset_launch_counts()
    out = conv(xg, sh, emb, ms, tuple(mw[f'w{i}'] for i in range(3)),
               tuple(sw[f'w{n}'] for n in range(len(sw))))
    out.sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_fwd'] = want['fused_conv_bwd'] = 1
    assert fc.launch_counts == want


# -- the geometry-fused pair ------------------------------------------------

def _geom_inputs(conv, n, degree, cuda, seed):
    """Edge vectors up to just past the cutoff, with pad rows (ms = 0 and
    the unit vector) and rows inside r_on."""
    rng = np.random.default_rng(seed)
    rows = n * degree
    rc = conv.geom.cutoff

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    u = rng.normal(size=(rows, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = u * rng.uniform(0.3 * rc, 1.02 * rc, size=(rows, 1))
    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    vec[pad] = [1.0, 0.0, 0.0]
    coeffs = np.arange(1, conv.nb + 1) * np.pi / rc
    return (t(rng.normal(size=(rows, conv.d1))), t(vec), t(ms), t(coeffs),
            t(rng.normal(size=(n, conv.d_out))), torch.tensor(pad))


def _assert_geom_kernels_match_plain(conv, args, mlp_ws, si2_ws):
    xg, vec, ms, coeffs, g, pad = args
    y_k = conv.kernel_geom_forward(xg, vec, ms, coeffs, mlp_ws, si2_ws)
    y_p = conv.plain_geom_forward(xg, vec, ms, coeffs, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    d_k = conv.kernel_geom_backward(g, xg, vec, ms, coeffs, mlp_ws, si2_ws)
    d_p = conv.plain_geom_backward(g, xg, vec, ms, coeffs, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    for a, b in zip(d_k, d_p):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad.to(a.device)].abs().max() == 0     # pad rows: zeros


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_geom_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, geom=cl.geom)
    mlp_ws, si2_ws = cl._weights()
    _assert_geom_kernels_match_plain(
        conv, _geom_inputs(conv, 37, degree, cuda, layer), mlp_ws, si2_ws)


@pytest.mark.parametrize('kind', ['poly', 'xplor'])
@pytest.mark.parametrize('lmax', [1, 2, 3])
def test_geom_kernels_random_plans(cuda, kind, lmax):
    """Multiplicity 4 (not a multiple of a warp), l up to 3, both
    envelopes, 10 Bessel functions."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv, GeomSpec
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('+'.join(f'4x{l}{"eo"[l % 2]}' for l in range(lmax + 1)))
    sh = Irreps.spherical_harmonics(lmax, -1)
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, lmax, 'full'))
    nb = 10
    mlp = FullyConnectedNetSpec((nb, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    geom = GeomSpec(cutoff=4.0, num_basis=nb, lmax=lmax, cutoff_kind=kind,
                    cutoff_p=6.0, cutoff_on=3.5 if kind == 'xplor' else 0.0)
    conv = FusedConv(tp, mlp, si2, 16, geom=geom)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    _assert_geom_kernels_match_plain(
        conv, _geom_inputs(conv, 11, 16, cuda, lmax), mlp_ws, si2_ws)


def test_geom_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, geom=cl.geom)
    xg, vec, ms, coeffs, _, _ = _geom_inputs(conv, 4, 32, cuda, 0)
    xg.requires_grad_(True)
    vec.requires_grad_(True)
    fc.reset_launch_counts()
    out = conv.apply_geom(xg, vec, ms, coeffs, *cl._weights())
    out.sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_geom_fwd'] = want['fused_conv_geom_bwd'] = 1
    assert fc.launch_counts == want
    assert xg.grad is not None and vec.grad is not None


def test_geom_kernels_match_plain_at_97k_chunk_shape(cuda, model):
    """Checkpoint layer 1 at the 97k leg's shapes: one full chunk (16,384
    atoms x 32 rows) and the 40-atom remainder chunk, with pad rows."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers['1_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, geom=cl.geom)
    mlp_ws, si2_ws = cl._weights()
    for n_atoms in (16384, 40):
        _assert_geom_kernels_match_plain(
            conv, _geom_inputs(conv, n_atoms, 32, cuda, n_atoms), mlp_ws,
            si2_ws)
        torch.cuda.empty_cache()


def test_geom_launch_shape_matches_python_mirror(cuda, model):
    """The C entry's tile, row groups and shared bytes are those of
    ops/fused_conv_geom.py (which the CPU tests hold)."""
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    for layer in (0, 1, 4):
        cl = model.layers[f'{layer}_convolution']
        for D in (16, 32, 40, 6):
            conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, D, geom=cl.geom)
            dims = fcg.layer_dims(conv, D)
            for bwd in (False, True):
                assert fcg.kernel_shape(dims, bwd) == fcg.shape(dims, bwd)


def test_geom_kernels_sass_fp32_cuda_cores_no_local_memory(cuda):
    """Rows 5-6: FFMA on the CUDA cores, no tensor-core opcode, nothing in
    local memory (no spill, no stack array), in every instance."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = {k: v for k, v in sass_compare.count('fused_conv_geom').items()
              if 'fused_conv_geom_' in k}
    assert len(counts) == 4          # forward, backward at 4, 9, 16 SH
    for k, v in counts.items():
        assert v['FFMA'] > 0, k
        for op in (*sass_compare.TENSOR_CORE_OPS, *sass_compare.LOCAL_OPS):
            assert v[op] == 0, (k, op, v[op])


# SASS digests (tools/sass_compare.digests) of the conv kernels whose code
# the geometry-fused redesign did not touch, from a build of the parent
# tree's csrc/fused_conv.cu and csrc/bench_pieces.cu with the same nvcc on
# the card machine
PARENT_SASS = {
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b21fused_conv_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_NS_4PlanEPfS3_S3_':
        '6774671276e0',
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b21fused_conv_fwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        '9363ad0df108',
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b26fused_conv_edge_bwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_S1_S1_S1_NS_4PlanEPfS3_S3_':
        '4de88c67043a',
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b26fused_conv_edge_fwd_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        'd22176e6071b',
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b26fused_conv_extw_bwd_kernelEPKfS1_S1_S1_S1_NS_4PlanEPKiiPfS5_S5_':
        '18e133ee3965',
    '_ZN46_GLOBAL__N__13_fused_conv_cu_97ac331b26fused_conv_extw_fwd_kernelEPKfS1_S1_S1_NS_4PlanEPf':
        '126d4c70bb14',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd423bench_pieces_now_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        'd18e332ac461',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd424bench_pieces_full_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        '9363ad0df108',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd424bench_pieces_nocg_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        'eb3b90fec497',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd425bench_pieces_noagg_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        'd22176e6071b',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd425bench_pieces_nomlp_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        '54b06e6b7930',
    '_ZN48_GLOBAL__N__15_bench_pieces_cu_2586ebd425bench_pieces_nosi2_kernelEPKfS1_S1_S1_S1_S1_S1_S1_NS_4PlanEPf':
        'a75cad855539',
}


def test_untouched_conv_kernels_sass_identical_to_parent(cuda):
    """Kernels 1-2, their edge-row forms, 7-8 and bench_pieces compile to
    the SASS of the tree before the geometry-fused kernels left
    fused_conv_body.cuh."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {}
    for name in ('fused_conv', 'bench_pieces'):
        got.update(sass_compare.digests(name))
    assert set(got) == set(PARENT_SASS)
    assert got == PARENT_SASS


# -- the external-weight pair ------------------------------------------------

def _extw_inputs(conv, n, degree, cuda, seed, mlp_ws=None):
    """xg, sh, weff = MLP(emb) * ms with pad rows (ms = 0, so weff rows
    of zeros), and a node cotangent."""
    rng = np.random.default_rng(seed)
    rows = n * degree

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    emb = t(rng.normal(size=(rows, conv.nb)))
    if mlp_ws is None:
        weff = t(rng.normal(size=(rows, conv.w_numel))) * t(ms)
    else:
        weff = conv.mlp.apply({f'w{i}': w for i, w in enumerate(mlp_ws)},
                              emb) * t(ms)
    return (t(rng.normal(size=(rows, conv.d1))),
            t(rng.normal(size=(rows, conv.f))), weff.contiguous(),
            t(rng.normal(size=(n, conv.d_out))),
            torch.tensor(pad, device=cuda))


def _assert_extw_kernels_match_plain(conv, args, si2_ws):
    xg, sh, weff, g, pad = args
    y_k = conv.kernel_extw_forward(xg, sh, weff, si2_ws)
    y_p = conv.plain_extw_forward(xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    d_k = conv.kernel_extw_backward(g, xg, sh, weff, si2_ws)
    d_p = conv.plain_extw_backward(g, xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    for a, b in zip(d_k, d_p):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad].abs().max() == 0                   # pad rows: zeros
    t = conv.kernel_tables(xg.device)
    if t.n_dead:                    # columns no instruction reads: zeros
        assert d_k[2][:, t.dead_w.long()].abs().max() == 0


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_extw_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, ext_w=True)
    mlp_ws, si2_ws = cl._weights()
    _assert_extw_kernels_match_plain(
        conv, _extw_inputs(conv, 37, degree, cuda, layer, mlp_ws), si2_ws)


def test_extw_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    conv = FusedConv(tp, mlp, si2, 16, ext_w=True)
    rng = np.random.default_rng(9)
    si2_ws = tuple(torch.tensor(rng.normal(size=si2.param_shapes()[f'w{n}']),
                                dtype=torch.float32, device=cuda)
                   for n in range(len(si2.paths)))
    _assert_extw_kernels_match_plain(
        conv, _extw_inputs(conv, 11, 16, cuda, 3), si2_ws)


def test_extw_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, ext_w=True)
    mlp_ws, si2_ws = cl._weights()
    xg, sh, weff, _, _ = _extw_inputs(conv, 4, 32, cuda, 0, mlp_ws)
    for t in (xg, sh, weff):
        t.requires_grad_(True)
    fc.reset_launch_counts()
    conv(xg, sh, weff, si2_ws).sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_extw_fwd'] = want['fused_conv_extw_bwd'] = 1
    assert fc.launch_counts == want
    assert weff.grad is not None and weff.grad.shape == weff.shape


# -- the edge-row contract (agg_d = 0) --------------------------------------

@pytest.mark.parametrize('layer', [0, 1, 4])
def test_edge_row_mode_matches_plain(cuda, model, layer):
    """agg_d = 0: one output row per edge, from the edge-row form of
    kernels 1-2; 301 rows (a ragged last block forward and backward) in no
    grid order, a fifth of them masked."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers[f'{layer}_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
    mlp_ws, si2_ws = cl._weights()
    rng = np.random.default_rng(20 + layer)
    rows = 301

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    xg, sh, emb, g = (t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb),
                      t(rows, conv.d_out))
    ms = torch.tensor(rng.uniform(0.01, 0.05, size=(rows, 1)),
                      dtype=torch.float32, device=cuda)
    ms[torch.tensor(rng.uniform(size=rows) < 0.2, device=cuda)] = 0.0
    fc.reset_launch_counts()
    y_k = conv.forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_k = conv.backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_edge_fwd'] = want['fused_conv_edge_bwd'] = 1
    assert fc.launch_counts == want
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = conv.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert tuple(y_k.shape) == (rows, conv.d_out)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(d_k, d_p):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


def test_calculator_on_the_card_matches_cpu(cuda, model):
    """E, F and stress of a sheared 64-atom NaCl: the card (kernels 1-2 in
    their edge-row form + index_add_) against the CPU (plain versions). fp32 on
    both: E 1e-4 eV, F 1e-4 eV/A, stress 1e-6 eV/A^3."""
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(64, rattle=0.1, seed=1)
    strain = np.eye(3) + np.array([[0.02, 0.01, 0.008], [0.01, -0.01, 0.015],
                                   [0.008, 0.015, 0.0]])
    at = Atoms(at.atomic_numbers, at.pos @ strain, at.cell @ strain, at.pbc)
    fc.reset_launch_counts()
    res = SevenNetCalculator(model, device=cuda).calculate(at)
    assert fc.launch_counts['fused_conv_edge_fwd'] == 5
    assert fc.launch_counts['fused_conv_edge_bwd'] == 5
    import copy
    ref = SevenNetCalculator(copy.deepcopy(model), device='cpu').calculate(at)
    assert abs(res['energy'] - ref['energy']) <= 1e-4
    assert np.abs(res['forces'] - ref['forces']).max() <= 1e-4
    assert np.abs(res['stress'] - ref['stress']).max() <= 1e-6


# -- the terms pair (cg_mode='terms') ----------------------------------------

def _plain_inputs(conv, rows, cuda, seed):
    """xg, sh, emb, ms (a fifth of the rows masked) and a cotangent of the
    output's shape; returns the pad rows too."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    return (t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb),
            torch.tensor(ms, dtype=torch.float32, device=cuda),
            t(rows // conv.group, conv.d_out), torch.tensor(pad, device=cuda))


def _assert_terms_match(terms, default, args, mlp_ws, si2_ws):
    """The terms kernels against the plain version and against the default
    kernels; pad rows of the gradients exactly zero."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    xg, sh, emb, ms, g, pad = args
    fc.reset_launch_counts()
    y_t = terms.forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_t = terms.backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_terms_fwd'] = want['fused_conv_terms_bwd'] = 1
    assert fc.launch_counts == want
    y_p = terms.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = terms.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    y_k = default.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_k = default.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert tuple(y_t.shape) == tuple(y_p.shape)
    assert torch.isfinite(y_t).all()
    for ref in (y_p, y_k):
        assert (y_t - ref).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b, c in zip(d_t, d_p, d_k):
        assert torch.isfinite(a).all()
        lim = 1e-4 * max(b.abs().max(), 1e-6)
        assert (a - b).abs().max() <= lim and (a - c).abs().max() <= lim
        assert a[pad].abs().max() == 0                   # pad rows: zeros


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 36, 0])
def test_terms_kernels_match_plain_and_default(cuda, model, layer, degree):
    """agg_d = 32 (whole tiles), 36 (a ragged last tile per atom) and 0
    (edge rows, 301 of them: a ragged last block); layer 0 has output
    columns no si2 path feeds."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    terms = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, cg_mode='terms')
    default = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree)
    rows = 37 * degree if degree else 301
    _assert_terms_match(terms, default,
                        _plain_inputs(terms, rows, cuda, 40 + layer),
                        *cl._weights())


@pytest.mark.parametrize('degree', [16, 0])
def test_terms_kernels_small_multiplicities(cuda, degree):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    terms = FusedConv(tp, mlp, si2, degree, cg_mode='terms')
    default = FusedConv(tp, mlp, si2, degree)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    rows = 11 * degree if degree else 77
    _assert_terms_match(terms, default, _plain_inputs(terms, rows, cuda, 5),
                        mlp_ws, si2_ws)


def test_terms_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, cg_mode='terms')
    xg, sh, emb, ms, _, _ = _plain_inputs(conv, 4 * 32, cuda, 0)
    xg.requires_grad_(True)
    fc.reset_launch_counts()
    conv(xg, sh, emb, ms, *cl._weights()).sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_terms_fwd'] = want['fused_conv_terms_bwd'] = 1
    assert fc.launch_counts == want and xg.grad is not None


def test_engine_with_terms_matches_default_on_the_card(cuda, model):
    """E, F and stress of a 64-atom NPT engine: terms kernels against the
    default kernels, whole-array and in chunks of 24 atoms."""
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(64, rattle=0.1, seed=1)
    kw = dict(device=cuda, ensemble='npt', pressure_gpa=1.0)
    md = MolecularDynamics(model, at, **kw)
    nl = md._grid()
    e0, f0, s0 = md._efs_fn(md.state.pos, nl, md.state.cell)
    for chunk in (0, 24):
        mdt = MolecularDynamics(model, at, cg_mode='terms',
                                conv_chunk_atoms=chunk, **kw)
        fc.reset_launch_counts()
        e, f, s = mdt._efs_fn(md.state.pos, nl, md.state.cell)
        n_chunks = 3 if chunk else 1
        assert fc.launch_counts['fused_conv_terms_fwd'] == 5 * n_chunks
        assert fc.launch_counts['fused_conv_terms_bwd'] == 5 * n_chunks
        assert fc.launch_counts['fused_conv_fwd'] == 0
        assert abs(float(e) - float(e0)) <= 1e-4
        assert (f - f0).abs().max() <= 1e-4
        assert (s - s0).abs().max() <= 1e-6


# -- the bare tensor product ---------------------------------------------------

def _tp_inputs(op, rows, cuda, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(rows, d)), dtype=torch.float32,
                         device=cuda)
            for d in (op.d1, op.f, op.w_numel, op.d3)]


def _assert_tp_matches_plain(op, rows, cuda, seed):
    from sevennet_exp_tpu_torch.ops import fused_tp as ftp
    xg, sh, w, g = _tp_inputs(op, rows, cuda, seed)
    ftp.launch_counts['fused_tp_fwd'] = ftp.launch_counts['fused_tp_bwd'] = 0
    xs = [t.clone().requires_grad_(True) for t in (xg, sh, w)]
    out = op(*xs)                               # through autograd
    grads = torch.autograd.grad(out, xs, g)
    assert ftp.launch_counts['fused_tp_fwd'] == 1
    assert ftp.launch_counts['fused_tp_bwd'] == 1
    ref = op.plain_forward(xg, sh, w)
    ref_grads = op.plain_backward(g, xg, sh, w)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (rows, op.d3)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    for a, b in zip(grads, ref_grads):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('rows', [256, 301])
def test_fused_tp_kernels_match_plain(cuda, model, layer, rows):
    """301 rows: a ragged last block (8 rows per block)."""
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    op = make_fused_tp(model.layers[f'{layer}_convolution'].tp)
    _assert_tp_matches_plain(op, rows, cuda, 60 + layer)


def test_fused_tp_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp), l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    from sevennet_exp_tpu_torch.ops.tensor_product import UVUTensorProductSpec
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    op = make_fused_tp(UVUTensorProductSpec(
        x, sh, infer_irreps_out(x, sh, 3, 'full')))
    _assert_tp_matches_plain(op, 77, cuda, 3)


# -- the micro-benchmark kernels (tools/bench_*.py) ----------------------

@pytest.mark.parametrize('pads', [False, True], ids=['ms1', 'pads'])
@pytest.mark.parametrize('variant', ['full', '-mlp', '-cg', '-w', '-agg',
                                     '-si2'])
def test_bench_pieces_kernels_match_plain(cuda, variant, pads):
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_pieces as bp
    conv = bp.mid_layer_conv()
    xg, sh, emb, ms, mlp_ws, si2_ws = bp.make_inputs(conv, 9 * 32, cuda)
    if pads:
        ms[torch.rand(ms.shape[0], device=cuda) < 0.2] = 0.0
    ins = (xg, sh, emb, ms, mlp_ws, si2_ws)
    before = cuda_build.launch_counts[bp.COUNTER[variant]]
    got = bp.variant_forward(conv, variant, *ins)
    assert cuda_build.launch_counts[bp.COUNTER[variant]] == before + 1
    ref = bp.plain_variant(conv, variant, *ins)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if variant == 'full':
        assert torch.equal(got, conv.kernel_forward(*ins))


@pytest.mark.parametrize('mode', ['st', 'outer', 'dots'])
@pytest.mark.parametrize('i1', [1, 2])
def test_bench_cgmxu_kernels_match_plain(cuda, i1, mode):
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    cls = bc.cg_class(i1)
    ins = bc.make_inputs(cls, 320, cuda)
    got = bc.forward(cls, mode, *ins)
    ref = bc.plain(cls, mode, *ins)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if mode != 'dots':
        orc = torch.tensor(bc.oracle(cls, *ins, 64), device=cuda)
        assert (got[:, :64] - orc).abs().max() <= 1e-4 * orc.abs().max()


def test_bench_cgmxu_dots_sass_has_every_multiply_add(cuda):
    """Each dots instance issues at least d3tot K FFMA per column it owns
    (4 edges a thread): the dense product is neither folded nor cut."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_cgmxu')
    for K, d3 in bc.DOTS_SHAPES:
        (c,) = [v for k, v in counts.items()
                if f'cgmxu_dots_kernelILi{K}ELi{d3}E' in k]
        assert c['FFMA'] >= d3 * K * bc.DOTS_EDGES


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape', [(27, 20, 256), (45, 22, 128),
                                   (128, 128, 256), (8, 128, 128),
                                   (128, 8, 384), (1, 1, 128),
                                   (33, 17, 384), (64, 64, 256),
                                   (127, 129, 256)])
def test_bench_dot_kernels_match_plain(cuda, shape, dtype):
    from sevennet_exp_tpu_torch.tools import bench_dot as bd
    K, M, N = shape
    C, Z = bd.make_inputs(K, M, N, cuda, g=3)
    got = bd.forward(dtype, C, Z)
    ref = bd.plain(dtype, C, Z)
    torch.cuda.synchronize()
    lim = (1e-4 if dtype == 'fp32' else 1e-5 * K) * ref.abs().max()
    assert (got - ref).abs().max() <= lim
    if dtype == 'bf16':      # the rounding of the inputs shows
        assert (got - bd.plain('fp32', C, Z)).abs().max() > lim


def test_bench_dot_fp32_has_no_tensor_core_op(cuda):
    """The fp32 kernels multiply on the CUDA cores: FFMA, no HMMA (bf16's
    kernel, the check's control, has its mma.sync)."""
    from sevennet_exp_tpu_torch.tools import bench_dot as bd
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_dot')
    fp32 = {k: v for k, v in counts.items() if 'dot_fp32_' in k}
    assert len(fp32) == (len(bd.STREAM_TMS) + len(bd.STREAM_TMS_CW8)
                         + 1)        # the stream instances and the tile
    for v in fp32.values():
        assert v['FFMA'] > 0
        assert not any(v[op] for op in sass_compare.TENSOR_CORE_OPS)
    (bf16,) = [v for k, v in counts.items() if 'dot_bf16_kernel' in k]
    assert bf16['HMMA'] > 0


@pytest.mark.parametrize('variant', ['a:per-term', 'b:3d-reshape',
                                     'c:full-width'])
def test_bench_cg_kernels_match_plain(cuda, variant):
    from sevennet_exp_tpu_torch.tools import bench_cg
    x, y = bench_cg.make_inputs(100, cuda)     # a ragged last block
    got = bench_cg.forward(variant, x, y)
    ref = bench_cg.plain(variant, x, y)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize('variant', ['rowmajor', 'colmajor', 'transpose'])
def test_bench_layout_kernels_match_plain(cuda, variant):
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_layout as bl
    x, y = bl.make_inputs(cuda, grid=3)
    xv, yv = bl.inputs_for(variant, x, y)
    before = cuda_build.launch_counts[bl.COUNTER[variant]]
    got = bl.forward(variant, xv, yv)
    assert cuda_build.launch_counts[bl.COUNTER[variant]] == before + 1
    ref = bl.plain(variant, xv, yv)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if variant == 'rowmajor':        # a ragged last block of 8 rows
        part = bl.forward(variant, x[:100].contiguous(), y[:100].contiguous())
        assert torch.equal(part, got[:100])
    if variant == 'transpose':       # the same passes in the same order
        assert torch.equal(got, bl.forward('rowmajor', x, y))


@pytest.mark.parametrize('variant', ['d:per-slice', 'a:repeat',
                                     'b:bcast+cat', 'c:mxu-tile'])
def test_bench_tile_kernels_match_plain(cuda, variant):
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_tile as bt
    x, s = bt.make_inputs(100, cuda)           # a ragged last block
    before = cuda_build.launch_counts[bt.COUNTER[variant]]
    got = bt.forward(variant, x, s)
    assert cuda_build.launch_counts[bt.COUNTER[variant]] == before + 1
    ref = bt.plain(variant, x, s)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (got - bt.forward('d:per-slice', x, s)).abs().max() < 1e-3
    if variant == 'c:mxu-tile':      # T is read, not assumed
        T = torch.as_tensor(bt.ones_block(), device=cuda)
        T[1, 5] = -3.0
        got2 = bt.forward(variant, x, s, T)
        ref2 = bt.plain(variant, x, s, T)
        assert (got2 - ref2).abs().max() <= 1e-4 * ref2.abs().max()
        assert (got2 - got).abs().max() > 1e-3
