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
    assert fc.launch_counts == {'fused_conv_fwd': 1, 'fused_conv_bwd': 1,
                                'fused_conv_geom_fwd': 0,
                                'fused_conv_geom_bwd': 0}


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
    assert fc.launch_counts == {'fused_conv_fwd': 0, 'fused_conv_bwd': 0,
                                'fused_conv_geom_fwd': 1,
                                'fused_conv_geom_bwd': 1}
    assert xg.grad is not None and vec.grad is not None
