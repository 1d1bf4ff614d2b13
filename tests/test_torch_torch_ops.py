"""The edge pair's dispatcher ops (``csrc/torch_ops.cpp``,
``ops/torch_ops.py``) on the CPU.

  - the shim builds with g++ against the installed PyTorch and defines both
    schemas (tensors and one ``int[]`` only);
  - ``op_dims`` carries ``FusedConv._dims``' floats as their float32 bits;
  - with a CPU kernel registered here that runs the plain version on the
    op's own arguments (the packed weights and tables), ``make_fx`` plus
    ``torch.export`` of one convolution's energy and forces through the
    wrapper's autograd route (``_FusedConvFn``) with its kernel methods,
    which take the ops at ``agg_d = 0``, records exactly one
    ``conv_edge_fwd`` and one ``conv_edge_bwd`` node, and the exported program equals the port's
    plain chain (1e-6) and the JAX layer's XLA chain with ``jax.grad``
    (E 1e-5 eV a unit, F 1e-5), on the tiny config's first two
    convolutions;
  - in a process that has not loaded the shim, the first kernel call loads
    it before it looks the op up;
  - the ``register_fake`` shapes, and on the CPU the ``FusedConv`` wrapper
    keeps the plain version (it reaches the op only on a CUDA tensor) and
    counts no launch.
The CUDA implementation is held against ``kernel_forward`` /
``kernel_backward`` bit for bit in ``tests/test_torch_cuda.py``."""

import math
import os
import struct
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from samples import tiny_model_config
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops.spherical import spherical_harmonics as jsh
from sevennet_exp_tpu_torch.ops import cuda_build
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops import torch_ops
from sevennet_exp_tpu_torch.ops.scatter import scatter_sum
from sevennet_exp_tpu_torch.ops.spherical import spherical_harmonics
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

torch.set_num_threads(2)
N_ATOMS, N_EDGES = 6, 40


@pytest.fixture(scope='module')
def ops():
    return torch_ops.load()


def test_shim_builds_and_defines_both_schemas(ops):
    assert torch_ops.has_schema()
    tables = ['ins', 'col_ins', 'col_w', 'nz_idx', 'nz_coef', 'grp',
              'grp_alpha', 'xent', 'xins']
    weights = ['w0', 'w1', 'w1t', 'w2', 'w2t', 'si2', 'si2t']
    for name, first, n_out in (('conv_edge_fwd', [], 1),
                               ('conv_edge_bwd', ['g'], 3)):
        schema = getattr(torch.ops.sevenn_torch, name).default._schema
        args = [a.name for a in schema.arguments]
        assert args == (first + ['xg', 'sh', 'emb', 'ms'] + weights + tables
                        + ['dims'])
        assert [str(a.type) for a in schema.arguments[:-1]] == \
            ['Tensor'] * (len(args) - 1)
        assert str(schema.arguments[-1].type) == 'List[int]'
        assert [str(r.type) for r in schema.returns] == ['Tensor'] * n_out
    assert torch_ops.shim_launches() == [0, 0]


def test_op_dims_carry_float_bits():
    dims = list(range(14)) + [1.6791767923989418, 0.5, 0.125, -3.0e-8]
    got = torch_ops.op_dims(dims)
    assert got[:14] == list(range(14))
    for bits, v in zip(got[14:], dims[14:]):
        assert struct.unpack('<f', struct.pack('<i', bits))[0] == \
            np.float32(v)


@pytest.fixture(scope='module')
def layers():
    model = build_e3_equivariant_model(tiny_model_config())
    params, _ = model.init(jax.random.PRNGKey(0))
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)][:2]


def _port_conv(layer):
    tp = UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                              repr(layer.tp.irreps_in2),
                              repr(layer.tp.irreps_out_filter))
    mlp = FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act)
    si2 = LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out))
    return pfc.FusedConv(tp, mlp, si2, 0)


def _graph(layer, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_ATOMS, layer.tp.irreps_in1.dim)).astype(
        np.float32)
    vec = rng.normal(scale=1.5, size=(N_EDGES, 3)).astype(np.float32)
    src = rng.integers(0, N_ATOMS, N_EDGES)
    dst = rng.integers(0, N_ATOMS, N_EDGES)
    ms = rng.uniform(0.02, 0.1, size=(N_EDGES, 1)).astype(np.float32)
    ms[-5:] = 0.0                                    # pad edges
    c = rng.normal(size=(N_ATOMS, layer.si2.irreps_out.dim)).astype(
        np.float32)
    return x, vec, src, dst, ms, c


def _lmax(conv):
    return int(round(math.sqrt(conv.f))) - 1


def _energy_fn(conv, weights, route):
    """E(x, vec) of one convolution on an edge list, and its gradients
    (dE/dx, dE/dvec): sh(vec), emb = sin(k r) / r, the conv by ``route``,
    the scatter onto the atoms, a fixed linear read-out."""
    mlp_ws, si2_ws = weights
    nb, lmax = conv.nb, _lmax(conv)

    def ef(x, vec, src, dst, ms, c):
        x = x.detach().requires_grad_(True)
        vec = vec.detach().requires_grad_(True)
        with torch.enable_grad():
            sh = spherical_harmonics(lmax, vec)
            r = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True))
            k = torch.arange(1, nb + 1, dtype=vec.dtype)
            emb = torch.sin(k * r) / r
            y = route(x[src], sh.contiguous(), emb.contiguous(), ms,
                      mlp_ws, si2_ws)
            e = torch.sum(scatter_sum(y, dst, x.shape[0]) * c)
            gx, gv = torch.autograd.grad(e, (x, vec))
        return e.detach(), gx, gv
    return ef


def _jax_energy(layer, lp, inputs):
    x, vec, src, dst, ms, c = inputs
    lmax = int(round(math.sqrt(layer.tp.irreps_in2.dim))) - 1
    nb = layer.weight_nn.hs[0]

    def e(x, vec):
        sh = jsh(lmax, vec)
        r = jnp.sqrt(jnp.sum(vec * vec, axis=-1, keepdims=True))
        emb = jnp.sin(jnp.arange(1, nb + 1, dtype=vec.dtype) * r) / r
        w = layer.weight_nn.apply(lp['weight_nn'], emb) * ms
        msg = layer.tp.apply(x[src], sh, w)
        y = layer.si2.apply(lp['si2'], msg, skip_bias=True)
        return jnp.sum(jax.ops.segment_sum(y, dst, N_ATOMS) * c)
    val, (gx, gv) = jax.value_and_grad(e, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(vec))
    return np.asarray(val), np.asarray(gx), np.asarray(gv)


@pytest.fixture
def cpu_kernels(ops):
    """CPU implementations of both ops (for this test only) that run the
    plain version on the op's own arguments: w0, w1, w2 and the flat si2
    split back into its paths."""
    impl = torch.library.Library('sevenn_torch', 'IMPL')
    convs = {}

    def unpack(xg, w0, w1, w2, si2, dims):
        conv, shapes = convs[(xg.shape[1], dims[6])]
        sizes = [math.prod(s) for s in shapes]
        si2_ws = tuple(t.reshape(s) for t, s in
                       zip(torch.split(si2, sizes), shapes))
        return conv, (w0, w1, w2), si2_ws

    def fwd(xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2, si2t, *rest):
        conv, mlp, s2 = unpack(xg, w0, w1, w2, si2, rest[-1])
        return conv.plain_forward(xg, sh, emb, ms, mlp, s2)

    def bwd(g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2, si2t, *rest):
        conv, mlp, s2 = unpack(xg, w0, w1, w2, si2, rest[-1])
        return tuple(t.clone() for t in
                     conv.plain_backward(g, xg, sh, emb, ms, mlp, s2))

    impl.impl('conv_edge_fwd', fwd, 'CPU')
    impl.impl('conv_edge_bwd', bwd, 'CPU')
    yield convs
    impl._destroy()


def _weights(layer, lp):
    mlp = tuple(torch.tensor(np.asarray(lp['weight_nn'][f'w{i}']))
                for i in range(3))
    si2 = tuple(torch.tensor(np.asarray(lp['si2'][f'w{n}']))
                for n in range(len(layer.si2.paths)))
    return mlp, si2


@pytest.mark.parametrize('index', [0, 1])
def test_traced_export_records_the_op_pair(layers, cpu_kernels, index):
    layer, lp = layers[index]
    conv = _port_conv(layer)
    weights = _weights(layer, lp)
    cpu_kernels[(conv.d1, conv.d_out)] = (
        conv, [tuple(w.shape) for w in weights[1]])
    inputs = _graph(layer, seed=index)
    args = [torch.tensor(v) for v in inputs]
    args[2], args[3] = args[2].long(), args[3].long()

    # the card's dispatch: _FusedConvFn launches through the kernel methods
    conv.forward, conv.backward = conv.kernel_forward, conv.kernel_backward
    cuda_build.reset_launch_counts()
    gm = make_fx(_energy_fn(conv, weights, conv), tracing_mode='fake',
                 _allow_non_fake_inputs=True)(*args)
    ep = torch.export.export(gm, tuple(args))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == 'call_function']
    assert sum(t.startswith('sevenn_torch.conv_edge_fwd') for t in targets) \
        == 1
    assert sum(t.startswith('sevenn_torch.conv_edge_bwd') for t in targets) \
        == 1
    got = [t.detach().numpy() for t in ep.module()(*args)]

    plain = _energy_fn(conv, weights, conv.plain_forward)(*args)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p.numpy(), rtol=0, atol=1e-6)
    want = _jax_energy(layer, lp, inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # no kernel launched: the shim counted nothing, nor did the wrapper
    assert torch_ops.shim_launches() == [0, 0]
    assert sum(cuda_build.launch_counts.values()) == 0


def test_fake_shapes(layers, ops):
    layer, lp = layers[1]
    conv = _port_conv(layer)
    mlp, si2 = _weights(layer, lp)
    from torch._subclasses.fake_tensor import FakeTensorMode
    rows = 7
    with FakeTensorMode(allow_non_fake_inputs=True):
        xg = torch.empty(rows, conv.d1)
        sh = torch.empty(rows, conv.f)
        emb = torch.empty(rows, conv.nb)
        ms = torch.empty(rows, 1)
        t = conv.kernel_tables(torch.device('cpu'))
        rest = (*conv._pack(mlp, si2), *conv.table_tensors(t),
                torch_ops.op_dims(conv._dims(t, rows)))
        y = torch.ops.sevenn_torch.conv_edge_fwd(xg, sh, emb, ms, *rest)
        g = torch.empty(rows, conv.d_out)
        d = torch.ops.sevenn_torch.conv_edge_bwd(g, xg, sh, emb, ms, *rest)
    assert tuple(y.shape) == (rows, conv.d_out)
    assert [tuple(v.shape) for v in d] == [(rows, conv.d1), (rows, conv.f),
                                          (rows, conv.nb)]


def test_cpu_wrapper_keeps_the_plain_version(layers, ops):
    """Without a CPU kernel registered, the wrapper on CPU tensors runs the
    plain version (the op has no CPU implementation to reach) and counts
    no launch."""
    layer, lp = layers[0]
    conv = _port_conv(layer)
    mlp, si2 = _weights(layer, lp)
    x, vec, src, dst, ms, c = _graph(layer, seed=5)
    xg = torch.tensor(x[src])
    sh = spherical_harmonics(_lmax(conv), torch.tensor(vec))
    emb = torch.rand(N_EDGES, conv.nb)
    cuda_build.reset_launch_counts()
    y = conv(xg, sh, emb, torch.tensor(ms), mlp, si2)
    assert torch.equal(y, conv.plain_forward(xg, sh, emb, torch.tensor(ms),
                                             mlp, si2))
    assert sum(cuda_build.launch_counts.values()) == 0
    with pytest.raises(NotImplementedError):
        conv.kernel_forward(xg, sh, emb, torch.tensor(ms), mlp, si2)


def test_first_kernel_call_loads_the_ops(ops):
    """In a fresh process (no shim loaded), ``kernel_forward`` /
    ``kernel_backward`` at ``agg_d = 0`` load the ops before they look them
    up: on CPU tensors they reach the op, which has no CPU kernel."""
    code = textwrap.dedent("""
        import torch
        from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
        from sevennet_exp_tpu_torch.model import layers as L
        from sevennet_exp_tpu_torch.ops import torch_ops
        from sevennet_exp_tpu_torch.ops.tensor_product import (
            FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)
        x, sh = Irreps('4x0e+4x1o'), Irreps('1x0e+1x1o')
        tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 1, 'full'))
        layer = L.IrrepsConvolution(
            tp, FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu'),
            LinearSpec(tp.irreps_out, x), 10.0)
        conv = layer._conv(0)
        mlp_ws, si2_ws = layer._weights()
        assert not torch_ops.has_schema()
        acts = [torch.zeros(8, w) for w in (conv.d1, conv.f, conv.nb, 1)]
        for call in (lambda: conv.kernel_forward(*acts, mlp_ws, si2_ws),
                     lambda: conv.kernel_backward(
                         torch.zeros(8, conv.d_out), *acts, mlp_ws, si2_ws)):
            try:
                call()
            except NotImplementedError:
                print('reached the op')
        """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split() == ['reached', 'the', 'op'] * 2
