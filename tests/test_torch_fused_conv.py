"""The port's fused conv on the CPU against the JAX package.

The port's plain version and its autograd wrapper (which takes the plain
version on CPU tensors) are held against the JAX XLA chain of
``_rows_to_nodes`` and against JAX ``make_fused_conv(..., agg_d=D)`` in
interpret mode, on the tiny config's convolutions over a D = 32 grid of 8
atoms: the node rows and the VJPs dxg, dsh, demb at atol 1e-5.

The JAX fused kernel and the JAX XLA chain disagree wherever the si2
input merges several TP outputs of one l > 0 irrep (tiny layer 1; the
checkpoint's layers 1-3): the kernel groups the merged entry component
by component, the XLA chain reads the concatenated [k][p][u] message as
[p][r]. The port follows the XLA chain, which the trained checkpoint was
fit with; ``test_jax_fused_kernel_diverges_from_xla_chain`` pins the
divergence and ``test_layer1_rotation_equivariance`` shows which side is
at fault: the fused kernel's node rows rotate with their inputs, the XLA
chain's (and the port's) do not.

``test_kernel_tables_reproduce_plain`` runs the CUDA kernels' arithmetic
as the first design wrote it (csrc/fused_conv_body.cuh) -- driven by the
same device tables --
in vectorised torch on the CPU, so the table contract is covered here;
the kernels themselves run only on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

torch.set_num_threads(2)
ATOL = 1e-5
D, N_ATOMS = 32, 8


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_conv.set_interpret(True)
    yield
    pallas_conv.set_interpret(False)


@pytest.fixture(scope='module')
def tiny_layers():
    model = build_e3_equivariant_model(tiny_model_config())
    params, _ = model.init(jax.random.PRNGKey(0))
    return [(name, layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


def _inputs(layer, lp, seed):
    rng = np.random.default_rng(seed)
    rows = N_ATOMS * D
    xg = rng.normal(size=(rows, layer.tp.irreps_in1.dim)).astype(np.float32)
    sh = rng.normal(size=(rows, layer.tp.irreps_in2.dim)).astype(np.float32)
    emb = rng.normal(size=(rows, layer.weight_nn.hs[0])).astype(np.float32)
    ms = rng.uniform(0.0, 0.1, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0       # grid pad rows
    mlp = [np.asarray(lp['weight_nn'][f'w{i}']) for i in range(3)]
    si2 = [np.asarray(lp['si2'][f'w{n}'])
           for n in range(len(layer.si2.paths))]
    g = rng.normal(size=(N_ATOMS, layer.si2.irreps_out.dim)).astype(
        np.float32)
    return (xg, sh, emb, ms), mlp, si2, g


def _port_conv(layer):
    tp = UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                              repr(layer.tp.irreps_in2),
                              repr(layer.tp.irreps_out_filter))
    mlp = FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act)
    si2 = LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out))
    return pfc.FusedConv(tp, mlp, si2, D)


def _jax_xla(layer, lp):
    def f(xg, sh, emb, ms):
        w = layer.weight_nn.apply(lp['weight_nn'], emb) * ms
        msg = layer.tp.apply(xg, sh, w)
        agg = msg.reshape((msg.shape[0] // D, D) + msg.shape[1:]).sum(1)
        return layer.si2.apply(lp['si2'], agg, skip_bias=True)
    return f


def _jax_fused(layer, lp):
    fused, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                           layer.si2, agg_d=D)
    mlp = tuple(lp['weight_nn'][f'w{i}'] for i in range(3))
    si2 = tuple(lp['si2'][f'w{n}'] for n in range(len(layer.si2.paths)))
    return lambda xg, sh, emb, ms: fused(xg, sh, emb, ms, mlp, si2)


def _jax_value_vjp(f, ins, g):
    out, vjp = jax.vjp(lambda a, b, c: f(a, b, c, jnp.asarray(ins[3])),
                       *[jnp.asarray(x) for x in ins[:3]])
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_value_vjp(conv, ins, mlp, si2, g, wrapper):
    xg, sh, emb = [torch.tensor(x, requires_grad=True) for x in ins[:3]]
    ms = torch.tensor(ins[3])
    mw = tuple(torch.tensor(w) for w in mlp)
    sw = tuple(torch.tensor(w) for w in si2)
    if wrapper:
        out = conv(xg, sh, emb, ms, mw, sw)
    else:
        out = conv.plain_forward(xg, sh, emb, ms, mw, sw)
    grads = torch.autograd.grad(out, (xg, sh, emb), torch.tensor(g))
    return out.detach().numpy(), [v.numpy() for v in grads]


def _close(a, b):
    np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize('li', [0, 1, 2])
@pytest.mark.parametrize('wrapper', [False, True],
                         ids=['plain', 'autograd_fn'])
def test_port_matches_jax_xla_chain(tiny_layers, li, wrapper):
    _, layer, lp = tiny_layers[li]
    ins, mlp, si2, g = _inputs(layer, lp, seed=li)
    j_out, j_grads = _jax_value_vjp(_jax_xla(layer, lp), ins, g)
    p_out, p_grads = _port_value_vjp(_port_conv(layer), ins, mlp, si2, g,
                                     wrapper)
    _close(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close(a, b)


@pytest.mark.parametrize('li', [0, 2])
@pytest.mark.parametrize('wrapper', [False, True],
                         ids=['plain', 'autograd_fn'])
def test_port_matches_jax_fused_kernel(tiny_layers, li, wrapper):
    """Layers whose si2 input merges no l > 0 entries: the JAX fused
    kernel (interpret mode) and the port agree."""
    _, layer, lp = tiny_layers[li]
    ins, mlp, si2, g = _inputs(layer, lp, seed=10 + li)
    j_out, j_grads = _jax_value_vjp(_jax_fused(layer, lp), ins, g)
    p_out, p_grads = _port_value_vjp(_port_conv(layer), ins, mlp, si2, g,
                                     wrapper)
    _close(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close(a, b)


def test_jax_fused_kernel_diverges_from_xla_chain(tiny_layers):
    _, layer, lp = tiny_layers[1]
    ins, _, _, _ = _inputs(layer, lp, seed=5)
    args = [jnp.asarray(x) for x in ins]
    fused = np.asarray(_jax_fused(layer, lp)(*args))
    xla = np.asarray(_jax_xla(layer, lp)(*args))
    assert np.abs(fused - xla).max() > 0.1 * np.abs(xla).max()


@pytest.fixture(scope='module')
def checkpoint_layers():
    from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
    model, params = JCK('trained_nacl/checkpoint_best.pth.sevennet'
                        ).build_model()
    return [(name, layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


def _rotation(irreps):
    """Block-diagonal Wigner D of one rotation on an ir_mul feature."""
    from scipy.linalg import block_diag
    from sevennet_exp_tpu.ops.wigner import real_wigner_D
    return block_diag(*[
        np.kron(real_wigner_D(ir.l, np.array([0.3, -1.2, 0.8]), 1.1),
                np.eye(mul)) for mul, ir in irreps])


@pytest.mark.parametrize('which', ['tiny', 'checkpoint'])
@pytest.mark.parametrize('impl,rotates', [
    ('jax_fused', True), ('jax_xla', False), ('port_plain', False)])
def test_layer1_rotation_equivariance(tiny_layers, checkpoint_layers,
                                      which, impl, rotates):
    """Rotating xg and sh by a Wigner D on each irrep rotates the node
    rows of the JAX fused kernel, but not those of the XLA chain (nor of
    the port's plain version, which follows it): the XLA chain's si2
    reads the merged l > 0 message entries in the wrong layout."""
    _, layer, lp = (tiny_layers if which == 'tiny' else
                    checkpoint_layers)[1]
    (xg, sh, emb, ms), mlp, si2, _ = _inputs(layer, lp, seed=5)
    d_out = _rotation(layer.si2.irreps_out)
    xr = (xg @ _rotation(layer.tp.irreps_in1).T).astype(np.float32)
    shr = (sh @ _rotation(layer.tp.irreps_in2).T).astype(np.float32)
    if impl == 'port_plain':
        conv = _port_conv(layer)
        mw, sw = [tuple(torch.tensor(w) for w in ws) for ws in (mlp, si2)]

        def f(a, b):
            return conv.plain_forward(
                torch.tensor(a), torch.tensor(b), torch.tensor(emb),
                torch.tensor(ms), mw, sw).numpy()
    else:
        fn = (_jax_fused if impl == 'jax_fused' else _jax_xla)(layer, lp)

        def f(a, b):
            return np.asarray(fn(*map(jnp.asarray, (a, b, emb, ms))))
    y = f(xg, sh)
    err = np.abs(f(xr, shr) - y @ d_out.T).max() / np.abs(y).max()
    if rotates:
        assert err < 1e-5
    else:
        assert err > 0.5


# -- the kernels' arithmetic, driven by their device tables -------------

def _emulate(conv, xg, sh, emb, ms, mlp_ws, si2_ws, g):
    """Forward node rows and (dxg, dsh, demb) computed the way
    csrc/fused_conv_body.cuh does, from conv.kernel_tables('cpu')."""
    t = conv.kernel_tables(torch.device('cpu'))
    S = pfc._I_STRIDE
    ins = t.ins.reshape(t.n_ins, S).tolist()
    grp = t.grp.reshape(t.n_grp, pfc._G_STRIDE).tolist()
    nz_idx, coef = t.nz_idx.tolist(), t.nz_coef
    rows, n = xg.shape[0], xg.shape[0] // conv.agg_d
    w_full = conv.mlp.apply({f'w{i}': w for i, w in enumerate(mlp_ws)},
                            emb) * ms
    weff = w_full[:, t.col_w.long()]               # (rows, n_active)
    si2 = torch.cat([w.reshape(-1) for w in si2_ws])
    agg = xg.new_zeros((n, t.agg_dim))
    gm = xg.new_zeros((n, t.agg_dim))
    out = xg.new_zeros((n, conv.d_out))
    for (K, mo, d3, o_off, a_off, w_off), alpha in zip(grp,
                                                      t.grp_alpha.tolist()):
        W = si2[w_off:w_off + K * mo].reshape(K, mo)
        gp = g[:, o_off:o_off + d3 * mo].reshape(n, d3, mo)
        gm[:, a_off:a_off + d3 * K] = (alpha * gp @ W.T).reshape(n, -1)
    dxg = torch.zeros_like(xg)
    dsh = torch.zeros_like(sh)
    dw = torch.zeros_like(weff)
    gm_rows = gm.repeat_interleave(conv.agg_d, 0)
    for I in ins:
        x_off, mul, sh_off, _, d1, d2, d3, a, stride, col0 = I[:10]
        u = torch.arange(mul)
        we = weff[:, col0:col0 + mul]

        def nzs(sec, key):
            lo, hi = I[10 + sec * pfc._MAXD + key], \
                I[10 + sec * pfc._MAXD + key + 1]
            return [(nz_idx[q] & 0xff, (nz_idx[q] >> 8) & 0xff,
                     nz_idx[q] >> 16, coef[q]) for q in range(lo, hi)]

        def x_m(m):
            return xg[:, x_off + m * mul + u]

        def gm_p(p):
            return gm_rows[:, a + p * stride + u]

        for p in range(d3):                            # forward, dw_eff
            s = sum(c * x_m(m) * sh[:, sh_off + nn:sh_off + nn + 1]
                    for m, nn, _, c in nzs(0, p))
            agg[:, a + p * stride + u] += (we * s).reshape(
                n, conv.agg_d, mul).sum(1)
            dw[:, col0:col0 + mul] += gm_p(p) * s
        for nn in range(d2):                           # dsh
            v = sum(c * gm_p(p) * x_m(m) for m, _, p, c in nzs(1, nn))
            dsh[:, sh_off + nn] += (v * we).sum(1)
        for m in range(d1):                            # dxg
            v = sum(c * gm_p(p) * sh[:, sh_off + nn:sh_off + nn + 1]
                    for _, nn, p, c in nzs(2, m))
            dxg[:, x_off + m * mul + u] += v * we
    for (K, mo, d3, o_off, a_off, w_off), alpha in zip(grp,
                                                      t.grp_alpha.tolist()):
        W = si2[w_off:w_off + K * mo].reshape(K, mo)
        a3 = agg[:, a_off:a_off + d3 * K].reshape(n, d3, K)
        out[:, o_off:o_off + d3 * mo] = (alpha * a3 @ W).reshape(n, -1)
    dw_full = torch.zeros_like(w_full)
    dw_full[:, t.col_w.long()] = dw
    emb_ = emb.detach().requires_grad_(True)
    w_ = conv.mlp.apply({f'w{i}': w for i, w in enumerate(mlp_ws)}, emb_)
    (demb,) = torch.autograd.grad(w_, emb_, dw_full * ms)
    return out, (dxg, dsh, demb)


@pytest.mark.parametrize('which', ['tiny1', 'checkpoint1', 'checkpoint4'])
def test_kernel_tables_reproduce_plain(tiny_layers, which):
    if which == 'tiny1':
        _, layer, lp = tiny_layers[1]
        conv = _port_conv(layer)
        ins, mlp, si2, g = _inputs(layer, lp, seed=7)
        mlp_ws = tuple(torch.tensor(w) for w in mlp)
        si2_ws = tuple(torch.tensor(w) for w in si2)
    else:
        from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
        model, _ = SevenNetCheckpoint(
            'trained_nacl/checkpoint_best.pth.sevennet').build_model('cpu')
        cl = model.layers[f'{which[-1]}_convolution']
        conv = pfc.FusedConv(cl.tp, cl.weight_nn, cl.si2, D)
        mw, sw = cl.weight_nn_p.as_dict(), cl.si2_p.as_dict()
        mlp_ws = tuple(mw[f'w{i}'] for i in range(3))
        si2_ws = tuple(sw[f'w{n}'] for n in range(len(sw)))
        rng = np.random.default_rng(3)
        rows = N_ATOMS * D
        ins = [rng.normal(size=(rows, conv.d1)),
               rng.normal(size=(rows, conv.f)),
               rng.normal(size=(rows, conv.nb)),
               rng.uniform(0.0, 0.05, size=(rows, 1))]
        ins = [x.astype(np.float32) for x in ins]
        g = rng.normal(size=(N_ATOMS, conv.d_out)).astype(np.float32)
    xg, sh, emb, ms = (torch.tensor(x) for x in ins)
    gt = torch.tensor(g)
    ref_out = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    ref_grads = conv.plain_backward(gt, xg, sh, emb, ms, mlp_ws, si2_ws)
    out, grads = _emulate(conv, xg, sh, emb, ms, mlp_ws, si2_ws, gt)
    scale = float(ref_out.abs().max())
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(),
                               atol=1e-5 * max(1.0, scale), rtol=0)
    for a, b in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(b.abs().max())))
