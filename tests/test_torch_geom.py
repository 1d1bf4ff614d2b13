"""The port's in-kernel edge geometry on the CPU against the JAX package.

  - ``geom_rows`` (Bessel x envelope, real SH from the raw edge vector)
    against ``pallas_conv._geom_fm`` (plain jnp, called directly): values
    at atol 1e-5, VJP at atol 1e-4, for both envelopes and lmax 1-3, on
    rows inside r_on, rows near the cutoff and the (1, 0, 0) pad vector;
  - the arithmetic the CUDA kernels run -- the SH term table and the
    geometry VJP written out by hand in csrc/fused_conv_geom.cu -- replayed in
    torch from the same device tables, against autograd of ``geom_rows``;
  - ``plain_geom_forward`` / ``plain_geom_backward`` and the autograd
    wrapper ``apply_geom`` against ``_geom_fm`` followed by the JAX XLA
    chain of ``_rows_to_nodes`` on the tiny config's layers 0 and 1 and on
    checkpoint layer 1, at 1e-4 relative;
  - on tiny layer 0, where the kernel's and the XLA chain's layouts agree,
    also against the JAX geometry-fused Pallas kernel in interpret mode.

The CUDA kernels themselves run only on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops import pallas_conv, pallas_tp
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

torch.set_num_threads(2)
D, N_ATOMS = 32, 8
RC, R_ON, NB = 5.0, 4.5, 8
REL = 1e-4


def _spec_pair(kind, lmax, normalize=True):
    kw = dict(cutoff=RC, num_basis=NB, lmax=lmax, cutoff_kind=kind,
              cutoff_p=6.0, cutoff_on=R_ON if kind == 'xplor' else 0.0,
              normalize=normalize)
    return pallas_conv.GeomSpec(**kw), pfc.GeomSpec(**kw)


def _vectors(seed, n=64):
    """Edge vectors with lengths spread over (0.8, rc), plus rows inside
    r_on, rows just inside and outside r_on and the cutoff, and the pad
    vector."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    r = rng.uniform(0.8, RC, size=n)
    r[:10] = [1.0, 2.5, R_ON - 1e-3, R_ON + 1e-3, 0.99 * RC, RC - 1e-3,
              RC + 1e-3, 1.01 * RC, 4.0, 4.9]
    vec = u * r[:, None]
    vec[10] = [1.0, 0.0, 0.0]
    return vec.astype(np.float32)


def _coeffs():
    return (np.arange(1, NB + 1) * np.pi / RC).astype(np.float32)


@pytest.mark.parametrize('lmax', [1, 2, 3])
@pytest.mark.parametrize('kind', ['poly', 'xplor'])
def test_geom_rows_matches_jax_geom_fm(kind, lmax):
    jspec, pspec = _spec_pair(kind, lmax)
    vec, coeffs = _vectors(lmax), _coeffs()
    f = (lmax + 1) ** 2
    rng = np.random.default_rng(10 + lmax)
    g_emb = rng.normal(size=(vec.shape[0], NB)).astype(np.float32)
    g_sh = rng.normal(size=(vec.shape[0], f)).astype(np.float32)

    (j_emb, j_sh), vjp = jax.vjp(
        lambda vT: pallas_conv._geom_fm(vT, jnp.asarray(coeffs), jspec),
        jnp.asarray(vec.T))
    (j_dv,) = vjp((jnp.asarray(g_emb.T), jnp.asarray(g_sh.T)))

    v = torch.tensor(vec, requires_grad=True)
    emb, sh = pfc.geom_rows(v, torch.tensor(coeffs), pspec)
    (dv,) = torch.autograd.grad((emb, sh), v, (torch.tensor(g_emb),
                                               torch.tensor(g_sh)))
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(j_emb).T,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(sh.detach().numpy(), np.asarray(j_sh).T,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(dv.numpy(), np.asarray(j_dv).T, atol=1e-4,
                               rtol=0)
    # the pad vector stays finite and xplor's smooth branch is not zero
    # beyond the cutoff (only the mask removes those rows)
    assert np.isfinite(emb.detach().numpy()).all()
    if kind == 'xplor':
        assert np.abs(emb.detach().numpy()[7]).max() > 1e-6


# -- the kernels' geometry arithmetic, from their tables ------------------

def _emulate_geometry(conv, vec, coeffs, demb, dsh):
    """(emb, sh, dvec) computed the way csrc/fused_conv_geom.cu does:
    ``radial_of`` and ``geom_rows_fwd`` for the values, ``geom_rows_bwd``
    for the VJP, driven by ``conv.geom_tables``."""
    g = conv.geom
    idx, coef, off = (t.tolist() for t in conv.geom_tables(
        torch.device('cpu')))
    x, y, z = vec[:, 0], vec[:, 1], vec[:, 2]
    r2 = x * x + y * y + z * z
    r = torch.sqrt(r2 + 1e-30)
    inv_r = 1.0 / r
    if g.cutoff_kind == 'poly':
        p = g.cutoff_p
        c0, c1, c2 = (p + 1) * (p + 2) / 2, p * (p + 2), p * (p + 1) / 2
        rr = r / g.cutoff
        rp, rp1 = rr ** p, rr ** (p - 1)
        env = 1 - c0 * rp + c1 * rp * rr - c2 * rp * rr * rr
        denv = (-c0 * p * rp1 + c1 * (p + 1) * rp
                - c2 * (p + 2) * rp * rr) / g.cutoff
    else:
        rc2, ron2 = g.cutoff ** 2, g.cutoff_on ** 2
        inv_den = 1.0 / (rc2 - ron2) ** 3
        a = rc2 - r2
        inside = r < g.cutoff_on
        env = torch.where(inside, torch.ones_like(r),
                          a * a * (rc2 + 2 * r2 - 3 * ron2) * inv_den)
        denv = torch.where(inside, torch.zeros_like(r),
                           12 * a * (ron2 - r2) * inv_den * r)
    pref = 2.0 / g.cutoff
    s, co = torch.sin(coeffs * r[:, None]), torch.cos(coeffs * r[:, None])
    emb = s * (pref * inv_r * env)[:, None]
    d_emb = pref * ((coeffs * co - s * inv_r[:, None]) * (inv_r * env)[:, None]
                    + s * (inv_r * denv)[:, None])
    gr = (demb * d_emb).sum(1)
    u = [x * inv_r, y * inv_r, z * inv_r] if g.normalize else [x, y, z]
    sh = torch.zeros((vec.shape[0], len(off) - 1), dtype=vec.dtype)
    gu = [torch.zeros_like(x) for _ in range(3)]
    for j in range(len(off) - 1):
        for t in range(off[j], off[j + 1]):
            e = [idx[t] & 15, (idx[t] >> 4) & 15, (idx[t] >> 8) & 15]
            assert idx[t] >> 12 == j
            sh[:, j] += coef[t] * u[0] ** e[0] * u[1] ** e[1] * u[2] ** e[2]
            for k in range(3):
                if e[k]:
                    d = [e[i] - (i == k) for i in range(3)]
                    gu[k] = gu[k] + dsh[:, j] * coef[t] * e[k] * (
                        u[0] ** d[0] * u[1] ** d[1] * u[2] ** d[2])
    if g.normalize:
        dot = u[0] * gu[0] + u[1] * gu[1] + u[2] * gu[2]
        dv = [(gu[k] - u[k] * dot) * inv_r for k in range(3)]
    else:
        dv = gu
    dvec = torch.stack([dv[k] + gr * vec[:, k] * inv_r for k in range(3)], 1)
    return emb, sh, dvec


@pytest.mark.parametrize('normalize', [True, False], ids=['unit', 'raw'])
@pytest.mark.parametrize('lmax', [1, 2, 3])
@pytest.mark.parametrize('kind', ['poly', 'xplor'])
def test_kernel_geometry_arithmetic(kind, lmax, normalize):
    _, pspec = _spec_pair(kind, lmax, normalize)
    f = (lmax + 1) ** 2
    tp = UVUTensorProductSpec('4x0e', pfc_irreps_sh(lmax), '4x0e')
    mlp = FullyConnectedNetSpec((NB, 64, 64, tp.weight_numel), 'silu')
    conv = pfc.FusedConv(tp, mlp, LinearSpec('4x0e', '4x0e'), D, geom=pspec)
    vec = torch.tensor(_vectors(20 + lmax), dtype=torch.float64)
    coeffs = torch.tensor(_coeffs(), dtype=torch.float64)
    rng = np.random.default_rng(5)
    demb = torch.tensor(rng.normal(size=(vec.shape[0], NB)))
    dsh = torch.tensor(rng.normal(size=(vec.shape[0], f)))
    v = vec.clone().requires_grad_(True)
    emb_ref, sh_ref = pfc.geom_rows(v, coeffs, pspec)
    (dv_ref,) = torch.autograd.grad((emb_ref, sh_ref), v, (demb, dsh))
    emb, sh, dvec = _emulate_geometry(conv, vec, coeffs, demb, dsh)
    # float64 inputs, float32 table coefficients: 1e-6 of the largest value
    for got, ref in ((emb, emb_ref.detach()), (sh, sh_ref.detach()),
                     (dvec, dv_ref)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


def pfc_irreps_sh(lmax):
    from sevennet_exp_tpu_torch.irreps import Irreps
    return Irreps.spherical_harmonics(lmax, -1)


# -- the geometry-fused conv against the JAX chain -------------------------

@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_conv.set_interpret(True)
    yield
    pallas_conv.set_interpret(False)


@pytest.fixture(scope='module')
def tiny_layers():
    model = build_e3_equivariant_model(tiny_model_config())
    params, _ = model.init(jax.random.PRNGKey(0))
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


@pytest.fixture(scope='module')
def checkpoint_layers():
    from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
    model, params = JCK('trained_nacl/checkpoint_best.pth.sevennet'
                        ).build_model()
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


def _layer(which, tiny_layers, checkpoint_layers):
    src, li = which.split(':')
    return (tiny_layers if src == 'tiny' else checkpoint_layers)[int(li)]


def _port_conv(layer):
    tp = UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                              repr(layer.tp.irreps_in2),
                              repr(layer.tp.irreps_out_filter))
    mlp = FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act)
    si2 = LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out))
    g = layer.geom
    geom = pfc.GeomSpec(g.cutoff, g.num_basis, g.lmax, g.cutoff_kind,
                        g.cutoff_p, g.cutoff_on, g.normalize)
    return pfc.FusedConv(tp, mlp, si2, D, geom=geom)


def _inputs(layer, lp, seed):
    rng = np.random.default_rng(seed)
    rows = N_ATOMS * D
    rc = layer.geom.cutoff
    xg = rng.normal(size=(rows, layer.tp.irreps_in1.dim)).astype(np.float32)
    u = rng.normal(size=(rows, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = (u * rng.uniform(0.5 * rc, 0.999 * rc, size=(rows, 1))).astype(
        np.float32)
    ms = rng.uniform(0.02, 0.1, size=(rows, 1)).astype(np.float32)
    pad = rng.uniform(size=rows) < 0.2              # grid pad rows
    ms[pad] = 0.0
    vec[pad] = [1.0, 0.0, 0.0]
    coeffs = (np.arange(1, layer.geom.num_basis + 1) * np.pi / rc).astype(
        np.float32)
    mlp = [np.asarray(lp['weight_nn'][f'w{i}']) for i in range(3)]
    si2 = [np.asarray(lp['si2'][f'w{n}'])
           for n in range(len(layer.si2.paths))]
    g = rng.normal(size=(N_ATOMS, layer.si2.irreps_out.dim)).astype(
        np.float32)
    return (xg, vec, ms, coeffs), mlp, si2, g


def _jax_xla_chain(layer, lp):
    """``_geom_fm`` followed by ``IrrepsConvolution._rows_to_nodes`` with
    the Pallas kernels off: the XLA chain."""
    def f(xg, vec, ms, coeffs):
        embT, shT = pallas_conv._geom_fm(vec.T, coeffs, layer.geom)
        with pallas_tp.disabled():
            return layer._rows_to_nodes(lp, xg, shT.T, embT.T, ms, D)
    return f


def _jax_geom_kernel(layer, lp):
    fused, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                           layer.si2, agg_d=D,
                                           geom=layer.geom)
    mlp = tuple(lp['weight_nn'][f'w{i}'] for i in range(3))
    si2 = tuple(lp['si2'][f'w{n}'] for n in range(len(layer.si2.paths)))
    return lambda xg, vec, ms, coeffs: fused(xg, vec, ms, coeffs, mlp, si2)


def _jax_value_vjp(f, ins, g):
    xg, vec, ms, coeffs = (jnp.asarray(a) for a in ins)
    out, vjp = jax.vjp(lambda a, b: f(a, b, ms, coeffs), xg, vec)
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_value_vjp(conv, ins, mlp, si2, g, how):
    xg, vec = (torch.tensor(a, requires_grad=True) for a in ins[:2])
    ms, coeffs = torch.tensor(ins[2]), torch.tensor(ins[3])
    mw = tuple(torch.tensor(w) for w in mlp)
    sw = tuple(torch.tensor(w) for w in si2)
    if how == 'plain_backward':
        out = conv.plain_geom_forward(xg, vec, ms, coeffs, mw, sw)
        grads = conv.plain_geom_backward(torch.tensor(g), xg, vec, ms,
                                         coeffs, mw, sw)
    else:
        fn = conv.apply_geom if how == 'autograd_fn' else \
            conv.plain_geom_forward
        out = fn(xg, vec, ms, coeffs, mw, sw)
        grads = torch.autograd.grad(out, (xg, vec), torch.tensor(g))
    return out.detach().numpy(), [v.numpy() for v in grads]


def _close_rel(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=REL * max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize('how', ['plain', 'plain_backward', 'autograd_fn'])
@pytest.mark.parametrize('which', ['tiny:0', 'tiny:1', 'checkpoint:1'])
def test_geom_conv_matches_jax_xla_chain(tiny_layers, checkpoint_layers,
                                         which, how):
    layer, lp = _layer(which, tiny_layers, checkpoint_layers)
    ins, mlp, si2, g = _inputs(layer, lp, seed=len(which) + len(how))
    j_out, j_grads = _jax_value_vjp(_jax_xla_chain(layer, lp), ins, g)
    p_out, p_grads = _port_value_vjp(_port_conv(layer), ins, mlp, si2, g,
                                     how)
    _close_rel(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close_rel(a, b)
    # pad rows (ms = 0, unit vector) take no gradient
    pad = ins[2][:, 0] == 0
    assert np.abs(p_grads[0][pad]).max() == 0
    assert np.abs(p_grads[1][pad]).max() == 0


def test_geom_conv_matches_jax_geom_kernel_layer0(tiny_layers):
    """Layer 0's si2 input merges no l > 0 entries, so the interpret-mode
    JAX geometry-fused kernel and the port agree."""
    layer, lp = tiny_layers[0]
    ins, mlp, si2, g = _inputs(layer, lp, seed=3)
    j_out, j_grads = _jax_value_vjp(_jax_geom_kernel(layer, lp), ins, g)
    p_out, p_grads = _port_value_vjp(_port_conv(layer), ins, mlp, si2, g,
                                     'autograd_fn')
    _close_rel(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close_rel(a, b)


def test_geom_spec_attached_by_build():
    """The port's build attaches the same GeomSpec as the JAX build, for
    the tiny config (poly) and the checkpoint (XPLOR)."""
    from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.model import build as pbuild
    from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
    jm = build_e3_equivariant_model(tiny_model_config())
    pm = pbuild.build_e3_equivariant_model(tiny_model_config())
    ck = 'trained_nacl/checkpoint_best.pth.sevennet'
    for jmodel, pmodel in ((jm, pm), (JCK(ck).build_model()[0],
                                      SevenNetCheckpoint(ck).build_model(
                                          'cpu')[0])):
        jg = [l.geom for _, l in jmodel.layers
              if isinstance(l, JL.IrrepsConvolution)]
        pg = [l.geom for l in pmodel.layers.values()
              if isinstance(l, IrrepsConvolution)]
        assert len(jg) == len(pg) > 0
        for a, b in zip(jg, pg):
            assert (a.cutoff, a.num_basis, a.lmax, a.cutoff_kind, a.cutoff_p,
                    a.cutoff_on, a.normalize) == (
                b.cutoff, b.num_basis, b.lmax, b.cutoff_kind, b.cutoff_p,
                b.cutoff_on, b.normalize)
