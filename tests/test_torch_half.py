"""The half-list radial MLP path of the port on the CPU against the JAX
package.

  - ``half_pair_indices`` / ``half_gather`` / ``pair_spread`` on an engine
    grid: indices equal to the JAX functions', values equal, gradients
    within 1e-6;
  - the external-weight fused conv: ``plain_extw_forward/backward`` (and
    the autograd wrapper, which takes them on CPU tensors) against JAX
    ``make_fused_conv(ext_w=True)`` in interpret mode on the tiny config
    (atol 1e-5; tiny layer 1 merges l > 0 si2 entries, where the JAX
    kernel and the XLA chain differ, so layers 0 and 2), and against the
    port's own kernel-1 plain chain fed ``weff = MLP(emb) * ms`` (1e-6);
  - the engine with ``half_mlp=True`` against the JAX engine's XLA path and
    against the port's default path: |dE| <= 1e-4 eV, max|dF| <= 1e-4 eV/A,
    on the tiny model and on the trained checkpoint; a grid with a degree
    overflow carries no half list and runs the default path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_nacl
from samples import tiny_model_config
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu.ops import scatter as jsc
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    params_from_numpy,
)
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops import scatter as psc
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
D, N_ATOMS = 32, 8


def _port_atoms(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


# -- the half-list index helpers ---------------------------------------------

@pytest.fixture(scope='module')
def grid_rev():
    """rev of a 64-atom engine grid (2,048 rows, pads included)."""
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    md = MolecularDynamics(model, _port_atoms(build_nacl(64, rattle=0.1,
                                                         seed=3)),
                           device='cpu', rebuild_every=20)
    g = md._grid()
    return g.rev, g.valid


def test_half_pair_indices_equal_jax(grid_rev):
    rev, valid = grid_rev
    half, pair = psc.half_pair_indices(rev)
    jh, jp = jsc.half_pair_indices(jnp.asarray(rev.numpy(), jnp.int32))
    assert np.array_equal(half.numpy(), np.asarray(jh))
    assert np.array_equal(pair.numpy(), np.asarray(jp))
    e_cap = rev.shape[0]
    assert half.shape == (e_cap // 2,) and pair.shape == (e_cap,)
    n_real = int(valid.sum())
    assert int((half < e_cap).sum()) == n_real // 2
    r, h, p = rev.numpy(), half.numpy(), pair.numpy()
    real = np.nonzero(r != np.arange(e_cap))[0]
    assert np.array_equal(h[p[real]], np.minimum(real, r[real]))
    assert (p[r == np.arange(e_cap)] == 0).all()       # pads keep pair 0


def test_half_gather_and_pair_spread_equal_jax(grid_rev):
    rev, _ = grid_rev
    half, pair = psc.half_pair_indices(rev)
    e_cap = rev.shape[0]
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(e_cap, 5)).astype(np.float32)
    wh = rng.normal(size=(e_cap // 2, 7)).astype(np.float32)
    ct_h = rng.normal(size=(e_cap // 2, 5)).astype(np.float32)
    ct_e = rng.normal(size=(e_cap, 7)).astype(np.float32)
    jr, jh, jp = (jnp.asarray(a.numpy(), jnp.int32)
                  for a in (rev, half, pair))

    out, vjp = jax.vjp(lambda r: jsc.half_gather(r, jh, jp),
                       jnp.asarray(rows))
    t = torch.tensor(rows, requires_grad=True)
    mine = psc.half_gather(t, half, pair)
    (grad,) = torch.autograd.grad(mine, t, torch.tensor(ct_h))
    assert np.array_equal(mine.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct_h))[0]),
                               atol=1e-6, rtol=0)

    out, vjp = jax.vjp(lambda w: jsc.pair_spread(w, jp, jh, jr),
                       jnp.asarray(wh))
    t = torch.tensor(wh, requires_grad=True)
    mine = psc.pair_spread(t, pair, half, rev)
    (grad,) = torch.autograd.grad(mine, t, torch.tensor(ct_e))
    assert np.array_equal(mine.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct_e))[0]),
                               atol=1e-6, rtol=0)


def test_pair_spread_backward_is_the_scatter_add_where_read(grid_rev):
    """Under the mask scale (0 on pads) the scatter-free backward equals
    autograd's scatter-add of the plain gather."""
    rev, _ = grid_rev
    half, pair = psc.half_pair_indices(rev)
    e_cap = rev.shape[0]
    rng = np.random.default_rng(1)
    wh = rng.normal(size=(e_cap // 2, 4)).astype(np.float32)
    scale = (rev != torch.arange(e_cap)).float()[:, None]
    a = torch.tensor(wh, requires_grad=True)
    b = torch.tensor(wh, requires_grad=True)
    ((psc.pair_spread(a, pair, half, rev) * scale) ** 2).sum().backward()
    ((b[pair] * scale) ** 2).sum().backward()
    live = (half < e_cap).numpy()
    np.testing.assert_allclose(a.grad.numpy()[live], b.grad.numpy()[live],
                               atol=1e-6, rtol=1e-6)
    assert (a.grad.numpy()[~live] == 0).all()


# -- the external-weight fused conv ------------------------------------------

@pytest.fixture
def interpret_mode():
    pallas_conv.set_interpret(True)
    yield
    pallas_conv.set_interpret(False)


@pytest.fixture(scope='module')
def tiny_layers():
    model = jbuild(tiny_model_config())
    params, _ = model.init(jax.random.PRNGKey(0))
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


def _port_conv(layer, ext_w):
    tp = UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                              repr(layer.tp.irreps_in2),
                              repr(layer.tp.irreps_out_filter))
    mlp = FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act)
    si2 = LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out))
    return pfc.FusedConv(tp, mlp, si2, D, ext_w=ext_w)


def _extw_inputs(layer, lp, seed):
    rng = np.random.default_rng(seed)
    rows = N_ATOMS * D
    xg = rng.normal(size=(rows, layer.tp.irreps_in1.dim)).astype(np.float32)
    sh = rng.normal(size=(rows, layer.tp.irreps_in2.dim)).astype(np.float32)
    emb = rng.normal(size=(rows, layer.weight_nn.hs[0])).astype(np.float32)
    ms = rng.uniform(0.01, 0.1, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0          # grid pad rows
    weff = np.asarray(layer.weight_nn.apply(lp['weight_nn'],
                                            jnp.asarray(emb))) * ms
    si2 = [np.asarray(lp['si2'][f'w{n}'])
           for n in range(len(layer.si2.paths))]
    g = rng.normal(size=(N_ATOMS, layer.si2.irreps_out.dim)).astype(
        np.float32)
    return (xg, sh, weff.astype(np.float32)), emb, ms, si2, g


@pytest.mark.parametrize('li', [0, 2])
@pytest.mark.parametrize('wrapper', [False, True],
                         ids=['plain', 'autograd_fn'])
def test_extw_matches_jax_kernel(tiny_layers, interpret_mode, li, wrapper):
    layer, lp = tiny_layers[li]
    ins, _, ms, si2, g = _extw_inputs(layer, lp, seed=li)
    fusedw, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                            layer.si2, agg_d=D, ext_w=True)
    si2_j = tuple(jnp.asarray(w) for w in si2)
    j_out, vjp = jax.vjp(lambda a, b, c: fusedw(a, b, c, si2_j),
                         *[jnp.asarray(x) for x in ins])
    j_grads = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    conv = _port_conv(layer, ext_w=True)
    xg, sh, weff = [torch.tensor(x, requires_grad=True) for x in ins]
    sw = tuple(torch.tensor(w) for w in si2)
    if wrapper:
        out = conv(xg, sh, weff, sw)
        grads = torch.autograd.grad(out, (xg, sh, weff), torch.tensor(g))
    else:
        out = conv.plain_extw_forward(xg, sh, weff, sw)
        grads = conv.plain_extw_backward(torch.tensor(g), xg, sh, weff, sw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5, rtol=0)
    live = (ms != 0)
    for name, a, b in zip(('dxg', 'dsh', 'dweff'), grads, j_grads):
        if name == 'dweff':
            # the JAX kernel leaves dweff of the pad rows to the caller's
            # zero scale; the port writes zeros there
            assert (a.numpy()[~live[:, 0]] == 0).all()
            b = b * live
        np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5, rtol=0)


@pytest.mark.parametrize('li', [0, 1, 2])
def test_extw_matches_own_plain_chain(tiny_layers, li):
    """weff = MLP(emb) * ms fed to the external-weight plain version gives
    the node rows, dxg and dsh of the kernel-1 plain chain, and dweff
    carried through the MLP by autograd gives its demb."""
    layer, lp = tiny_layers[li]
    (xg, sh, _), emb, ms, si2, g = _extw_inputs(layer, lp, seed=20 + li)
    mw = tuple(torch.tensor(np.asarray(lp['weight_nn'][f'w{i}']))
               for i in range(3))
    sw = tuple(torch.tensor(w) for w in si2)
    base, extw = _port_conv(layer, False), _port_conv(layer, True)
    a = [torch.tensor(x, requires_grad=True) for x in (xg, sh, emb)]
    b = [torch.tensor(x, requires_grad=True) for x in (xg, sh, emb)]
    ms_t, g_t = torch.tensor(ms), torch.tensor(g)
    y0 = base(a[0], a[1], a[2], ms_t, mw, sw)
    weff = base.mlp.apply({f'w{i}': w for i, w in enumerate(mw)},
                          b[2]) * ms_t
    y1 = extw(b[0], b[1], weff, sw)
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               atol=1e-6, rtol=0)
    for u, v in zip(torch.autograd.grad(y1, b, g_t),
                    torch.autograd.grad(y0, a, g_t)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=0,
                                   atol=1e-6 * max(1.0, float(v.abs().max())))


def test_extw_cost_model_counts_no_mlp(tiny_layers):
    layer, lp = tiny_layers[1]
    (xg, sh, weff), emb, ms, si2, g = _extw_inputs(layer, lp, seed=4)
    conv = _port_conv(layer, True)
    f0, b0, real0 = pfc.conv_cost(conv, torch.tensor(ms))
    f1, b1, real1 = pfc.conv_cost(conv, torch.tensor(weff), ext_w=True)
    assert real0 == real1 == float((ms != 0).sum())
    assert f1 < f0 and b1 < b0
    by0 = pfc.conv_bytes(conv, torch.tensor(ms))
    by1 = pfc.conv_bytes(conv, torch.tensor(weff), ext_w=True)
    t = conv.kernel_tables(torch.device('cpu'))
    assert by1[0] > by0[0]            # the weights are read, not computed
    assert by1[1] - by1[0] == 4.0 * (ms.shape[0] * (conv.d1 + conv.f)
                                     + real1 * t.n_active)
    assert t.n_dead == conv.w_numel - t.n_active


# -- the engine --------------------------------------------------------------

def _jax_ef(jmodel, jparams, at, **kw):
    jmd = JMD(jmodel, jparams, at, ensemble='nvt', rebuild_every=20,
              use_pallas=False, **kw)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    e, f = jmd._ef_fn(jmd.state.pos, jnl)
    return float(e), np.asarray(f)


@pytest.mark.parametrize('which', ['tiny', 'checkpoint'])
def test_engine_half_mlp_matches_jax_xla_and_default(which):
    at = build_nacl(64, rattle=0.1, seed=2)
    if which == 'tiny':
        cfg = tiny_model_config()
        jmodel = jbuild(cfg)
        jparams, _ = jmodel.init(jax.random.PRNGKey(5))
        model = build_e3_equivariant_model(cfg)
        model.load_state(params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams)))
    else:
        jmodel, jparams = JCK(CKPT).build_model()
        model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    e_j, f_j = _jax_ef(jmodel, jparams, at)
    out = {}
    for half in (False, True):
        md = MolecularDynamics(model, _port_atoms(at), device='cpu',
                               rebuild_every=20, half_mlp=half)
        g = md._grid()
        assert (g.half is not None) == half
        data = md._graph(md.state.pos, g)
        assert ('edge_half' in data) == half
        pfc.reset_launch_counts()
        e, f = md._ef_fn(md.state.pos, g)
        assert not any(pfc.launch_counts.values())      # CPU: plain versions
        out[half] = float(e), f.numpy()
    for e, f in out.values():
        assert abs(e - e_j) <= 1e-4
        assert np.abs(f - f_j).max() <= 1e-4
    assert abs(out[True][0] - out[False][0]) <= 1e-4
    assert np.abs(out[True][1] - out[False][1]).max() <= 1e-4


def test_half_list_runs_the_extw_conv(monkeypatch):
    """With the option on, every convolution goes through the
    external-weight fused conv; with it off, none does."""
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    at = _port_atoms(build_nacl(64))
    calls = []
    orig = pfc.FusedConv.extw_forward
    monkeypatch.setattr(
        pfc.FusedConv, 'extw_forward',
        lambda self, *a: (calls.append(self.ext_w), orig(self, *a))[1])
    for half, want in ((True, 5), (False, 0)):
        del calls[:]
        md = MolecularDynamics(model, at, device='cpu', half_mlp=half)
        md._ef_fn(md.state.pos, md._grid())
        assert calls == [True] * want


def test_degree_overflow_never_feeds_the_half_list():
    """A grid compacted with too small a degree capacity flags
    overflow_deg; it then carries no half list, the force call runs the
    default path, and ``_grid`` regrows the capacity before a half list
    is built."""
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    at = _port_atoms(build_nacl(64))
    md = MolecularDynamics(model, at, device='cpu', half_mlp=True)
    ref = MolecularDynamics(model, at, device='cpu')
    pos = md.state.pos
    md.deg_cap = ref.deg_cap = 16          # NaCl at 5.5 A: 18 neighbors
    small = md._compact_nl(md._build_nl(pos), pos)
    assert bool(small.overflow_deg)
    assert small.half is None and small.pair is None
    assert 'edge_half' not in md._graph(pos, small)
    e, f = md._ef_fn(pos, small)
    e_r, f_r = ref._ef_fn(pos, ref._compact_nl(ref._build_nl(pos), pos))
    assert float(e) == float(e_r) and torch.equal(f, f_r)
    md._verlet = None
    g = md._grid()
    assert md.deg_cap > 16 and not bool(g.overflow_deg)
    assert g.half is not None


def test_chunked_path_does_not_consult_the_half_list():
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    md = MolecularDynamics(model, _port_atoms(build_nacl(64)), device='cpu',
                           half_mlp=True, conv_chunk_atoms=16)
    g = md._grid()
    assert g.half is None
    assert 'edge_half' not in md._graph(md.state.pos, g)
