"""``cg_mode='terms'`` of the port on the CPU against the JAX package.

``FusedConv(cg_mode='terms')`` computes the function of the default mode (its
plain version is the same chain), so on the CPU it is held, values and VJPs
at atol 1e-5 relative to max|ref|, against

  (a) the JAX XLA chain on the tiny config's three convolutions and on one
      full-width layer of the trained checkpoint, for both contracts (a
      D = 32 grid and ``agg_d = 0`` edge rows);
  (b) the JAX ``terms`` Pallas kernels in interpret mode
      (``pallas_conv.set_cg_mode('terms')``) on the tiny layers whose si2
      input merges no l > 0 entries (0 and 2), where the kernel's si2
      layout and the XLA chain's coincide
      (tests/test_torch_fused_conv.py draws the same line for the default
      kernels);
  (c) the JAX engine with Pallas off at model level: energy, forces and
      stress of ``MolecularDynamics(cg_mode='terms')._efs_fn`` (1e-4 eV,
      1e-4 eV/A, 1e-5 eV/A^3), whole-array and chunked.

``test_kernel_tables_reproduce_plain`` replays the arithmetic of
csrc/fused_conv_terms.cu from the tables the kernels read
(``tests/test_torch_terms_plan.py::replay_terms_fwd`` and
``replay_terms_bwd``; the forward's replay is also held against the JAX
``terms`` forward kernel in interpret mode) -- an independent
derivation from the two specs, sharing nothing with the default kernels'
tables -- so the table contract is covered here; the kernels themselves run
only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_nacl
from samples import tiny_model_config
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops.fused_conv_terms import terms_plan
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)
from test_torch_terms_plan import replay_terms_bwd, replay_terms_fwd

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
D, N_ATOMS = 32, 8


@pytest.fixture(autouse=True)
def jax_switches():
    """Interpret mode on; whatever a test sets of the JAX package's module
    switches is put back (as tests/test_pallas_conv.py does)."""
    pallas_conv.set_interpret(True)
    mode = pallas_conv._CG_MODE
    yield
    pallas_conv.set_interpret(False)
    if pallas_conv._CG_MODE != mode:
        pallas_conv.set_cg_mode(mode)
        pallas_conv.make_fused_conv.cache_clear()


@pytest.fixture(scope='module')
def tiny_layers():
    model = jbuild(tiny_model_config())
    params, _ = model.init(jax.random.PRNGKey(0))
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


@pytest.fixture(scope='module')
def checkpoint_layers():
    from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
    model, params = JCK(CKPT).build_model()
    return [(layer, params[name]) for name, layer in model.layers
            if isinstance(layer, JL.IrrepsConvolution)]


def _layer(which, tiny_layers, checkpoint_layers):
    src = tiny_layers if which.startswith('tiny') else checkpoint_layers
    return src[int(which[-1])]


def _inputs(layer, lp, seed, agg_d):
    rng = np.random.default_rng(seed)
    rows = N_ATOMS * D
    xg = rng.normal(size=(rows, layer.tp.irreps_in1.dim)).astype(np.float32)
    sh = rng.normal(size=(rows, layer.tp.irreps_in2.dim)).astype(np.float32)
    emb = rng.normal(size=(rows, layer.weight_nn.hs[0])).astype(np.float32)
    ms = rng.uniform(0.0, 0.1, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0       # pad rows
    mlp = [np.asarray(lp['weight_nn'][f'w{i}']) for i in range(3)]
    si2 = [np.asarray(lp['si2'][f'w{n}'])
           for n in range(len(layer.si2.paths))]
    g = rng.normal(size=(rows // max(agg_d, 1), layer.si2.irreps_out.dim)
                   ).astype(np.float32)
    return (xg, sh, emb, ms), mlp, si2, g


def _port_conv(layer, agg_d, cg_mode='terms'):
    tp = UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                              repr(layer.tp.irreps_in2),
                              repr(layer.tp.irreps_out_filter))
    mlp = FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act)
    si2 = LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out))
    return pfc.FusedConv(tp, mlp, si2, agg_d, cg_mode=cg_mode)


def _jax_xla(layer, lp, agg_d):
    group = max(agg_d, 1)

    def f(xg, sh, emb, ms):
        w = layer.weight_nn.apply(lp['weight_nn'], emb) * ms
        msg = layer.tp.apply(xg, sh, w)
        agg = msg.reshape((msg.shape[0] // group, group)
                          + msg.shape[1:]).sum(1)
        return layer.si2.apply(lp['si2'], agg, skip_bias=True)
    return f


def _jax_value_vjp(f, ins, g):
    out, vjp = jax.vjp(lambda a, b, c: f(a, b, c, jnp.asarray(ins[3])),
                       *[jnp.asarray(x) for x in ins[:3]])
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_value_vjp(conv, ins, mlp, si2, g):
    xg, sh, emb = [torch.tensor(x, requires_grad=True) for x in ins[:3]]
    out = conv(xg, sh, emb, torch.tensor(ins[3]),
               tuple(torch.tensor(w) for w in mlp),
               tuple(torch.tensor(w) for w in si2))
    grads = torch.autograd.grad(out, (xg, sh, emb), torch.tensor(g))
    return out.detach().numpy(), [v.numpy() for v in grads]


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(b).max())))


@pytest.mark.parametrize('which', ['tiny0', 'tiny1', 'tiny2', 'checkpoint1'])
@pytest.mark.parametrize('agg_d', [D, 0], ids=['grid', 'edge_rows'])
def test_terms_mode_matches_jax_xla_chain(tiny_layers, checkpoint_layers,
                                          which, agg_d):
    layer, lp = _layer(which, tiny_layers, checkpoint_layers)
    ins, mlp, si2, g = _inputs(layer, lp, 3, agg_d)
    j_out, j_grads = _jax_value_vjp(_jax_xla(layer, lp, agg_d), ins, g)
    pfc.reset_launch_counts()
    p_out, p_grads = _port_value_vjp(_port_conv(layer, agg_d), ins, mlp, si2,
                                     g)
    assert not any(pfc.launch_counts.values())      # CPU: the plain version
    _close(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close(a, b)


@pytest.mark.parametrize('li', [0, 2])
@pytest.mark.parametrize('agg_d', [D, 0], ids=['grid', 'edge_rows'])
def test_terms_mode_matches_jax_terms_kernel(tiny_layers, li, agg_d):
    """The JAX ``terms`` Pallas kernels in interpret mode, on the layers
    whose si2 input merges no l > 0 entries."""
    layer, lp = tiny_layers[li]
    pallas_conv.set_cg_mode('terms')
    pallas_conv.make_fused_conv.cache_clear()
    fused, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                           layer.si2, block_e=256,
                                           agg_d=agg_d)
    mlp_j = tuple(lp['weight_nn'][f'w{i}'] for i in range(3))
    si2_j = tuple(lp['si2'][f'w{n}'] for n in range(len(layer.si2.paths)))
    ins, mlp, si2, g = _inputs(layer, lp, 10 + li, agg_d)
    j_out, j_grads = _jax_value_vjp(
        lambda xg, sh, emb, ms: fused(xg, sh, emb, ms, mlp_j, si2_j), ins, g)
    p_out, p_grads = _port_value_vjp(_port_conv(layer, agg_d), ins, mlp, si2,
                                     g)
    _close(p_out, j_out)
    for a, b in zip(p_grads, j_grads):
        _close(a, b)


def test_terms_mode_has_no_geom_and_no_ext_w(tiny_layers):
    layer, _ = tiny_layers[0]
    conv = _port_conv(layer, D)
    assert conv.cg_mode == 'terms'
    with pytest.raises(ValueError):
        pfc.FusedConv(conv.tp, conv.mlp, conv.si2, D, ext_w=True,
                      cg_mode='terms')
    with pytest.raises(ValueError):
        pfc.FusedConv(conv.tp, conv.mlp, conv.si2, D, cg_mode='fullwidth')


# -- the kernels' arithmetic, driven by their tables -------------------------

def _replay(conv, xg, sh, emb, ms, mlp_ws, si2_ws, g):
    """Output rows and (dxg, dsh, demb) computed the way
    csrc/fused_conv_terms.cu does, from the plans' host tables: the forward
    by ``tests/test_torch_terms_plan.py::replay_terms_fwd`` (the SH folded
    into the CG), the backward by ``replay_terms_bwd`` (the CG folded with
    the message cotangent)."""
    return (replay_terms_fwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws),
            replay_terms_bwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws, g))


@pytest.mark.parametrize('which', ['tiny1', 'checkpoint0', 'checkpoint1',
                                   'checkpoint4'])
@pytest.mark.parametrize('agg_d', [D, 0], ids=['grid', 'edge_rows'])
def test_kernel_tables_reproduce_plain(tiny_layers, checkpoint_layers, which,
                                       agg_d):
    layer, lp = _layer(which, tiny_layers, checkpoint_layers)
    conv = _port_conv(layer, agg_d)
    ins, mlp, si2, g = _inputs(layer, lp, 7, agg_d)
    xg, sh, emb, ms = (torch.tensor(x) for x in ins)
    mlp_ws = tuple(torch.tensor(v) for v in mlp)
    si2_ws = tuple(torch.tensor(v) for v in si2)
    gt = torch.tensor(g)
    ref_out = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    ref_grads = conv.plain_backward(gt, xg, sh, emb, ms, mlp_ws, si2_ws)
    out, grads = _replay(conv, xg, sh, emb, ms, mlp_ws, si2_ws, gt)
    _close(out.numpy(), ref_out.numpy())
    for a, b in zip(grads, ref_grads):
        _close(a.numpy(), b.numpy())
        assert float(a[(ms == 0).reshape(-1)].abs().max()) == 0.0


@pytest.mark.parametrize('li', [0, 2])
@pytest.mark.parametrize('agg_d', [D, 0], ids=['grid', 'edge_rows'])
def test_fwd_tables_match_jax_terms_kernel(tiny_layers, li, agg_d):
    """The terms forward's tables, replayed (the SH folded into the CG per
    row), against the JAX ``terms`` forward kernel in interpret mode, on
    the layers whose si2 input merges no l > 0 entries."""
    layer, lp = tiny_layers[li]
    pallas_conv.set_cg_mode('terms')
    pallas_conv.make_fused_conv.cache_clear()
    fused, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                           layer.si2, block_e=256,
                                           agg_d=agg_d)
    ins, mlp, si2, _ = _inputs(layer, lp, 20 + li, agg_d)
    j_out = np.asarray(fused(*(jnp.asarray(x) for x in ins),
                             tuple(jnp.asarray(w) for w in mlp),
                             tuple(jnp.asarray(w) for w in si2)))
    out = replay_terms_fwd(_port_conv(layer, agg_d),
                           *(torch.tensor(x) for x in ins),
                           tuple(torch.tensor(w) for w in mlp),
                           tuple(torch.tensor(w) for w in si2))
    _close(out.numpy(), j_out)


def test_terms_plan_is_independent_of_the_default_tables(checkpoint_layers):
    """Live instructions, live MLP columns and si2 rows of the ``terms`` plan
    against what the default kernels' plan says, derived separately."""
    layer, _ = checkpoint_layers[1]
    conv = _port_conv(layer, D, cg_mode='cmshared')
    P = terms_plan(conv.tp, conv.si2)
    t = conv.kernel_tables(torch.device('cpu'))
    assert sorted(P.live_cols.tolist()) == sorted(t.col_w.tolist())
    assert P.ins.shape[0] == t.n_ins and len(P.live_cols) == 576
    assert P.d_msg == conv.tp.irreps_out.dim == 3136
    assert (P.col_path >= 0).all() and (P.msg_path >= 0).sum() == t.agg_dim
    layer0, _ = checkpoint_layers[0]
    P0 = terms_plan(_port_conv(layer0, D).tp, _port_conv(layer0, D).si2)
    assert (P0.col_path < 0).any()       # columns no si2 path feeds


# -- model level -------------------------------------------------------------

def _port_atoms(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


@pytest.fixture(scope='module')
def tiny_pair():
    cfg = tiny_model_config()
    jmodel = jbuild(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(5))
    model = build_e3_equivariant_model(cfg)
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, model


@pytest.fixture(scope='module')
def jax_efs(tiny_pair):
    """Structure and the JAX engine's E, F, stress on it (Pallas off)."""
    jmodel, jparams, _ = tiny_pair
    at = build_nacl(64, rattle=0.1, seed=3)
    # a = 4.4: two neighbor shells inside the tiny config's 4.0 A cutoff
    scale = 4.4 / 5.63
    at = type(at)(at.atomic_numbers, at.pos * scale, at.cell * scale, at.pbc)
    jmd = JMD(jmodel, jparams, at, ensemble='npt', rebuild_every=10,
              use_pallas=False)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos, jmd.state.cell),
                          jmd.state.pos, jmd.state.cell)
    je, jf, js = jmd._efs_fn(jmd.state.pos, jnl, jmd.state.cell)
    assert float(np.abs(np.asarray(jf)).max()) > 1e-3      # edges exist
    return at, float(je), np.asarray(jf), np.asarray(js)


@pytest.mark.parametrize('chunk_atoms', [0, 24], ids=['whole', 'chunked'])
def test_engine_efs_with_terms_matches_jax_engine(tiny_pair, jax_efs,
                                                  chunk_atoms):
    _, _, model = tiny_pair
    at, je, jf, js = jax_efs
    md = MolecularDynamics(model, _port_atoms(at), ensemble='npt',
                           rebuild_every=10, device='cpu', cg_mode='terms',
                           conv_chunk_atoms=chunk_atoms)
    assert bool(md.conv_chunk_rows) == bool(chunk_atoms)
    e, f, s = md._efs_fn(md.state.pos, md._grid(), md.state.cell)
    assert abs(float(e) - float(je)) <= 1e-4
    assert np.abs(f.numpy() - np.asarray(jf)).max() <= 1e-4
    assert np.abs(s.numpy() - np.asarray(js)).max() <= 1e-5
    md_default = MolecularDynamics(model, _port_atoms(at), ensemble='npt',
                                   rebuild_every=10, device='cpu')
    e2, f2, s2 = md_default._efs_fn(md.state.pos, md_default._grid(),
                                    md.state.cell)
    assert float(e2) == float(e) and torch.equal(f2, f) and torch.equal(s2, s)


def test_engine_and_calculator_refuse_what_terms_lacks(tiny_pair):
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    _, _, model = tiny_pair
    at = _port_atoms(build_nacl(64, rattle=0.1, seed=3))
    for kw in ({'half_mlp': True}, {'geom_dense': True}):
        with pytest.raises(ValueError, match='terms'):
            MolecularDynamics(model, at, device='cpu', cg_mode='terms', **kw)
    with pytest.raises(ValueError, match='cg_mode'):
        MolecularDynamics(model, at, device='cpu', cg_mode='cm')
    with pytest.raises(ValueError, match='cg_mode'):
        SevenNetCalculator(model, device='cpu', cg_mode='cm')
    # chunks run with shared sh/emb under 'terms', whatever geom_fused says
    md = MolecularDynamics(model, at, device='cpu', cg_mode='terms',
                           conv_chunk_atoms=16, geom_fused=True)
    data = md._graph(md.state.pos, md._grid())
    import sevennet_exp_tpu_torch._keys as KEY
    assert data[KEY.EDGE_GEOM_PACKED] is False
    assert data[pfc.CG_MODE_KEY] == 'terms'
    a = SevenNetCalculator(model, device='cpu', cg_mode='terms').calculate(at)
    b = SevenNetCalculator(model, device='cpu').calculate(at)
    # the same plain chain; index_add_ adds in no fixed order
    assert abs(a['energy'] - b['energy']) <= 1e-6
    assert np.abs(a['forces'] - b['forces']).max() <= 1e-6
