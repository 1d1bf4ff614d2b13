"""The port's single-point path on the CPU against the JAX package: host
graph build, the plain edge-list convolution, forces and stress, and the
calculator.

  - ``neighbor_list``: the same directed edges, vectors and shifts as the
    JAX package's (which may come from its compiled C++ routine in another
    order: both are sorted first), on cubic, sheared and open cells;
    ``unlabeled_atoms_to_graph`` + ``collate_graphs`` give equal arrays
    from the same graph;
  - ``SevenNetCalculator`` against the JAX ``SevenNetCalculator
    (use_pallas=False)``: tiny config (random weights) and the trained
    checkpoint, on a 64-atom rattled and on a sheared, strained NaCl:
    E 1e-4 eV (against the float64 sum of JAX's atomic energies; 4 float32
    ulps against its float32 total where that is more), F 1e-4 eV/A,
    stress 1e-5 eV/A^3 (both fp32);
  - the stress against a central finite difference of the energy under
    strain, in float64 on the trained checkpoint: 1e-6 eV/A^3;
  - the edge-list branch against the dense-grid branch (the MD engine) on
    one structure: E 1e-4 eV, F 1e-4 eV/A.
"""

import jax
import numpy as np
import pytest
import torch

from samples import h2o_molecule, tiny_model_config
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.data import graph as jgraph
from sevennet_exp_tpu.data.neighborlist import neighbor_list as j_neighbor_list
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    params_from_numpy,
)
from sevennet_exp_tpu_torch.data import graph as pgraph
from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
from sevennet_exp_tpu_torch.data.neighborlist import neighbor_list
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import fused_conv as pfc

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5
STRAIN = np.eye(3) + np.array([[0.02, 0.01, 0.008], [0.01, -0.01, 0.015],
                               [0.008, 0.015, 0.0]])


def _structure(which):
    """64-atom NaCl rattled by 0.1 A; 'sheared': under a 2 % strain with
    shear, so that the cell is triclinic and all six stress components
    are far from zero."""
    at = build_nacl(64, rattle=0.1, seed=1)
    if which == 'sheared':
        at = Atoms(at.atomic_numbers, at.pos @ STRAIN, at.cell @ STRAIN,
                   at.pbc)
    return at


def _jax_atoms(at):
    return jgraph.Atoms(atomic_numbers=at.atomic_numbers, pos=at.pos,
                        cell=at.cell, pbc=at.pbc)


def _sorted_edges(ei, ej, vec, shift):
    order = np.lexsort((shift[:, 2], shift[:, 1], shift[:, 0], ej, ei))
    return ei[order], ej[order], vec[order], shift[order]


# -- host graph build --------------------------------------------------------

@pytest.mark.parametrize('which', ['rattled', 'sheared', 'small_cell',
                                   'molecule', 'slab'])
def test_neighbor_list_equals_jax(which):
    if which in ('rattled', 'sheared'):
        at, rc = _structure(which), 5.0
    elif which == 'small_cell':          # cutoff > cell: several images
        at, rc = build_nacl(8, rattle=0.05, seed=2), 7.0
        at = Atoms(at.atomic_numbers[:8], at.pos[:8], at.cell / 2, at.pbc)
    elif which == 'molecule':
        m = h2o_molecule()
        at, rc = Atoms(m.atomic_numbers, m.pos, m.cell, m.pbc), 4.0
    else:                                # periodic in x and y only
        at, rc = _structure('rattled'), 5.0
        at = Atoms(at.atomic_numbers, at.pos, at.cell,
                   np.array([True, True, False]))
    mine = neighbor_list(at.pos, at.cell, at.pbc, rc)
    theirs = j_neighbor_list(at.pos, at.cell, at.pbc, rc)
    assert len(mine[0]) == len(theirs[0]) > 0
    assert (np.diff(mine[0]) >= 0).all()          # centers ascending
    for a, b in zip(_sorted_edges(*mine), _sorted_edges(*theirs)):
        if a.dtype.kind == 'f' and a.shape[1:] == (3,) and a is not None:
            np.testing.assert_allclose(a, b, atol=1e-12, rtol=0)
        else:
            assert np.array_equal(a, b)
    assert (np.einsum('ij,ij->i', mine[2], mine[2]) < rc * rc).all()


def test_graph_and_collate_equal_jax():
    at = _structure('sheared')
    g = pgraph.unlabeled_atoms_to_graph(at, 5.0)
    jg = jgraph.unlabeled_atoms_to_graph(_jax_atoms(at), 5.0)
    assert set(g) == set(jg)
    assert g[KEY.EDGE_IDX].shape == jg[KEY.EDGE_IDX].shape
    for k in (KEY.ATOMIC_NUMBERS, KEY.POS, KEY.CELL, KEY.CELL_VOLUME,
              KEY.NUM_ATOMS):
        assert np.array_equal(g[k], jg[k]) and g[k].dtype == jg[k].dtype
    assert pgraph.pad_cap(1000) == jgraph.pad_cap(1000) == 1000
    assert pgraph.pad_cap(26000, 256, 1.2) == jgraph.pad_cap(26000, 256, 1.2)
    assert pgraph.pad_cap(3) == jgraph.pad_cap(3) == 8
    # the same graphs through both collations: every array equal
    small = pgraph.unlabeled_atoms_to_graph(build_nacl(8), 5.0)
    n_edge = pgraph.pad_cap(g[KEY.EDGE_IDX].shape[1]
                            + small[KEY.EDGE_IDX].shape[1], 256, 1.2)
    kw = dict(n_node=136, n_edge=n_edge, n_graph=3)
    mine = pgraph.collate_graphs([g, small], **kw)
    theirs = jgraph.collate_graphs([g, small], **kw)
    assert set(mine) == set(theirs)
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        assert np.array_equal(mine[k], theirs[k]), k
    with pytest.raises(ValueError):
        pgraph.collate_graphs([g], n_node=8)


# -- the calculator ----------------------------------------------------------

@pytest.fixture(scope='module')
def models():
    cfg = tiny_model_config()
    jtiny = jbuild(cfg)
    jtiny_params, _ = jtiny.init(jax.random.PRNGKey(5))
    tiny = build_e3_equivariant_model(cfg)
    tiny.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtiny_params)))
    jmodel, jparams = JCK(CKPT).build_model()
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    return {'tiny': (jtiny, jtiny_params, tiny),
            'checkpoint': (jmodel, jparams, model)}


@pytest.mark.parametrize('which', ['rattled', 'sheared'])
@pytest.mark.parametrize('name', ['tiny', 'checkpoint'])
def test_calculator_matches_jax(models, name, which):
    jmodel, jparams, model = models[name]
    at = _structure(which)
    ref = JCalc(model=jmodel, params=jparams, use_pallas=False
                ).calculate_single(_jax_atoms(at))
    calc = SevenNetCalculator(model, device='cpu')
    pfc.reset_launch_counts()
    res = calc.calculate(at)
    assert not any(pfc.launch_counts.values())       # CPU: plain versions
    # the port sums the atomic energies in float64, JAX in float32: its
    # total may be a few float32 ulps off (the tiny model's random weights
    # give |E| = 632 eV, one ulp = 6.1e-5 eV), so the port's total is held
    # to 1e-4 eV against the float64 sum of JAX's atomic energies, and to
    # 1e-4 eV or 4 ulps against JAX's own total
    assert abs(res['energy']
               - ref['energies'].astype(np.float64).sum()) <= E_TOL
    ulp = float(np.spacing(np.float32(abs(ref['energy']))))
    assert abs(res['energy'] - ref['energy']) <= max(E_TOL, 4 * ulp)
    assert res['free_energy'] == res['energy']
    assert res['forces'].shape == (64, 3) and res['stress'].shape == (6,)
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert np.abs(res['energies'] - ref['energies']).max() <= E_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= S_TOL
    if which == 'sheared' and name == 'checkpoint':
        assert np.abs(ref['stress']).min() > 10 * S_TOL
    assert calc.get_potential_energy() == res['energy']
    assert calc.get_forces() is res['forces']
    assert calc.get_stress() is res['stress']


class _DuckAtoms:
    """What an ase.Atoms offers the calculator."""

    def __init__(self, at):
        self._at = at

    def get_atomic_numbers(self):
        return self._at.atomic_numbers

    def get_positions(self):
        return self._at.pos

    def get_cell(self):
        return self._at.cell

    def get_pbc(self):
        return self._at.pbc


def test_calculator_surface(models):
    _, _, model = models['checkpoint']
    from_path = SevenNetCalculator(CKPT, device='cpu')
    assert from_path.cutoff == 5.0 and from_path.type_map == model.type_map
    assert from_path.device == torch.device('cpu')
    at = _structure('rattled')
    e = from_path.get_potential_energy(_DuckAtoms(at))
    calc = SevenNetCalculator(model, device='cpu')
    assert calc.get_potential_energy(at) == e
    # capacities are bucketed and only grow
    assert calc._caps == (64, jgraph.pad_cap(
        len(neighbor_list(at.pos, at.cell, at.pbc, 5.0)[0]), 256, 1.2))
    caps = calc._caps
    m = h2o_molecule()
    small = Atoms(np.array([11, 17, 11]), m.pos * 2.5, m.cell, m.pbc)
    f = calc.get_forces(small)
    assert f.shape == (3, 3) and calc._caps == caps
    alone = SevenNetCalculator(model, device='cpu').get_forces(small)
    np.testing.assert_allclose(f, alone, atol=1e-6, rtol=0)
    with pytest.raises(NotImplementedError):
        SevenNetCalculator(model, device='cpu', modal='x')
    import inspect
    assert inspect.signature(SevenNetCalculator.__init__).parameters[
        'device'].default == 'cuda'


def test_stress_is_the_strain_derivative_of_the_energy(models):
    """sigma_ab = (1/V) dE/dF_ab by a central difference (h = 1e-4) of the
    energy under the deformation x -> x (1 + F), on the trained checkpoint
    in float64, where the difference quotient is good to ~1e-8: every
    component (each > 1e-4 in size) within 1e-6 eV/A^3, in the ASE order
    and sign. The model's Voigt entries are sum r_a f_b for (a, b) = xx,
    yy, zz, xy, yz, zx, not symmetrised; the test deforms one F_ab at a
    time accordingly. For a rotation-invariant energy that equals the
    derivative under symmetric strain; the checkpoint's convolution
    layout is not quite invariant (a known fault shared with the JAX XLA
    path), and under symmetric strain the shear entries are off by
    ~2e-6."""
    import copy
    _, _, trained = models['checkpoint']
    model = copy.deepcopy(trained).double()
    at = _structure('sheared')
    vol = at.volume

    def batch(a):
        g = pgraph.unlabeled_atoms_to_graph(a, model.cutoff)
        b = pgraph.collate_graphs([g], dtype=np.float64)
        return {k: torch.as_tensor(
                    v, dtype=torch.long if v.dtype.kind == 'i' else None)
                for k, v in b.items()}

    out = model.apply(batch(at))
    raw = out[KEY.PRED_STRESS][0].numpy()
    stress = -raw[[0, 1, 2, 4, 5, 3]]            # as the calculator
    h = 1e-4
    voigt = [(0, 0), (1, 1), (2, 2), (1, 2), (2, 0), (0, 1)]
    for comp, (a, b) in enumerate(voigt):
        es = []
        for sign in (+1, -1):
            m = np.eye(3)
            m[a, b] += 0.5 * sign * h
            strained = Atoms(at.atomic_numbers, at.pos @ m, at.cell @ m,
                             at.pbc)
            es.append(float(model.energy(batch(strained))))
        fd = (es[0] - es[1]) / h / vol
        assert abs(fd - stress[comp]) <= 1e-6, (comp, fd, stress[comp])
    assert np.abs(stress).min() > 1e-4
    # forces: -dE/dpos, which sum to zero
    assert np.abs(out[KEY.PRED_FORCE].numpy().sum(0)).max() < 1e-9


@pytest.mark.parametrize('name', ['tiny', 'checkpoint'])
def test_edge_list_branch_matches_dense_grid_branch(models, name):
    _, _, model = models[name]
    at = _structure('rattled')
    res = SevenNetCalculator(model, device='cpu').calculate(at)
    md = MolecularDynamics(model, at, device='cpu', rebuild_every=20)
    e, f = md._ef_fn(md.state.pos, md._grid())
    assert abs(res['energy'] - float(e)) <= E_TOL
    assert np.abs(res['forces'] - f.numpy()).max() <= F_TOL


def test_apply_on_the_dense_grid_uses_rev(models):
    """``apply`` on a grid (EDGE_REV + EDGE_DENSE_D): forces by the two
    reshape-sums equal the engine's -dE/dpos, and the virial equals the
    calculator's stress."""
    _, _, model = models['checkpoint']
    at = _structure('sheared')
    md = MolecularDynamics(model, at, device='cpu', rebuild_every=20)
    g = md._grid()
    e, f = md._ef_fn(md.state.pos, g)
    data = md._graph(md.state.pos, g)
    data[KEY.CELL_VOLUME] = torch.tensor([at.volume], dtype=torch.float32)
    out = model.apply(data)
    assert abs(float(out[KEY.PRED_TOTAL_ENERGY][0]) - float(e)) <= 1e-5
    np.testing.assert_allclose(out[KEY.PRED_FORCE].numpy(), f.numpy(),
                               atol=1e-5, rtol=0)
    res = SevenNetCalculator(model, device='cpu').calculate(at)
    stress = -out[KEY.PRED_STRESS][0].numpy()[[0, 1, 2, 4, 5, 3]]
    np.testing.assert_allclose(stress, res['stress'], atol=1e-6, rtol=0)
    assert KEY.PRED_STRESS not in model.apply(data, compute_stress=False)


def test_pad_atoms_are_inert(models):
    """A batch padded to more atoms than the structure has: the pad atoms
    (Z = 0, type index -1) embed as zeros, and a 3-atom cluster in a
    64-atom bucket gives the JAX calculator's energy and forces."""
    from sevennet_exp_tpu_torch.model.layers import OnehotEmbedding
    emb = OnehotEmbedding(2)({KEY.NODE_FEATURE: torch.tensor([1, -1, 0])})
    assert emb[KEY.NODE_FEATURE].tolist() == [[0., 1.], [0., 0.], [1., 0.]]
    jmodel, jparams, model = models['checkpoint']
    m = h2o_molecule()
    small = Atoms(np.array([11, 17, 11]), m.pos * 2.5, m.cell, m.pbc)
    ref = JCalc(model=jmodel, params=jparams, use_pallas=False
                ).calculate_single(_jax_atoms(small))
    calc = SevenNetCalculator(model, device='cpu')
    calc._caps = (64, 2048)
    res = calc.calculate(small)
    assert calc._caps == (64, 2048)
    assert abs(res['energy'] - ref['energy']) <= E_TOL
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert res['energies'].shape == (3,)


@pytest.mark.parametrize('li', [0, 2])
def test_edge_row_conv_matches_jax_kernel(li):
    """The fused conv's edge-row contract (agg_d = 0: one output row per
    edge, si2 per row): the port's plain version and autograd wrapper
    against JAX ``make_fused_conv()`` in interpret mode on the tiny
    config's layers whose si2 merges no l > 0 entries, 256 rows in no
    grid order: rows and VJPs at atol 1e-5."""
    import jax.numpy as jnp
    from sevennet_exp_tpu.model import layers as JL
    from sevennet_exp_tpu.ops import pallas_conv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)
    jmodel = jbuild(tiny_model_config())
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    name, layer = [(n, l) for n, l in jmodel.layers
                   if isinstance(l, JL.IrrepsConvolution)][li]
    lp = params[name]
    rng = np.random.default_rng(30 + li)
    rows = 256
    ins = [rng.normal(size=(rows, w)).astype(np.float32)
           for w in (layer.tp.irreps_in1.dim, layer.tp.irreps_in2.dim,
                     layer.weight_nn.hs[0])]
    ms = rng.uniform(0.01, 0.1, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0
    g = rng.normal(size=(rows, layer.si2.irreps_out.dim)).astype(np.float32)
    mlp = [np.asarray(lp['weight_nn'][f'w{i}']) for i in range(3)]
    si2 = [np.asarray(lp['si2'][f'w{n}'])
           for n in range(len(layer.si2.paths))]
    pallas_conv.set_interpret(True)
    try:
        fused, _ = pallas_conv.make_fused_conv(layer.tp, layer.weight_nn,
                                               layer.si2)
        j_out, vjp = jax.vjp(
            lambda a, b, c: fused(a, b, c, jnp.asarray(ms),
                                  tuple(map(jnp.asarray, mlp)),
                                  tuple(map(jnp.asarray, si2))),
            *map(jnp.asarray, ins))
        j_grads = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    finally:
        pallas_conv.set_interpret(False)
    conv = pfc.FusedConv(
        UVUTensorProductSpec(repr(layer.tp.irreps_in1),
                             repr(layer.tp.irreps_in2),
                             repr(layer.tp.irreps_out_filter)),
        FullyConnectedNetSpec(layer.weight_nn.hs, layer.weight_nn.act),
        LinearSpec(repr(layer.si2.irreps_in), repr(layer.si2.irreps_out)), 0)
    mw, sw = (tuple(torch.tensor(w) for w in ws) for ws in (mlp, si2))
    for wrapper in (False, True):
        t = [torch.tensor(x, requires_grad=True) for x in ins]
        fn = conv if wrapper else conv.plain_forward
        out = fn(*t, torch.tensor(ms), mw, sw)
        assert tuple(out.shape) == (rows, conv.d_out)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                                   atol=1e-5, rtol=0)
        for a, b in zip(torch.autograd.grad(out, t, torch.tensor(g)),
                        j_grads):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=0)
