"""The port's Langevin and NPT ensembles on the CPU against the JAX engine.

64 atoms of rattled NaCl, the tiny config (random JAX weights moved through
``params_from_numpy``) and, for one NPT step, the trained checkpoint at full
width. The JAX side runs with Pallas off (the XLA path); both sides start
from the JAX engine's velocities.

  - ``npt`` and ``npt_aniso``: one step and 10 steps on one grid; positions
    and cell within 1e-5 A, and ``MolecularDynamics.run`` gives what the bare
    step loop gives. The barostat time is set short (``pdamp_fs``) so that
    the cell really moves: at the default the strain of one step is below
    float32 resolution in both packages.
  - ``_efs_fn``: the stress against a central difference of the energy under
    one deformation-gradient entry at a time, in float64 on the trained
    checkpoint (the convolution layout is not quite rotation-invariant, so
    a symmetric strain would miss the shear entries by ~2e-6 eV/A^3).
  - ``npt_aniso`` equals ``npt`` to O(dP^2) on an isotropically stressed
    cubic cell (mirrors tests/test_md.py).
  - ``langevin`` with zero friction equals the JAX BAOAB step to 1e-6 A;
    with friction it draws from the engine's own generator: the same seed
    gives the same trajectory and the global RNG is untouched.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from bench import build_nacl
from samples import tiny_model_config
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.md import integrate as jint
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint, \
    params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md import integrate as pint
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
POS_TOL = 1e-5     # A, positions and cell after up to 10 steps
NPT_KW = dict(dt_fs=1.0, temperature_K=300.0, rebuild_every=10,
              pressure_gpa=5.0, pdamp_fs=0.05)


def _port_atoms(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _tiny_atoms():
    # a = 4.4: two neighbor shells inside the tiny config's 4.0 A cutoff
    at = build_nacl(64, rattle=0.1, seed=3)
    s = 4.4 / 5.63
    return type(at)(at.atomic_numbers, at.pos * s, at.cell * s, at.pbc)


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
def trained_pair():
    jmodel, jparams = JCK(CKPT).build_model()
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    return jmodel, jparams, model


def _jax_npt_states(jmodel, jparams, at, ensemble, n_steps):
    """States after each of n_steps JAX steps on the t = 0 grid."""
    jmd = JMD(jmodel, jparams, at, ensemble=ensemble, use_pallas=False,
              **NPT_KW)
    pos, cell = jmd.state.pos, jmd.state.cell
    jnl = jmd._compact_nl(jmd._build_nl(pos, cell), pos, cell)
    e0, f0, _ = jmd._efs_fn(pos, jnl, cell)
    step = jax.jit(jmd._make_step())
    state = jmd.state._replace(forces=f0, energy=e0)
    states = []
    for _ in range(n_steps):
        state = step(state, jnl)
        states.append(state)
    return jmd, states


def _port_npt(model, at, ensemble, vel):
    return MolecularDynamics(model, _port_atoms(at), ensemble=ensemble,
                             device='cpu', velocities=np.array(vel),
                             **NPT_KW)


def _assert_state_close(state, jstate, tol=POS_TOL):
    assert np.abs(state.pos.numpy() - np.asarray(jstate.pos)).max() <= tol
    assert np.abs(state.cell.numpy() - np.asarray(jstate.cell)).max() <= tol
    # 1e-4 eV, or 1e-6 of an energy whose float32 spacing is already 6e-5
    # (the tiny config's random weights give -630 eV; JAX sums the atoms in
    # float32, the port in float64)
    e_ref = float(jstate.energy)
    assert abs(float(state.energy) - e_ref) <= max(1e-4, 1e-6 * abs(e_ref))


@pytest.mark.parametrize('ensemble', ['npt', 'npt_aniso'])
def test_npt_steps_match_jax_tiny(tiny_pair, ensemble):
    jmodel, jparams, model = tiny_pair
    at = _tiny_atoms()
    jmd, jstates = _jax_npt_states(jmodel, jparams, at, ensemble, 10)
    cell0 = np.asarray(jmd.state.cell)
    # the barostat moved the cell, far above float32 resolution
    assert np.abs(np.asarray(jstates[-1].cell) - cell0).max() > 1e-4
    md = _port_npt(model, at, ensemble, jmd.state.vel)
    assert md.npt and md.cell is None and md.inv_cell is None
    md.prime()
    step, nl = md._make_step(), md._grid()
    state = md.state
    for i in range(10):
        state = step(state, nl)
        if i in (0, 9):
            _assert_state_close(state, jstates[i])
    if ensemble == 'npt_aniso':
        cell = state.cell.numpy()
        assert np.abs(cell - cell.T).max() <= 1e-6     # symmetric strain
    # the engine's run loop (one chunk of 10 steps) gives the bare loop
    out = md.run(10)
    _assert_state_close(md.state, jstates[9])
    assert out['volume'][-1] == pytest.approx(
        abs(np.linalg.det(np.asarray(jstates[9].cell))), rel=1e-5)
    assert out['volume'][-1] < abs(np.linalg.det(cell0))    # 5 GPa squeezes


def test_npt_step_matches_jax_full_width(trained_pair):
    jmodel, jparams, model = trained_pair
    at = build_nacl(64, rattle=0.1, seed=1)
    jmd, (jstate,) = _jax_npt_states(jmodel, jparams, at, 'npt', 1)
    md = _port_npt(model, at, 'npt', jmd.state.vel)
    md.prime()
    state = md._make_step()(md.state, md._grid())
    _assert_state_close(state, jstate)
    assert np.abs(state.forces.numpy()
                  - np.asarray(jstate.forces)).max() <= 1e-4


def test_npt_runs_across_chunks_and_follows_the_cell(tiny_pair):
    """Several chunks: the Verlet list is rebuilt on the moved cell at every
    chunk, the scaling alone does not trip the staleness check, and nothing
    reads a cached cell."""
    _, _, model = tiny_pair
    at = _tiny_atoms()
    md = MolecularDynamics(model, _port_atoms(at), ensemble='npt',
                           device='cpu', seed=1,
                           **dict(NPT_KW, rebuild_every=4))
    out = md.run(12)
    assert md.rebuild_every == 4 and len(out['volume']) == 3
    assert np.all(np.diff(out['volume']) < 0)
    assert np.isfinite(out['energy']).all()
    # the fractional measure leaves the barostat's scaling out: a pure
    # scaling of cell and positions counts as the strain bound only
    nl = md._grid()
    mu = 0.999
    scaled = float(md._max_disp(nl.ref_pos, nl.ref_pos * mu, nl.ref_cell,
                                nl.ref_cell * mu))
    bound = 0.5 * (md.cutoff + md.md_buffer) * np.sqrt(3.0) * (1.0 - mu)
    assert scaled == pytest.approx(bound, rel=1e-3)
    raw = float(torch.sqrt(((nl.ref_pos * (1 - mu)) ** 2).sum(-1).max()))
    assert raw > 2 * scaled
    with pytest.raises(ValueError, match='minimum-image'):
        md._follow_cell(md.state.cell * 0.8)


def test_efs_stress_is_the_deformation_derivative(trained_pair):
    """-stress[ab] * V = dE/dF_ab by a central difference (h = 1e-4) under
    x -> x (1 + F), one entry of F at a time, float64: each of the six
    within 1e-6 eV/A^3."""
    _, _, trained = trained_pair
    at = build_nacl(64, rattle=0.1, seed=1)
    shear = np.eye(3) + np.array([[0.01, 0.008, 0.004], [0.008, -0.01, 0.006],
                                  [0.004, 0.006, 0.0]])
    at = type(at)(at.atomic_numbers, at.pos @ shear, at.cell @ shear, at.pbc)
    md = MolecularDynamics(trained, _port_atoms(at), ensemble='npt',
                           device='cpu')
    nl = md._grid()
    e32, f32, s32 = md._efs_fn(md.state.pos, nl, md.state.cell)
    model = copy.deepcopy(trained).double()
    pos = torch.tensor(at.pos, dtype=torch.float64)
    cell = torch.tensor(at.cell, dtype=torch.float64)
    e, f, stress = model.energy_forces_stress(
        pos, cell, lambda p: md._graph(p, nl, cell))
    assert abs(float(e) - float(e32)) <= 1e-4
    assert np.abs(f.numpy() - f32.numpy()).max() <= 1e-4
    assert np.abs(stress.numpy() - s32.numpy()).max() <= 1e-6
    vol = abs(np.linalg.det(at.cell))
    h = 1e-4
    for comp, (a, b) in enumerate([(0, 0), (1, 1), (2, 2), (0, 1), (1, 2),
                                   (2, 0)]):
        es = []
        for sign in (+1, -1):
            m = torch.eye(3, dtype=torch.float64)
            m[a, b] += 0.5 * sign * h
            es.append(float(model.energy(
                md._graph(pos @ m, nl, cell @ m))))
        fd = (es[0] - es[1]) / h / vol
        assert abs(-fd - float(stress[comp])) <= 1e-6, (comp, fd, stress)
        # the strain argument of _graph is the same deformation
        eps = torch.zeros((3, 3), dtype=torch.float64)
        eps[a, b] = 0.5 * h
        e_eps = float(model.energy(md._graph(pos, nl, cell, strain=eps)))
        assert abs(e_eps - es[0]) <= 1e-9
    assert np.abs(stress.numpy()).min() > 1e-5
    assert np.abs(f.numpy().sum(0)).max() < 1e-9


def test_npt_aniso_matches_iso_linearization():
    n = 8
    rng = np.random.default_rng(0)
    masses = torch.tensor(rng.uniform(10.0, 30.0, n), dtype=torch.float32)
    pos = torch.tensor(rng.uniform(0, 5, (n, 3)), dtype=torch.float32)
    cell = torch.eye(3) * 5.63
    s_iso = 0.002

    def efs(pos, nl, cell):
        return (torch.zeros(()), torch.zeros_like(pos),
                torch.tensor([s_iso, s_iso, s_iso, 0, 0, 0]))

    kw = dict(masses=masses, dt=0.5, temp_K=10.0, tdamp=100.0,
              press_target=0.01, pdamp=100.0, compressibility=1.0)
    st = pint.MDState(pos=pos, vel=torch.zeros_like(pos),
                      forces=torch.zeros_like(pos), energy=torch.zeros(()),
                      xi=torch.zeros(()), cell=cell)
    out_iso = pint.make_npt_berendsen_step(efs, **kw)(st, None)
    out_ani = pint.make_npt_berendsen_aniso_step(efs, **kw)(st, None)
    assert float((out_iso.cell - cell).abs().max()) > 1e-5
    np.testing.assert_allclose(out_ani.cell.numpy(), out_iso.cell.numpy(),
                               rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(out_ani.pos.numpy(), out_iso.pos.numpy(),
                               rtol=2e-5, atol=2e-6)
    # and both equal the JAX steps on the same numbers
    import jax.numpy as jnp
    jkw = dict(kw, masses=jnp.asarray(masses.numpy()))
    jst = jint.MDState(
        pos=jnp.asarray(pos.numpy()), vel=jnp.zeros((n, 3)),
        forces=jnp.zeros((n, 3)), energy=jnp.asarray(0.0),
        key=jax.random.PRNGKey(0), xi=jnp.asarray(0.0),
        cell=jnp.asarray(cell.numpy()))

    def jefs(pos, nl, cell):
        return (jnp.asarray(0.0), jnp.zeros_like(pos),
                jnp.array([s_iso, s_iso, s_iso, 0, 0, 0], jnp.float32))

    for make, out in ((jint.make_npt_berendsen_step, out_iso),
                      (jint.make_npt_berendsen_aniso_step, out_ani)):
        jout = make(jefs, **jkw)(jst, None)
        np.testing.assert_allclose(out.cell.numpy(), np.asarray(jout.cell),
                                   atol=1e-6)
        np.testing.assert_allclose(out.pos.numpy(), np.asarray(jout.pos),
                                   atol=1e-6)
    v = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    np.testing.assert_array_equal(
        pint.voigt_to_tensor(v).numpy(),
        np.asarray(jint.voigt_to_tensor(jnp.asarray(v.numpy()))))


def test_langevin_zero_friction_matches_jax_baoab(tiny_pair):
    jmodel, jparams, model = tiny_pair
    at = _tiny_atoms()
    jmd = JMD(jmodel, jparams, at, ensemble='langevin', friction_per_fs=0.0,
              dt_fs=1.0, temperature_K=600.0, rebuild_every=10,
              use_pallas=False)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    e0, f0 = jmd._ef_fn(jmd.state.pos, jnl)
    step = jax.jit(jmd._make_step())
    jstate = jmd.state._replace(forces=f0, energy=e0)
    for _ in range(5):
        jstate = step(jstate, jnl)
    md = MolecularDynamics(model, _port_atoms(at), ensemble='langevin',
                           friction_per_fs=0.0, dt_fs=1.0,
                           temperature_K=600.0, rebuild_every=10,
                           device='cpu', velocities=np.array(jmd.state.vel))
    md.run(5)
    assert np.abs(md.state.pos.numpy() - np.asarray(jstate.pos)).max() <= 1e-6
    assert np.abs(md.state.vel.numpy() - np.asarray(jstate.vel)).max() <= 1e-6
    assert md.state.cell is None


def test_langevin_noise_comes_from_the_engines_generator(tiny_pair):
    _, _, model = tiny_pair
    at = _port_atoms(_tiny_atoms())

    def run(seed):
        md = MolecularDynamics(model, at, ensemble='langevin',
                               friction_per_fs=0.01, dt_fs=1.0,
                               temperature_K=300.0, rebuild_every=5,
                               device='cpu', seed=seed)
        md.run(5)
        return md.state

    torch.manual_seed(123)
    before = torch.get_rng_state()
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(torch.get_rng_state(), before)     # global RNG untouched
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    assert float((a.pos - c.pos).abs().max()) > 1e-4
    # the O step on known noise: v' = c1 v + sigma xi
    masses = torch.tensor([20.0, 30.0])
    xi = torch.randn((2, 3), generator=torch.Generator().manual_seed(4))
    step = pint.make_langevin_step(
        lambda pos, nl: (torch.zeros(()), torch.zeros_like(pos)), masses,
        dt=0.1, temp_K=100.0, friction=2.0,
        generator=torch.Generator().manual_seed(4))
    st = pint.MDState(pos=torch.zeros((2, 3)), vel=torch.ones((2, 3)),
                      forces=torch.zeros((2, 3)), energy=torch.zeros(()),
                      xi=torch.zeros(()))
    out = step(st, None)
    c1 = np.exp(-0.2)
    from sevennet_exp_tpu_torch.md.units import kB
    sigma = np.sqrt(kB * 100.0 * (1 - c1 ** 2) / masses.numpy())[:, None]
    np.testing.assert_allclose(out.vel.numpy(), c1 + sigma * xi.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(out.pos.numpy(),
                               0.05 * (1.0 + out.vel.numpy()), rtol=1e-6)


def test_engine_takes_the_five_ensembles(tiny_pair):
    import inspect
    _, _, model = tiny_pair
    at = _port_atoms(_tiny_atoms())
    with pytest.raises(ValueError, match='ensemble'):
        MolecularDynamics(model, at, ensemble='nph', device='cpu')
    sig = inspect.signature(MolecularDynamics.__init__).parameters
    assert sig['device'].default == 'cuda'
    assert sig['cg_mode'].default == 'cmshared'
    jsig = inspect.signature(JMD.__init__).parameters
    for name in ('friction_per_fs', 'pressure_gpa', 'pdamp_fs'):
        assert sig[name].default == jsig[name].default
    md = MolecularDynamics(model, at, ensemble='npt', device='cpu',
                           pressure_gpa=2.0, dt_fs=2.0)
    jmd = JMD(tiny_pair[0], tiny_pair[1], _tiny_atoms(), ensemble='npt',
              pressure_gpa=2.0, dt_fs=2.0, use_pallas=False)
    assert md.pressure == pytest.approx(jmd.pressure, rel=1e-12)
    assert md.pdamp == pytest.approx(jmd.pdamp, rel=1e-12)
    assert md.friction == pytest.approx(jmd.friction, rel=1e-12)
