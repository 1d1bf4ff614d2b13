"""The port's Grimme D3 (``sevennet_exp_tpu_torch/ops/d3.py``, plain
PyTorch), its calculators and the MD engine's ``d3=`` on the CPU, case by
case as ``tests/test_d3.py`` tests the JAX package, each against the JAX
function on the same inputs.

Tolerances (fp32 on both sides; the port sums its chunks and components in
another order): energies 1e-6 relative or 1e-6 eV, forces 1e-5 eV/A,
stress 1e-6 eV/A^3 for D3 alone; the model plus D3 (calculator, engine)
1e-4 eV, 1e-4 eV/A, 1e-5 eV/A^3, positions and cell 1e-5 A over the steps
taken. Finite differences, extensivity and invariances are held to the
limits ``tests/test_d3.py`` holds the JAX package to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_nacl
from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.calculator import D3Calculator as JD3Calc
from sevennet_exp_tpu.calculator import SevenNetD3Calculator as JSD3Calc
from sevennet_exp_tpu.md import integrate as jint
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops import d3 as jd3
from sevennet_exp_tpu_torch.calculator import (
    D3Calculator,
    SevenNetCalculator,
    SevenNetD3Calculator,
)
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import d3 as pd3

torch.set_num_threads(2)
DAMPINGS = ['damp_zero', 'damp_bj', 'damp_zerom', 'damp_bjm']
E_REL, F_TOL, S_TOL = 1e-6, 1e-5, 1e-6          # D3 alone
ME_TOL, MF_TOL, MS_TOL = 1e-4, 1e-4, 1e-5      # model + D3
POS_TOL = 1e-5
# small thresholds (bohr^2) keep the engine's replica sums cheap on the CPU
SMALL = dict(rthr=120.0, cn_thr=80.0)


def _close_d3(mine, theirs):
    assert mine['energy'] == pytest.approx(theirs['energy'], rel=E_REL,
                                           abs=1e-6)
    assert np.abs(mine['forces'] - theirs['forces']).max() <= F_TOL
    assert np.abs(mine['stress'] - theirs['stress']).max() <= S_TOL


def _port(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _molecule():
    rng = np.random.RandomState(0)
    pos = np.array([[0.0, 0, 0], [1.3, 0, 0], [-0.6, 0.9, 0],
                    [-0.6, -0.9, 0]]) + 0.05 * rng.randn(4, 3)
    return [6, 8, 1, 1], pos


# -- tables and constants ----------------------------------------------------

def test_published_constants():
    raw_hh = pd3.build_tables([1])
    assert np.nanmax(raw_hh.c6ref.numpy()[0, 0]) == pytest.approx(
        7.5916, abs=1e-4)
    t = pd3.build_tables([1, 6])
    assert float(t.r0ab[0, 0]) == pytest.approx(2.1823, abs=1e-4)
    assert float(t.r0ab[1, 1]) == pytest.approx(2.9103, abs=1e-4)
    assert np.nanmax(t.c6ref.numpy()[1, 1]) == pytest.approx(49.1130,
                                                             abs=1e-3)
    # every table entry as the JAX package resolves it, bit for bit
    jt = jd3.build_tables([1, 6, 8, 11, 17, 72])
    pt = pd3.build_tables([1, 6, 8, 11, 17, 72])
    for name in jt._fields:
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    assert pd3.DAMPING_TABLES == jd3.DAMPING_TABLES
    for damping, table in jd3.DAMPING_TABLES.items():
        for functional in table:
            assert tuple(pd3.get_damping_params(damping, functional)) == \
                tuple(jd3.get_damping_params(damping, functional))
    p = pd3.get_damping_params('damp_bj', 'pbe')
    assert (p.rs6, p.s8, p.rs8) == (0.4289, 0.7875, 4.4407)
    with pytest.raises(ValueError):
        pd3.get_damping_params('damp_bj', 'not-a-functional')
    with pytest.raises(ValueError):
        pd3.get_damping_params('damp_x', 'pbe')
    with pytest.raises(ValueError):
        pd3.build_tables([0, 1])


def test_port_carries_its_own_tables():
    """The port reads the copy beside its own module, equal to the JAX
    package's file, array for array."""
    import os
    assert os.path.dirname(pd3._PARAMS_PATH).endswith(
        os.path.join('sevennet_exp_tpu_torch', 'ops'))
    mine, theirs = pd3._raw_tables(), jd3._raw_tables()
    assert set(mine) == set(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k])


@pytest.mark.parametrize('cn,ref', [(0.0, 49.1130), (8.0, 18.2067),
                                    (2.7, None)])
def test_c6_interpolation_hits_reference_points(cn, ref):
    t, jt = pd3.build_tables([6]), jd3.build_tables([6])
    c6 = float(pd3.interpolate_c6(torch.tensor([cn]), torch.tensor([0]),
                                  t)[0, 0])
    jc6 = float(jd3.interpolate_c6(jnp.asarray([cn]), jnp.asarray([0]),
                                   jt)[0, 0])
    assert c6 == pytest.approx(jc6, rel=1e-6)
    if ref is not None:
        assert c6 == pytest.approx(ref, rel=5e-3)


def test_c6_reference_grid_separability():
    """The factored C6 rests on two facts of Grimme's table, over all 94
    elements: validity factorises and cn_i depends only on (t1, k)."""
    raw = pd3._raw_tables()
    c6, cni, cnj = raw['c6'], raw['cn_i'], raw['cn_j']
    fin = np.isfinite(c6)
    valid_tk = fin.any(axis=(1, 3))
    expect = valid_tk[:, None, :, None] & valid_tk[None, :, None, :]
    assert np.array_equal(fin, expect)
    with np.errstate(invalid='ignore'):
        ref_i = np.where(fin, cni, np.nan)
        ref_j = np.where(fin, cnj, np.nan)
        assert np.nanmax(np.nanmax(ref_i, axis=(1, 3))
                         - np.nanmin(ref_i, axis=(1, 3))) == 0.0
        assert np.nanmax(np.nanmax(ref_j, axis=(0, 2))
                         - np.nanmin(ref_j, axis=(0, 2))) == 0.0
    # the factored C6 equals the full four-index interpolation
    rng = np.random.default_rng(3)
    zs = [1, 6, 8, 17]
    t = pd3.build_tables(zs, torch.float64)
    tidx = torch.tensor([0, 1, 1, 2, 3, 0])
    cn = torch.tensor(rng.uniform(0, 4, 6))
    c6p = pd3.interpolate_c6(cn, tidx, t).numpy()
    c6r, ci, cj = (x.numpy() for x in (t.c6ref, t.cnref_i, t.cnref_j))
    for i in range(6):
        for j in range(6):
            a, b = int(tidx[i]), int(tidx[j])
            ok = np.isfinite(c6r[a, b])
            lw = pd3.K3 * ((cn[i].item() - ci[a, b]) ** 2
                           + (cn[j].item() - cj[a, b]) ** 2)
            lw = np.where(ok, lw, -np.inf)
            w = np.exp(lw - lw.max())
            full = (w * np.where(ok, c6r[a, b], 0)).sum() / w.sum()
            assert c6p[i, j] == pytest.approx(full, rel=1e-10)


def test_lattice_shifts_cover_cutoff():
    cell = np.diag([3.0, 3.0, 3.0])
    s = pd3.lattice_shifts(cell, [True] * 3, 7.0, chunk=16)
    assert s.shape[0] % 16 == 0 and np.all(s[0] == 0)
    assert np.abs(s[np.abs(s).max(1) < 9]).max() >= 3
    tri = np.array([[5.0, 0, 0], [2.0, 4.5, 0], [0.5, 1.0, 6.0]])
    for cell, pbc, rc in ((cell, [True] * 3, 7.0), (tri, [True] * 3, 11.0),
                          (tri, [True, False, True], 9.0)):
        np.testing.assert_array_equal(
            pd3.lattice_shifts(cell, pbc, rc, 16),
            jd3.lattice_shifts(cell, pbc, rc, 16))


# -- energy, forces, stress --------------------------------------------------

@pytest.mark.parametrize('damping', DAMPINGS)
def test_forces_match_finite_difference(damping):
    z, pos = _molecule()
    mine = pd3.D3Dispersion(damping, 'pbe', device='cpu')
    out = mine.compute(z, pos)
    _close_d3(out, jd3.D3Dispersion(damping, 'pbe').compute(z, pos))
    eps = 5e-3
    for (i, k) in [(0, 0), (1, 1), (3, 2)]:
        p1, p2 = pos.copy(), pos.copy()
        p1[i, k] += eps
        p2[i, k] -= eps
        fd = -(mine.compute(z, p1)['energy']
               - mine.compute(z, p2)['energy']) / (2 * eps)
        assert out['forces'][i, k] == pytest.approx(fd, rel=5e-3, abs=2e-4)


def test_energy_attractive_and_damped():
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu')
    jd = jd3.D3Dispersion('damp_bj', 'pbe')
    e3 = d3.compute([6, 6], [[0, 0, 0], [3.0, 0, 0]])['energy']
    e6 = d3.compute([6, 6], [[0, 0, 0], [6.0, 0, 0]])['energy']
    assert e3 < e6 < 0.0
    for got, pos in ((e3, [[0, 0, 0], [3.0, 0, 0]]),
                     (e6, [[0, 0, 0], [6.0, 0, 0]])):
        assert got == pytest.approx(jd.compute([6, 6], pos)['energy'],
                                    rel=E_REL)
    r = 15.0
    e = d3.compute([1, 1], [[0, 0, 0], [r, 0, 0]])['energy']
    c6_hh = float(pd3.interpolate_c6(torch.tensor([0.0]),
                                     torch.tensor([0]),
                                     pd3.build_tables([1]))[0, 0])
    r42 = 2.00734898 ** 2
    r_b = r / pd3.AU_TO_ANG
    expect = -(c6_hh / r_b ** 6
               + 0.7875 * 3 * c6_hh * r42 / r_b ** 8) * pd3.AU_TO_EV
    assert e == pytest.approx(expect, rel=1e-2)


def test_periodic_extensivity_and_stress():
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu', shift_chunk=256)
    jd = jd3.D3Dispersion('damp_bj', 'pbe')
    cell = np.diag([4.1, 4.3, 4.2])
    z = [14, 8]
    pos = np.array([[0.05, 0, 0], [2.0, 2.1, 2.1]])
    r1 = d3.compute(z, pos, cell, [True] * 3)
    _close_d3(r1, jd.compute(z, pos, cell, [True] * 3))
    cell2 = np.diag([8.2, 4.3, 4.2])
    pos2 = np.concatenate([pos, pos + [4.1, 0, 0]])
    r2 = d3.compute(z * 2, pos2, cell2, [True] * 3)
    assert r2['energy'] == pytest.approx(2 * r1['energy'], rel=1e-5)
    np.testing.assert_allclose(r2['stress'], r1['stress'], rtol=1e-4,
                               atol=1e-8)
    eps = 1e-4
    vol = np.abs(np.linalg.det(cell))
    for k in range(3):
        s1 = np.eye(3)
        s1[k, k] += eps
        e_p = d3.compute(z, pos @ s1, cell @ s1, [True] * 3)['energy']
        s1[k, k] -= 2 * eps
        e_m = d3.compute(z, pos @ s1, cell @ s1, [True] * 3)['energy']
        fd = (e_p - e_m) / (2 * eps) / vol
        assert r1['stress'][k, k] == pytest.approx(fd, rel=2e-3, abs=1e-5)


def test_translation_and_pbc_wrap_invariance():
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu', shift_chunk=256)
    jd = jd3.D3Dispersion('damp_bj', 'pbe')
    cell = np.diag([5.0, 5.0, 5.0])
    z = [6, 8, 1]
    pos = np.array([[0.2, 0.1, 0.3], [1.5, 1.4, 1.6], [3.0, 3.2, 2.9]])
    r0 = d3.compute(z, pos, cell, [True] * 3)
    _close_d3(r0, jd.compute(z, pos, cell, [True] * 3))
    e1 = d3.compute(z, pos + 1.234, cell, [True] * 3)['energy']
    posw = pos.copy()
    posw[2] += cell[0]
    e2 = d3.compute(z, posw, cell, [True] * 3)['energy']
    assert e1 == pytest.approx(r0['energy'], abs=5e-6)
    assert e2 == pytest.approx(r0['energy'], abs=5e-6)


def test_tiled_mic_matches_replica_path():
    """The block-tiled minimum-image sweep against the replica sum, both
    against the JAX functions: energy and autograd forces, block 64 on 90
    atoms (padding exercised) and the lattice gradient (virial)."""
    rng = np.random.RandomState(7)
    n = 90
    cell_ang = np.diag([14.0, 15.0, 14.5])
    pos_ang = rng.uniform(0, 1, (n, 3)) @ cell_ang
    z = rng.choice([1, 6, 8, 11, 17], n)
    rthr = (6.0 / pd3.AU_TO_ANG) ** 2
    cn_thr = (4.0 / pd3.AU_TO_ANG) ** 2
    assert pd3.mic_ok(cell_ang, 6.0) and not pd3.mic_ok(cell_ang, 7.3)
    zu, tidx = np.unique(z, return_inverse=True)
    damping = pd3.get_damping_params('damp_bj', 'pbe')
    lat64 = cell_ang / pd3.AU_TO_ANG
    sv = pd3.lattice_shifts(lat64, [True] * 3, float(np.sqrt(rthr)),
                            16).reshape(-1, 16, 3)
    sc = pd3.lattice_shifts(lat64, [True] * 3, float(np.sqrt(cn_thr)),
                            16).reshape(-1, 16, 3)

    tables = pd3.build_tables(zu)
    ti = torch.as_tensor(tidx)
    pos = torch.tensor(pos_ang / pd3.AU_TO_ANG, dtype=torch.float32,
                       requires_grad=True)
    lat = torch.tensor(lat64, dtype=torch.float32, requires_grad=True)
    e0 = pd3.dispersion_energy(pos, lat, ti, tables, damping,
                               torch.tensor(sv, dtype=torch.float32),
                               torch.tensor(sc, dtype=torch.float32),
                               rthr, cn_thr)
    g0, l0 = torch.autograd.grad(e0, [pos, lat])
    e1 = pd3.dispersion_energy_tiled(pos, lat, ti, tables, damping, rthr,
                                     cn_thr, block=64)
    g1, l1 = torch.autograd.grad(e1, [pos, lat])
    assert float(e1) == pytest.approx(float(e0), rel=1e-5)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-4,
                               atol=1e-6)

    jt = jd3.build_tables(zu, np.float32)
    jlat = jnp.asarray(lat64, jnp.float32)

    def je(p):
        return jd3.dispersion_energy(p, jlat, jnp.asarray(tidx), jt, damping,
                                     jnp.asarray(sv, jnp.float32),
                                     jnp.asarray(sc, jnp.float32), rthr,
                                     cn_thr)

    def jet(p):
        return jd3.dispersion_energy_tiled(p, jlat, jnp.asarray(tidx), jt,
                                           damping, rthr, cn_thr, block=64)

    jpos = jnp.asarray(pos_ang / pd3.AU_TO_ANG, jnp.float32)
    for mine, grad, fn in ((e0, g0, je), (e1, g1, jet)):
        ref, gref = jax.value_and_grad(fn)(jpos)
        assert float(mine) == pytest.approx(float(ref), rel=1e-6)
        np.testing.assert_allclose(grad.numpy(), np.asarray(gref),
                                   rtol=1e-4, atol=1e-7)


# -- calculators -------------------------------------------------------------

class _Duck:
    def __init__(self, z, pos, cell, pbc):
        self.z, self.pos, self.cell, self.pbc = z, pos, cell, pbc

    def get_atomic_numbers(self):
        return np.asarray(self.z)

    def get_positions(self):
        return np.asarray(self.pos)

    def get_cell(self):
        return np.asarray(self.cell)

    def get_pbc(self):
        return np.asarray(self.pbc)


def test_d3_calculator_matches_jax():
    a = _Duck([14, 14], [[0.0, 0, 0], [2.0, 2.0, 2.0]], np.diag([4.0] * 3),
              [True] * 3)
    calc = D3Calculator(damping='damp_bj', functional='pbe', device='cpu')
    e = calc.get_potential_energy(a)
    f, s = calc.get_forces(), calc.get_stress()
    assert e < 0 and f.shape == (2, 3) and s.shape == (6,)
    ref = JD3Calc(damping='damp_bj', functional='pbe').calculate_single(a)
    assert e == pytest.approx(ref['energy'], rel=E_REL)
    assert np.abs(f - ref['forces']).max() <= F_TOL
    assert np.abs(s - ref['stress']).max() <= S_TOL
    import inspect
    for cls in (D3Calculator, SevenNetD3Calculator):
        params = inspect.signature(cls.__init__).parameters
        jparams = inspect.signature(
            {D3Calculator: JD3Calc,
             SevenNetD3Calculator: JSD3Calc}[cls].__init__).parameters
        for k in ('damping', 'functional', 'rthr', 'cn_thr'):
            assert params[k].default == jparams[k].default
    assert inspect.signature(D3Calculator.__init__).parameters[
        'device'].default == 'cuda'


@pytest.fixture(scope='module')
def tiny_pair():
    cfg = tiny_model_config()
    jmodel = jbuild(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(5))
    model = build_e3_equivariant_model(cfg)
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, model


def test_sevennet_d3_calculator_matches_jax(tiny_pair):
    """E/F/S of the model plus D3 against the JAX calculator, and equal to
    the port's model calculator plus its D3 calculator."""
    jmodel, jparams, model = tiny_pair
    at = rattled_rocksalt(reps=2, a=4.4, rattle=0.1, seed=3)
    kw = dict(damping='damp_zero', functional='pbe', rthr=1600.0,
              cn_thr=625.0)
    res = SevenNetD3Calculator(model, device='cpu', **kw).calculate(
        _port(at))
    ref = JSD3Calc(model=jmodel, params=jparams, use_pallas=False,
                   **kw).calculate_single(at)
    assert abs(res['energy'] - ref['energy']) <= max(
        ME_TOL, 4 * float(np.spacing(np.float32(abs(ref['energy'])))))
    assert np.abs(res['energies'] - ref['energies']).max() <= ME_TOL
    assert np.abs(res['forces'] - ref['forces']).max() <= MF_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= MS_TOL
    alone = SevenNetCalculator(model, device='cpu').calculate(_port(at))
    disp = D3Calculator(device='cpu', **kw).calculate(_port(at))
    assert res['energy'] == pytest.approx(alone['energy'] + disp['energy'],
                                          abs=1e-9)
    np.testing.assert_allclose(res['forces'],
                               alone['forces'] + disp['forces'], atol=1e-9)
    np.testing.assert_allclose(res['stress'],
                               alone['stress'] + disp['stress'], atol=1e-12)
    assert abs(disp['energy']) > 10 * ME_TOL


# -- the MD engine -----------------------------------------------------------

def _tiny_atoms():
    at = build_nacl(64, rattle=0.1, seed=3)
    s = 4.4 / 5.63
    return type(at)(at.atomic_numbers, at.pos * s, at.cell * s, at.pbc)


def _jax_states(jmd, ensemble, n_steps):
    """JAX states after each of n_steps on the t = 0 grid."""
    pos = jmd.state.pos
    if ensemble.startswith('npt'):
        cell = jmd.state.cell
        jnl = jmd._compact_nl(jmd._build_nl(pos, cell), pos, cell)
        e0, f0, _ = jmd._efs_fn(pos, jnl, cell)
        step = jax.jit(jmd._make_step())
    else:
        jnl = jmd._compact_nl(jmd._build_nl(pos), pos)
        e0, f0 = jmd._ef_fn(pos, jnl)
        step = jax.jit(jint.make_nose_hoover_step(
            jmd._ef_fn, jmd.masses, jmd.dt, jmd.temperature_K, jmd.tdamp))
    state = jmd.state._replace(forces=f0, energy=e0)
    states = []
    for _ in range(n_steps):
        state = step(state, jnl)
        states.append(state)
    return e0, f0, states


def _assert_state(state, jstate):
    assert np.abs(state.pos.numpy() - np.asarray(jstate.pos)).max() \
        <= POS_TOL
    if jstate.cell is not None:
        assert np.abs(state.cell.numpy() - np.asarray(jstate.cell)).max() \
            <= POS_TOL
    e_ref = float(jstate.energy)
    assert abs(float(state.energy) - e_ref) <= max(ME_TOL, 1e-6 * abs(e_ref))


def test_engine_nvt_with_d3_matches_jax(tiny_pair):
    """The engine's potential is model + D3 (whole-array replica sum) and
    6 Nose-Hoover steps follow the JAX engine's."""
    jmodel, jparams, model = tiny_pair
    at = _tiny_atoms()
    kw = dict(ensemble='nvt', rebuild_every=6, dt_fs=2.0, seed=1)
    jmd = JMD(jmodel, jparams, at, use_pallas=False,
              d3=jd3.D3Dispersion('damp_bj', 'pbe', **SMALL), **kw)
    e0, f0, jstates = _jax_states(jmd, 'nvt', 6)
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu', **SMALL)
    md = MolecularDynamics(model, _port(at), device='cpu', d3=d3,
                           velocities=np.array(jmd.state.vel), **kw)
    md0 = MolecularDynamics(model, _port(at), device='cpu',
                            velocities=np.array(jmd.state.vel), **kw)
    md.prime()
    md0.prime()
    assert abs(float(md.state.energy) - float(e0)) <= ME_TOL
    assert np.abs(md.state.forces.numpy() - np.asarray(f0)).max() <= MF_TOL
    # the overlay is exactly the D3 calculation of the structure
    ref = d3.compute(at.atomic_numbers, at.pos, at.cell, at.pbc)
    assert float(md.state.energy - md0.state.energy) == pytest.approx(
        ref['energy'], rel=1e-4, abs=1e-5)
    np.testing.assert_allclose(
        (md.state.forces - md0.state.forces).numpy(), ref['forces'],
        rtol=1e-3, atol=1e-4)
    md.run(6)
    _assert_state(md.state, jstates[-1])


def test_engine_npt_with_d3_matches_jax(tiny_pair):
    """NPT with D3: the strain gradient of D3 is in the stress, 8 steps
    follow the JAX engine's, and a forced re-enumeration of the replica
    shifts (coverage set above the cell's widths) enumerates them on the
    moved cell without moving the trajectory."""
    jmodel, jparams, model = tiny_pair
    at = _tiny_atoms()
    kw = dict(ensemble='npt', rebuild_every=4, dt_fs=1.0, seed=1,
              temperature_K=300.0, pressure_gpa=5.0, pdamp_fs=0.05)
    jmd = JMD(jmodel, jparams, at, use_pallas=False,
              d3=jd3.D3Dispersion('damp_bj', 'pbe', **SMALL), **kw)
    _, _, jstates = _jax_states(jmd, 'npt', 8)
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu', **SMALL)
    md = MolecularDynamics(model, _port(at), device='cpu', d3=d3,
                           velocities=np.array(jmd.state.vel), **kw)
    md_no = MolecularDynamics(model, _port(at), device='cpu',
                              velocities=np.array(jmd.state.vel), **kw)
    cell = md.state.cell
    _, _, s_with = md._efs_fn(md.state.pos, md._grid(), cell)
    _, _, s_without = md_no._efs_fn(md_no.state.pos, md_no._grid(), cell)
    _, _, js = jmd._efs_fn(jmd.state.pos, jmd._compact_nl(
        jmd._build_nl(jmd.state.pos, jmd.state.cell), jmd.state.pos,
        jmd.state.cell), jmd.state.cell)
    assert np.abs(s_with.numpy() - np.asarray(js)).max() <= MS_TOL
    assert float((s_with - s_without).abs().max()) > 1e-5
    enumerated = md._d3['shifts_vdw']
    md.run(4)
    _assert_state(md.state, jstates[3])
    # force a re-enumeration at the end of the next chunk
    md._d3_min_widths = md._d3_min_widths * 10.0
    md.run(4)
    _assert_state(md.state, jstates[7])
    lat = md.state.cell.numpy().astype(np.float64) / md.d3_npt_margin
    expect = pd3.lattice_shifts(lat / pd3.AU_TO_ANG, [True] * 3,
                                np.sqrt(SMALL['rthr']), 16)
    assert md._d3['shifts_vdw'] is not enumerated
    np.testing.assert_array_equal(
        md._d3['shifts_vdw'].numpy().reshape(-1, 3), expect)
    from sevennet_exp_tpu_torch.md.engine import _cell_widths
    np.testing.assert_allclose(md._d3_min_widths,
                               _cell_widths(md.state.cell.numpy()
                                            .astype(np.float64))
                               / md.d3_npt_margin, rtol=1e-12)


def test_engine_chunked_with_d3_matches_jax(tiny_pair):
    """The chunked leg with D3 runs the tiled minimum-image sweep: its force
    call equals the JAX chunked engine's and the port's whole-array one,
    3 NVE steps follow; a D3 cutoff wider than half the cell raises at
    start-up, as in JAX."""
    jmodel, jparams, model = tiny_pair
    at = rattled_rocksalt(reps=3, a=3.2, rattle=0.03, seed=4)
    kw = dict(ensemble='nve', seed=1, rebuild_every=3)
    small = dict(rthr=64.0, cn_thr=36.0)
    jmd = JMD(jmodel, jparams, at, use_pallas=False, conv_chunk_atoms=16,
              d3=jd3.D3Dispersion('damp_bj', 'pbe', **small), **kw)
    assert jmd.conv_chunk_rows > 0
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    je, jf = jmd._ef_fn(jmd.state.pos, jnl)
    d3 = pd3.D3Dispersion('damp_bj', 'pbe', device='cpu', **small)
    vel = np.array(jmd.state.vel)
    md = MolecularDynamics(model, _port(at), device='cpu', d3=d3,
                           conv_chunk_atoms=16, velocities=vel, **kw)
    whole = MolecularDynamics(model, _port(at), device='cpu', d3=d3,
                              velocities=vel, **kw)
    assert md.conv_chunk_rows > 0 and not whole.conv_chunk_rows
    e, f = md._ef_fn(md.state.pos, md._grid())
    ew, fw = whole._ef_fn(whole.state.pos, whole._grid())
    assert abs(float(e) - float(je)) <= ME_TOL
    assert np.abs(f.numpy() - np.asarray(jf)).max() <= MF_TOL
    assert abs(float(e) - float(ew)) <= ME_TOL
    assert np.abs(f.numpy() - fw.numpy()).max() <= MF_TOL
    md.run(3)
    whole.run(3)
    assert np.abs(md.state.pos.numpy() - whole.state.pos.numpy()).max() \
        <= POS_TOL
    with pytest.raises(ValueError, match='minimum-image'):
        JMD(jmodel, jparams, at, use_pallas=False, conv_chunk_atoms=16,
            d3=jd3.D3Dispersion('damp_bj', 'pbe'), **kw)
    with pytest.raises(ValueError, match='minimum-image'):
        MolecularDynamics(model, _port(at), device='cpu', conv_chunk_atoms=16,
                          d3=pd3.D3Dispersion('damp_bj', 'pbe',
                                              device='cpu'), **kw)
    # the whole-array path has no such limit
    MolecularDynamics(model, _port(at), device='cpu',
                      d3=pd3.D3Dispersion('damp_bj', 'pbe', device='cpu'),
                      **kw)


def test_d3_and_the_variants_import_no_jax():
    """D3, the calculators and a multi-modal build in a fresh interpreter:
    neither jax nor the JAX package is imported."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        'import sys\n'
        'from sevennet_exp_tpu_torch.calculator import D3Calculator\n'
        'from sevennet_exp_tpu_torch.model.build import '
        'build_e3_equivariant_model\n'
        'from sevennet_exp_tpu_torch.util import chemical_species_preprocess\n'
        'r = D3Calculator(device="cpu", rthr=400.0, cn_thr=200.0).calculate_'
        'single(type("A", (), dict(get_atomic_numbers=lambda s: [6, 8], '
        'get_positions=lambda s: [[0, 0, 0], [1.2, 0, 0]], '
        'get_cell=lambda s: [[0.0] * 3] * 3, '
        'get_pbc=lambda s: [False] * 3))())\n'
        'assert r["energy"] < 0\n'
        'cfg = dict(cutoff=4.0, channel=4, lmax=1, num_convolution_layer=2, '
        'multi_cutoff=[4.0, 3.0], use_modality=True, '
        '_modal_map={"a": 0, "b": 1}, _number_of_modalities=2, '
        'use_modal_self_inter_outro=True, readout_as_fcn=True, '
        'radial_basis={"radial_basis_name": "bessel"}, '
        'cutoff_function={"cutoff_function_name": "poly_cut"}, '
        'shift=0.0, scale=1.0, conv_denominator=10.0)\n'
        'cfg.update(chemical_species_preprocess(["Na", "Cl"]))\n'
        'build_e3_equivariant_model(cfg)\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "optax", "sevennet_exp_tpu")]\n'
        'assert not bad, bad\n'
        'print("clean")\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout
