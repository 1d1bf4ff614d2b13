"""The port's domain-decomposed MD (``parallel/``) on the CPU: the mirror of
tests/test_parallel.py, test_parallel2d.py, test_parallel3d.py and
test_brick_overflow.py::test_overflow_fallback_resumes.

The port runs every brick in one process (``devices=['cpu']``, the plain
versions of the kernels). Two oracles, each at its own limits:

  - the port's serial engine (``md.engine.MolecularDynamics``) and
    calculator, on boxes dense enough that every atom has neighbours inside
    the cutoff: |dE| <= 1e-4 eV, max|dF| <= 1e-4 eV/A, stress <= 1e-5
    eV/A^3;
  - the JAX brick engine, on the JAX tests' own boxes (and on the dense
    cube, whose mesh decomposes every axis), at the JAX tests' brick
    against serial limits: 5e-3 eV, 5e-4 eV/A.

The JAX brick engine takes the plain difference of positions along an
axis the mesh does not decompose, so on a dense box its slabs and pencils
lose the edges that cross that boundary; the port takes the minimum image
there (``BrickSpec.mic_axes``). ``test_jax_slab_drops_boundary_edges``
records the difference.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.parallel.mdbrick import BrickMolecularDynamics as JBrick
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.parallel import mdbrick as MB
from sevennet_exp_tpu_torch.parallel.brick import decompose_brick
from sevennet_exp_tpu_torch.parallel.md import ParallelMolecularDynamics
from sevennet_exp_tpu_torch.parallel.md2d import ParallelMolecularDynamics2D
from test_parallel import _long_box
from test_parallel2d import _flat_box
from test_parallel3d import _cube
from test_torch_brick import box

torch.set_num_threads(2)
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5      # port brick vs port serial
JE_TOL, JF_TOL = 5e-3, 5e-4                  # port brick vs JAX brick
CPU = dict(devices=['cpu'])


def _port(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


@pytest.fixture(scope='module')
def setup():
    config = tiny_model_config({'cutoff': 3.5, 'channel': 4, 'lmax': 1,
                                'num_convolution_layer': 2})
    jmodel = jbuild(config)
    jparams, _ = jmodel.init(jax.random.PRNGKey(5))
    model = build_e3_equivariant_model(config)
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return model, jmodel, jparams


def _serial(model, at):
    """(E, F, stress Voigt) of the port's serial engine."""
    md = MolecularDynamics(model, _port(at), device='cpu', ensemble='nve',
                           skin=0.5)
    cell = torch.as_tensor(np.asarray(at.cell), dtype=torch.float32)
    e, f, s = md._efs_fn(md.state.pos, md._grid(), cell)
    return float(e), f.numpy(), s.numpy()


def _calc_stress(model, at):
    """The calculator's stress in the engine's convention (-virial/V,
    xx yy zz xy yz zx)."""
    s = SevenNetCalculator(model, device='cpu').calculate(at)['stress']
    return -np.array([s[0], s[1], s[2], s[5], s[3], s[4]])


def _check_serial(pmd, model, at):
    e, f, s = pmd.energy_forces(return_stress=True)
    e_ref, f_ref, s_ref = _serial(model, at)
    assert abs(e - e_ref) <= E_TOL, (e, e_ref)
    assert np.abs(f - f_ref).max() <= F_TOL
    assert np.abs(s - s_ref).max() <= S_TOL
    assert np.abs(f_ref).max() > 1e-3       # the box has real forces
    return e, f, s


def _check_jax(pmd, jmodel, jparams, at, mesh, axes=None):
    jmd = JBrick(jmodel, jparams, at, mesh_shape=mesh, axes=axes,
                 ensemble='nve', skin=0.5, use_pallas=False)
    e_j, f_j, s_j = jmd.energy_forces(return_stress=True)
    e, f, s = pmd.energy_forces(return_stress=True)
    assert abs(e - e_j) <= JE_TOL, (e, e_j)
    assert np.abs(f - f_j).max() <= JF_TOL


# -- slabs (test_parallel.py) ---------------------------------------------

@pytest.mark.parametrize('n_dev', [2, 4, 8])
def test_parallel_matches_serial(setup, n_dev):
    model, jmodel, jparams = setup
    at = box((12, 3, 3))
    pmd = ParallelMolecularDynamics(model, _port(at), n_devices=n_dev,
                                    ensemble='nve', skin=0.5, **CPU)
    _check_serial(pmd, model, at)
    if n_dev == 2:
        at = _long_box()
        pmd = ParallelMolecularDynamics(model, _port(at), n_devices=2,
                                        ensemble='nve', skin=0.5, **CPU)
        _check_jax(pmd, jmodel, jparams, at, (2,))


def test_parallel_md_runs(setup):
    model = setup[0]
    at = box((12, 3, 3))
    pmd = ParallelMolecularDynamics(model, _port(at), n_devices=4,
                                    ensemble='nvt', rebuild_every=5,
                                    dt_fs=1.0, skin=1.0, **CPU)
    out = pmd.run(10)
    assert np.isfinite(out['energy']).all()
    gp, gv = pmd.gather_global()
    assert gp.shape == (len(at), 3) and np.isfinite(gp).all()


def test_parallel_stress_matches_serial(setup):
    model = setup[0]
    at = box((12, 3, 3))
    pmd = ParallelMolecularDynamics(model, _port(at), n_devices=4,
                                    ensemble='nve', skin=0.5, **CPU)
    _, _, s = pmd.energy_forces(return_stress=True)
    np.testing.assert_allclose(s, _calc_stress(model, _port(at)), rtol=0,
                               atol=S_TOL)


def test_parallel_nvt_global_thermostat(setup):
    """One global Nose-Hoover: the kinetic energy summed over the slabs,
    real-atom degrees of freedom; the temperature tracks the target."""
    model = setup[0]
    at = box((12, 3, 3))
    pmd = ParallelMolecularDynamics(model, _port(at), n_devices=4,
                                    ensemble='nvt', rebuild_every=5,
                                    dt_fs=1.0, skin=1.0,
                                    temperature_K=300.0, seed=3, **CPU)
    out = pmd.run(23)       # exact step count with a remainder chunk
    assert pmd.time_steps == 23 and list(out['steps']) == [5] * 4 + [3]
    assert pmd._xi.ndim == 0 and np.isfinite(float(pmd._xi))
    assert np.isfinite(out['temperature']).all()
    assert 100.0 < out['temperature'][-1] < 600.0
    assert np.isfinite(out['stress']).all()


def test_jax_slab_drops_boundary_edges(setup):
    """On a dense box the JAX slab engine misses the edges across the
    undecomposed periodic axes (forces off by a good part of their size);
    the port, with the minimum image there, equals the serial engine."""
    model, jmodel, jparams = setup
    at = box((12, 3, 3))
    pmd = ParallelMolecularDynamics(model, _port(at), n_devices=2,
                                    ensemble='nve', skin=0.5, **CPU)
    _, f, _ = _check_serial(pmd, model, at)
    f_j = JBrick(jmodel, jparams, at, mesh_shape=(2,), ensemble='nve',
                 skin=0.5, use_pallas=False).energy_forces()[1]
    assert np.abs(f_j - f).max() > 0.1 * np.abs(f).max()


# -- pencils (test_parallel2d.py) -------------------------------------------

def test_2d_matches_serial_2x2(setup):
    model, jmodel, jparams = setup
    at = box((6, 6, 3))
    pmd = ParallelMolecularDynamics2D(model, _port(at), mesh_shape=(2, 2),
                                      ensemble='nve', skin=0.5, **CPU)
    _check_serial(pmd, model, at)
    at = _flat_box()
    pmd = ParallelMolecularDynamics2D(model, _port(at), mesh_shape=(2, 2),
                                      ensemble='nve', skin=0.5, **CPU)
    _check_jax(pmd, jmodel, jparams, at, (2, 2))


def test_2d_short_nvt_run(setup):
    model = setup[0]
    at = box((6, 6, 3))
    pmd = ParallelMolecularDynamics2D(model, _port(at), mesh_shape=(2, 2),
                                      ensemble='nvt', rebuild_every=4,
                                      dt_fs=1.0, skin=1.0, seed=2, **CPU)
    out = pmd.run(9)
    assert pmd.time_steps == 9
    assert np.isfinite(out['energy']).all()
    assert np.isfinite(out['temperature']).all()


def test_2d_matches_serial_4x4_16dev(setup):
    """Sixteen pencils in one process: 5.4 A wide, where sixteen slabs
    (1.35 A) could not decompose the box."""
    model = setup[0]
    at = box((6, 6, 3))
    with pytest.raises(ValueError, match='brick width'):
        decompose_brick(_port(at), (16,), 4.0)
    pmd = ParallelMolecularDynamics2D(model, _port(at), mesh_shape=(4, 4),
                                      ensemble='nve', skin=0.5, **CPU)
    assert pmd.n_dev == 16
    _check_serial(pmd, model, at)


# -- bricks (test_parallel3d.py) --------------------------------------------

def test_brick_2x2x2_matches_serial(setup):
    model, jmodel, jparams = setup
    at = box((4, 4, 4))
    pmd = MB.BrickMolecularDynamics(model, _port(at), mesh_shape=(2, 2, 2),
                                    ensemble='nve', skin=0.5, **CPU)
    _, _, s = _check_serial(pmd, model, at)
    np.testing.assert_allclose(s, _calc_stress(model, _port(at)), rtol=0,
                               atol=S_TOL)
    # every axis decomposed: the JAX engine is right on the dense cube too
    _check_jax(pmd, jmodel, jparams, at, (2, 2, 2))
    at = _cube()
    pmd = MB.BrickMolecularDynamics(model, _port(at), mesh_shape=(2, 2, 2),
                                    ensemble='nve', skin=0.5, **CPU)
    _check_jax(pmd, jmodel, jparams, at, (2, 2, 2))


def test_brick_nvt_run_with_migration(setup):
    model = setup[0]
    at = box((4, 4, 4))
    pmd = MB.BrickMolecularDynamics(model, _port(at), mesh_shape=(2, 2, 2),
                                    ensemble='nvt', rebuild_every=4,
                                    dt_fs=1.0, skin=1.0, seed=3, **CPU)
    out = pmd.run(9)
    assert pmd.time_steps == 9
    assert np.isfinite(out['energy']).all()
    assert np.isfinite(out['temperature']).all()
    gp, _ = pmd.gather_global()
    assert gp.shape == (len(at), 3) and np.isfinite(gp).all()


def test_brick_nvt_matches_jax_trajectory(setup):
    """Port bricks and JAX bricks from the same velocity draw (both engines
    draw per packed slot from the seed): the same NVT trajectory, host
    re-decomposition between chunks."""
    model, jmodel, jparams = setup
    at = box((4, 4, 4))
    kw = dict(mesh_shape=(2, 2, 2), ensemble='nvt', rebuild_every=3,
              dt_fs=2.0, skin=1.0, seed=3, temperature_K=700.0,
              device_rebuild=False)
    out = MB.BrickMolecularDynamics(model, _port(at), **kw, **CPU).run(6)
    ref = JBrick(jmodel, jparams, at, use_pallas=False, **kw).run(6)
    np.testing.assert_allclose(out['energy'], ref['energy'], rtol=0,
                               atol=JE_TOL)
    np.testing.assert_allclose(out['temperature'], ref['temperature'],
                               rtol=1e-4)


def test_device_rebuild_matches_host_rebuild(setup):
    """On-device migration and rebuild reproduces the host re-decomposing
    trajectory, keeps every atom once through migrations, and leaves
    forces equal to the serial engine's."""
    model = setup[0]
    at = box((4, 4, 4))
    kw = dict(mesh_shape=(2, 2, 2), ensemble='nvt', rebuild_every=3,
              dt_fs=2.0, skin=1.0, seed=3, temperature_K=700.0, **CPU)
    oh = MB.BrickMolecularDynamics(model, _port(at), device_rebuild=False,
                                   **kw).run(9)
    pd = MB.BrickMolecularDynamics(model, _port(at), device_rebuild=True,
                                   **kw)
    od = pd.run(9)
    np.testing.assert_allclose(od['energy'], oh['energy'], rtol=0,
                               atol=E_TOL)
    np.testing.assert_allclose(od['temperature'], oh['temperature'],
                               rtol=1e-5)
    # a hot continuation migrates atoms (cadence 3 at 700 K)
    pd.run(30)
    ids = np.concatenate([i[m > 0].numpy()
                          for i, m in zip(pd.ids, pd.loc_mask)])
    assert np.array_equal(np.sort(ids), np.arange(len(at)))
    assert pd.comm_stats()['host_redecompositions'] == 0
    gp, _ = pd.gather_global()
    moved = type(at)(atomic_numbers=at.atomic_numbers, pos=gp, cell=at.cell,
                     pbc=at.pbc)
    _check_serial(pd, model, moved)


@pytest.mark.parametrize('route', ['plain', 'geom'])
def test_brick_chunked_conv_matches_whole(setup, route):
    """Convolutions chunk by chunk in every brick equal the whole-array
    bricks: 'geom' is the geometry-fused chunked path (``_ChunkedConvFn``,
    the geom pair's plain versions here), 'plain' the plain chain per chunk
    (``use_kernels=False``)."""
    model = setup[0]
    at = box((4, 4, 4))
    kw = dict(mesh_shape=(2, 2, 2), ensemble='nve', skin=0.5, **CPU)
    whole = MB.BrickMolecularDynamics(model, _port(at), **kw)
    e, f = whole.energy_forces()
    pmd = MB.BrickMolecularDynamics(model, _port(at), conv_chunk_rows=512,
                                    use_kernels=route == 'geom', **kw)
    assert 0 < pmd.conv_chunk_rows < pmd.spec.rows
    assert pmd.conv_chunk_rows % pmd.spec.deg_cap == 0
    if route == 'geom':
        assert pmd._geom_ok
        data = pmd._brick_data(0, pmd._refresh(pmd.pos, shifts=True)[0],
                               None)
        assert data['edge_geom_packed']
    e_c, f_c = pmd.energy_forces()
    assert abs(e_c - e) <= E_TOL
    assert np.abs(f_c - f).max() <= F_TOL


# -- the capacity fallback (test_brick_overflow.py) ---------------------------

def _exact_caps(spec):
    """A zero-slack copy of a spec's capacities."""
    deg = spec.edge_mask.reshape(spec.edge_mask.shape[0], -1,
                                 spec.deg_cap).sum(axis=2).max()
    cap_g = tuple(int(m.sum(axis=2).max()) for m in spec.send_mask)
    return dataclasses.replace(spec, deg_cap=int(deg), rows=0, cap_g=cap_g,
                               cap_loc=int(spec.n_loc.max()))


def test_overflow_fallback_resumes(setup):
    """Zero-slack capacities overflow on the device at 1500 K; the engine
    re-decomposes on the host with fresh margins and retries, on the same
    trajectory as an untampered engine."""
    model = setup[0]
    at = _port(box((4, 4, 4)))
    kw = dict(mesh_shape=(2, 2, 2), ensemble='nvt', temperature_K=1500.0,
              rebuild_every=3, seed=3, skin=0.5, **CPU)
    ref = MB.BrickMolecularDynamics(model, at, **kw)
    _, gv0 = ref.gather_global()
    out_ref = ref.run(18)

    md = MB.BrickMolecularDynamics(model, at, **kw)
    md.spec = decompose_brick(at, md.mesh_shape, md.build_cutoff,
                              axes=md.axes, prev=_exact_caps(md.spec))
    md._push_state(vel_global=gv0)
    assert md.spec.deg_cap <= ref.spec.deg_cap
    out = md.run(18)
    assert md.comm_stats()['host_redecompositions'] >= 1, \
        'no overflow triggered; tighten the test'
    assert ref.comm_stats()['host_redecompositions'] == 0
    np.testing.assert_allclose(out['energy'], out_ref['energy'], rtol=0,
                               atol=E_TOL)
    np.testing.assert_allclose(out['temperature'], out_ref['temperature'],
                               rtol=1e-4)
    ids = np.concatenate([i[m > 0].numpy()
                          for i, m in zip(md.ids, md.loc_mask)])
    assert np.array_equal(np.sort(ids), np.arange(len(at)))


# -- the engine's own contracts ----------------------------------------------

def test_halo_hook_and_launches_per_brick(setup, monkeypatch):
    """``apply_energy(halo_refresh=)`` calls the hook once before each
    convolution and changes nothing with the identity; the brick engine
    walks one model per brick and, on the CPU, launches no kernel."""
    model = setup[0]
    at = box((4, 4, 4))
    pmd = MB.BrickMolecularDynamics(model, _port(at), mesh_shape=(2, 2, 2),
                                    ensemble='nve', skin=0.5, **CPU)
    data = pmd._brick_data(0, pmd._refresh(pmd.pos, shifts=True)[0], None)
    calls = []

    def hook(x):
        calls.append(x.shape)
        return x

    plain = model.apply_energy(dict(data))
    hooked = model.apply_energy(dict(data), halo_refresh=hook)
    assert len(calls) == 2 and calls[0][0] == pmd.spec.cap_all
    assert torch.equal(plain['atomic_energy'], hooked['atomic_energy'])
    pfc.reset_launch_counts()
    pmd.energy_forces()
    assert not any(pfc.launch_counts.values())
    routes = pmd.conv_routes()
    assert [r['route'] for r in routes] == ['kernel', 'kernel']


def test_no_card_no_default_device(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        MB.BrickMolecularDynamics(setup[0], _port(box((4, 4, 4))),
                                  mesh_shape=(2, 2, 2))
    with pytest.raises(ValueError, match='one slab'):
        ParallelMolecularDynamics(setup[0], _port(box((4, 4, 4))),
                                  n_devices=1, **CPU)


def test_thin_undecomposed_axis_raises(setup):
    """The minimum image along an axis the mesh leaves whole needs that
    width at least twice the build cutoff; a thinner cell raises rather
    than count a pair twice. _long_box is 8.4 A across y and z."""
    at = _port(_long_box())
    pmd = ParallelMolecularDynamics(setup[0], at, n_devices=2,
                                    ensemble='nve', skin=0.5, **CPU)
    assert pmd.spec.mic_axes == (1, 2)           # 2 x (3.5 + 0.5) <= 8.4
    with pytest.raises(ValueError, match='undecomposed axis 1'):
        ParallelMolecularDynamics(setup[0], at, n_devices=2,
                                  ensemble='nve', skin=1.0, **CPU)  # 9.0
    with pytest.raises(ValueError, match='undecomposed axis 2'):
        MB.BrickMolecularDynamics(setup[0], _port(box((6, 6, 2))),
                                  mesh_shape=(2, 2), ensemble='nve',
                                  skin=0.5, **CPU)  # 7.2 A along z
