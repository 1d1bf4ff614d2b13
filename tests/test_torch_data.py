"""The port's training data path on the CPU against the JAX package:

  - ``read_extxyz`` on ``nacl_classical_data/valid.extxyz``: every field of
    every frame equal (numbers, positions, cell, pbc, energy, forces,
    stress, info), and ``write_extxyz`` reads back to the same frames;
  - ``atoms_to_graph`` + ``collate_graphs`` with labels: equal arrays
    (edges sorted first: the packages' neighbor lists may list them in
    another order);
  - ``datasets_from_config``: the statistics the model build reads
    (shift, scale, avg_num_neigh) to 1e-6 relative, and the processed
    pickle of one package loads in the other;
  - ``GraphLoader``: the same batch order and the same padded arrays as
    the JAX loader for the same seed, epoch after epoch;
  - ``braceexpand`` equal to the JAX copy; the inputs that raised before
    the port read them (OUTCAR, ``structure_list``, ``dataset_type:
    atoms``) now dispatch to their readers (``tests/test_torch_vasp.py``
    and ``test_torch_atoms_dataset.py`` hold them to JAX).
"""

import os
import pickle

import numpy as np
import pytest

from sevennet_exp_tpu.data import dataset as jds
from sevennet_exp_tpu.data import extxyz as jx
from sevennet_exp_tpu.data import graph as jgraph
from sevennet_exp_tpu.data import loader as jloader
from sevennet_exp_tpu.data.vasp import braceexpand as jbrace
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.data import dataset as pds
from sevennet_exp_tpu_torch.data import extxyz as px
from sevennet_exp_tpu_torch.data import graph as pgraph
from sevennet_exp_tpu_torch.data import loader as ploader

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
CUTOFF = 4.0
ATOM_FIELDS = ('atomic_numbers', 'pos', 'cell', 'pbc', 'energy', 'forces',
               'stress', 'info')


@pytest.fixture(scope='module')
def frames():
    return px.read_extxyz(VALID), jx.read_extxyz(VALID)


def _same_atoms(a, b):
    for f in ATOM_FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f)
            assert np.asarray(va).dtype == vb.dtype, f
        else:
            assert va == vb, f


def test_read_extxyz_equals_jax_field_by_field(frames):
    mine, theirs = frames
    assert len(mine) == len(theirs) == 41
    for a, b in zip(mine, theirs):
        _same_atoms(a, b)
    assert mine[0].stress.shape == (6,) and mine[0].forces.shape == (64, 3)


def test_read_extxyz_index_forms(frames):
    mine, _ = frames
    for index in (3, '2:7', slice(1, 4)):
        got = px.read_extxyz(VALID, index)
        want = jx.read_extxyz(VALID, index)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_atoms(a, b)


def test_write_extxyz_round_trip(frames, tmp_path):
    mine, _ = frames
    path = str(tmp_path / 'out.extxyz')
    px.write_extxyz(path, mine[:3])
    back = px.read_extxyz(path)
    for a, b in zip(back, mine[:3]):
        np.testing.assert_array_equal(a.atomic_numbers, b.atomic_numbers)
        np.testing.assert_allclose(a.pos, b.pos, atol=1e-8)
        np.testing.assert_allclose(a.forces, b.forces, atol=1e-8)
        np.testing.assert_allclose(a.stress, b.stress, rtol=1e-9)
        assert abs(a.energy - b.energy) < 1e-9
    with open(path) as fh:
        assert fh.read() == open_jax_written(mine[:3], tmp_path)


def open_jax_written(frames, tmp_path):
    path = str(tmp_path / 'jax.extxyz')
    jx.write_extxyz(path, [
        jgraph.Atoms(atomic_numbers=a.atomic_numbers, pos=a.pos,
                     cell=a.cell, pbc=a.pbc, energy=a.energy,
                     forces=a.forces, stress=a.stress, info=a.info)
        for a in frames])
    with open(path) as fh:
        return fh.read()


def _sorted_graph(g):
    ei, ej = g[KEY.EDGE_IDX]
    shift = g[KEY.CELL_SHIFT]
    order = np.lexsort((shift[:, 2], shift[:, 1], shift[:, 0], ej, ei))
    out = dict(g)
    out[KEY.EDGE_IDX] = g[KEY.EDGE_IDX][:, order]
    out[KEY.EDGE_VEC] = g[KEY.EDGE_VEC][order]
    out[KEY.CELL_SHIFT] = shift[order]
    return out


def test_labeled_graph_and_batch_equal_jax(frames):
    mine, theirs = frames
    pg = [_sorted_graph(pgraph.atoms_to_graph(a, CUTOFF)) for a in mine[:4]]
    jg = [_sorted_graph(jgraph.atoms_to_graph(a, CUTOFF))
          for a in theirs[:4]]
    for a, b in zip(pg, jg):
        assert set(a) == set(b)
        for k in b:
            if k == KEY.INFO:
                assert a[k] == b[k]
                continue
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12,
                                       err_msg=k)
    pb = pgraph.collate_graphs(pg, n_node=264, n_edge=pad(pg), n_graph=5)
    jb = jgraph.collate_graphs(jg, n_node=264, n_edge=pad(pg), n_graph=5)
    assert set(pb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
        assert pb[k].dtype == jb[k].dtype, k
    # pad slots carry NaN labels, real ones none
    assert np.isnan(pb[KEY.ENERGY][4]) and np.isnan(pb[KEY.FORCE][256:]).all()
    assert not np.isnan(pb[KEY.FORCE][:256]).any()


def pad(graphs):
    return pgraph.pad_cap(sum(g[KEY.EDGE_IDX].shape[1] for g in graphs) + 7,
                          multiple=128)


def test_unlabeled_frames_need_allow_unlabeled():
    at = pgraph.build_nacl(64, rattle=0.1, seed=0)
    with pytest.raises(ValueError, match='allow_unlabeled'):
        pgraph.atoms_to_graph(at, CUTOFF)
    g = pgraph.atoms_to_graph(at, CUTOFF, allow_unlabeled=True)
    assert np.isnan(g[KEY.ENERGY]) and np.isnan(g[KEY.FORCE]).all()
    assert g[KEY.STRESS].shape == (1, 6)


def _stat_config(**over):
    config = {KEY.CUTOFF: CUTOFF, KEY.CHEMICAL_SPECIES: 'auto',
              KEY.LOAD_TRAINSET: [VALID],
              KEY.SHIFT: 'elemwise_reference_energies',
              KEY.SCALE: 'force_rms',
              KEY.CONV_DENOMINATOR: 'avg_num_neigh', KEY.RANDOM_SEED: 3,
              KEY.RATIO: 0.2}
    config.update(over)
    return config


@pytest.mark.parametrize('shift,scale', [
    ('elemwise_reference_energies', 'force_rms'),
    ('per_atom_energy_mean', 'per_atom_energy_std'),
    ('per_atom_energy_mean', 'elemwise_force_rms'),
])
def test_dataset_statistics_equal_jax(tmp_path, shift, scale):
    """Same resolved shift, scale and avg_num_neigh (1e-6 relative), the
    same random train/valid split, the same species wiring."""
    cp = _stat_config(shift=shift, scale=scale)
    cj = dict(cp)
    dp = pds.datasets_from_config(cp, str(tmp_path / 'p'))
    dj = jds.datasets_from_config(cj, str(tmp_path / 'j'))
    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR):
        np.testing.assert_allclose(np.asarray(cp[k], float),
                                   np.asarray(cj[k], float), rtol=1e-6,
                                   err_msg=k)
    for k in (KEY.CHEMICAL_SPECIES, KEY.NUM_SPECIES, KEY.TYPE_MAP):
        assert cp[k] == cj[k], k
    assert set(dp) == set(dj) == {'trainset', 'validset'}
    for name in dp:
        assert len(dp[name]) == len(dj[name])
        for a, b in zip(dp[name].graphs, dj[name].graphs):
            assert a[KEY.ENERGY] == b[KEY.ENERGY]
    assert dp['trainset'].natoms == dj['trainset'].natoms


def test_processed_pickles_load_in_both_packages(tmp_path):
    """The port writes the JAX field names, numpy only: each package reads
    the other's processed dataset without rebuilding it."""
    p = pds.SevenNetGraphDataset(CUTOFF, root=str(tmp_path / 'p'),
                                 files=[VALID], processed_name='valid')
    j = jds.SevenNetGraphDataset(CUTOFF, root=str(tmp_path / 'j'),
                                 files=[VALID], processed_name='valid')
    with open(p.processed_path, 'rb') as fh:
        payload = pickle.load(fh)
    assert set(payload) == {'graphs', 'statistics', 'cutoff', 'version'}
    j_from_p = jds.SevenNetGraphDataset(CUTOFF, root=str(tmp_path / 'p'),
                                        processed_name='valid')
    p_from_j = pds.SevenNetGraphDataset(CUTOFF, root=str(tmp_path / 'j'),
                                        processed_name='valid')
    assert len(j_from_p) == len(p_from_j) == 41
    for k in ('avg_num_neigh', 'force_rms', 'per_atom_energy_mean'):
        assert getattr(j_from_p, k) == getattr(p, k)
        assert getattr(p_from_j, k) == getattr(j, k)


@pytest.mark.parametrize('shuffle', [True, False])
def test_loader_batches_equal_jax(frames, shuffle):
    """The same graphs through both loaders: the same capacities, and per
    batch the same frames in the same order and the same padded arrays,
    over three epochs of one loader each."""
    _, theirs = frames
    graphs = [jgraph.atoms_to_graph(a, CUTOFF) for a in theirs[:13]]
    pl = ploader.GraphLoader(graphs, batch_size=4, shuffle=shuffle, seed=5)
    jl = jloader.GraphLoader(graphs, batch_size=4, shuffle=shuffle, seed=5)
    assert (pl.n_node, pl.n_edge, pl.n_graph) == (jl.n_node, jl.n_edge,
                                                  jl.n_graph)
    assert len(pl) == len(jl) == 4
    for _ in range(3):
        pbs, jbs = list(pl), list(jl)
        assert len(pbs) == len(jbs) == 4
        for pb, jb in zip(pbs, jbs):
            assert set(pb) == set(jb)
            for k in jb:
                np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)


def test_braceexpand_equals_jax():
    for expr in ('a{1..3}b', 'x{01..10..3}', '{a,b}{c,d}', 'p{5..2}',
                 'plain', 'f{a}g'):
        assert pds.braceexpand(expr) == jbrace(expr), expr


def test_inputs_not_in_the_port_yet_raise(tmp_path):
    """These inputs raised NotImplementedError until the port read them:
    they now reach the VASP readers and the lazy atoms dataset."""
    for name in ('OUTCAR', 'structure_list'):
        path = tmp_path / name
        path.write_text('')
        assert pds.read_structure_file(str(path)) == []
        assert jds.read_structure_file(str(path)) == []
    sets = pds.datasets_from_config(_stat_config(dataset_type='atoms'),
                                    str(tmp_path))
    from sevennet_exp_tpu_torch.data.atoms_dataset import (
        SevenNetAtomsDataset)
    assert isinstance(sets['trainset'], SevenNetAtomsDataset)
    assert len(sets['trainset']) + len(sets['validset']) == 41
