"""The port's lazy atoms dataset (``data/atoms_dataset.py``) against the
JAX package's and against the graph dataset:

  - every statistic the model build reads (per-atom energy mean and std,
    force rms, element-wise reference energies, ``avg_num_neigh`` on the
    same sample), the species and atom counts and the loader's size
    estimate equal JAX's ``SevenNetAtomsDataset``; the ones both dataset
    kinds define equal the graph dataset's (1e-12 relative);
  - ``dataset_type: atoms`` in ``datasets_from_config``: the same resolved
    shift, scale and conv_denominator and the same lazy train/valid split
    as JAX, frame for frame;
  - ``train_v2`` with an atoms dataset for one epoch on the CPU: the
    first step's loss equals the graph dataset's (1e-6 relative: the
    batches are padded to other capacities).
"""

import os

import numpy as np
import pytest
import torch

from sevennet_exp_tpu.data import atoms_dataset as jad
from sevennet_exp_tpu.data import dataset as jds
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.data import atoms_dataset as pad
from sevennet_exp_tpu_torch.data import dataset as pds
from sevennet_exp_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_exp_tpu_torch.data.loader import GraphLoader
from sevennet_exp_tpu_torch.parse_input import read_config_yaml
from sevennet_exp_tpu_torch.scripts.train import train_v2
from sevennet_exp_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
CUTOFF = 4.0
STATS = ('per_atom_energy_mean', 'per_atom_energy_std', 'force_rms',
         'avg_num_neigh', 'sqrt_avg_num_neigh', 'species', 'natoms')
torch.set_num_threads(2)


@pytest.fixture(scope='module')
def pair():
    return (pad.SevenNetAtomsDataset(CUTOFF, files=[VALID]),
            jad.SevenNetAtomsDataset(CUTOFF, files=[VALID]))


def test_statistics_equal_jax(pair):
    mine, theirs = pair
    assert len(mine) == len(theirs) == 41
    for k in STATS:
        assert getattr(mine, k) == getattr(theirs, k), k
    np.testing.assert_array_equal(mine.elemwise_reference_energies,
                                  theirs.elemwise_reference_energies)
    assert mine.estimated_sizes() == theirs.estimated_sizes()
    # each item is the graph of its frame, built on access
    g, jg = mine[5], theirs[5]
    np.testing.assert_array_equal(np.sort(g[KEY.EDGE_IDX][0]),
                                  np.sort(jg[KEY.EDGE_IDX][0]))
    assert g[KEY.ENERGY] == jg[KEY.ENERGY]


def test_statistics_equal_the_graph_dataset(pair, tmp_path):
    mine, _ = pair
    graphs = pds.SevenNetGraphDataset(CUTOFF, root=str(tmp_path),
                                      files=[VALID])
    for k in ('per_atom_energy_mean', 'force_rms', 'avg_num_neigh'):
        np.testing.assert_allclose(getattr(mine, k), getattr(graphs, k),
                                   rtol=1e-12, err_msg=k)
    assert mine.species == graphs.species
    np.testing.assert_allclose(mine.elemwise_reference_energies,
                               graphs.elemwise_reference_energies,
                               rtol=1e-12, atol=1e-12)


def test_datasets_from_config_atoms_split_equals_jax(tmp_path):
    def config():
        return {KEY.CUTOFF: CUTOFF, KEY.CHEMICAL_SPECIES: 'auto',
                KEY.LOAD_TRAINSET: [VALID], KEY.DATASET_TYPE: 'atoms',
                KEY.SHIFT: 'per_atom_energy_mean', KEY.SCALE: 'force_rms',
                KEY.CONV_DENOMINATOR: 'avg_num_neigh', KEY.RANDOM_SEED: 3,
                KEY.RATIO: 0.2}
    cp, cj = config(), config()
    dp = pds.datasets_from_config(cp, str(tmp_path / 'p'))
    dj = jds.datasets_from_config(cj, str(tmp_path / 'j'))
    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR,
              KEY.CHEMICAL_SPECIES, KEY.TYPE_MAP):
        assert cp[k] == cj[k], k
    assert set(dp) == set(dj) == {'trainset', 'validset'}
    for name in dp:
        assert isinstance(dp[name], pad.SevenNetAtomsDataset)
        assert len(dp[name]) == len(dj[name])
        for a, b in zip(dp[name].atoms_list, dj[name].atoms_list):
            np.testing.assert_array_equal(a.pos, b.pos)
    assert not os.path.exists(tmp_path / 'p' / 'sevenn_data')


def test_loader_builds_graphs_on_access(pair):
    mine, _ = pair
    loader = GraphLoader(mine, batch_size=4)
    assert loader.graphs is mine
    sizes = mine.estimated_sizes()
    assert loader.n_edge >= sum(s[1] for s in sizes[:4])
    batches = list(loader)
    assert len(batches) == 11
    assert int(sum(b[KEY.GRAPH_MASK].sum() for b in batches)) == 41
    # an estimate that undershoots grows the capacities and collates again
    tight = GraphLoader(mine, batch_size=4, n_edge=128)
    first = next(iter(tight))
    assert tight.n_edge > 128
    assert first[KEY.EDGE_IDX].shape[1] == tight.n_edge


_YAML = """\
model:
  chemical_species: auto
  cutoff: 4.0
  channel: 4
  lmax: 1
  num_convolution_layer: 2
  weight_nn_hidden_neurons: [16, 16]
  self_connection_type: linear
  conv_denominator: avg_num_neigh
train:
  random_seed: 3
  epoch: 1
  loss: huber
  loss_param: {{delta: 0.01}}
  optimizer: adam
  optim_param: {{lr: 0.004}}
  force_loss_weight: 25.0
  stress_loss_weight: 0.01
  per_epoch: 1
  device: cpu
data:
  dataset_type: {kind}
  shift: per_atom_energy_mean
  scale: force_rms
  batch_size: 3
  load_trainset_path: ['{path}']
"""


def test_train_v2_first_step_equals_the_graph_dataset(tmp_path,
                                                      monkeypatch):
    data = str(tmp_path / 'six.extxyz')
    write_extxyz(data, read_extxyz(VALID)[:6])
    losses = {}
    orig = Trainer.train_step
    for kind in ('graph', 'atoms'):
        seen = losses.setdefault(kind, [])

        def step(self, b, _seen=seen):
            stats = orig(self, b)
            _seen.append(float(stats['TotalLoss'][0]))
            return stats

        monkeypatch.setattr(Trainer, 'train_step', step)
        (tmp_path / kind).mkdir()
        yaml_path = tmp_path / f'{kind}.yaml'
        yaml_path.write_text(_YAML.format(kind=kind, path=data))
        train_v2(read_config_yaml(str(yaml_path)), str(tmp_path / kind))
        assert os.path.exists(tmp_path / kind / 'lc.csv')
    assert len(losses['graph']) == len(losses['atoms']) == 2
    np.testing.assert_allclose(losses['atoms'][0], losses['graph'][0],
                               rtol=1e-6)
