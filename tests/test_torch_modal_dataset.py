"""The port's multi-modal dataset (``data/modal_dataset.py``), the dataset
parts of ``tests/test_modal.py`` against the JAX package, on two
modalities cut from the repo's NaCl data (different frames, so the pooled
and the modal-wise statistics differ):

  - ``modal_map``, each graph's MODAL_TYPE and modality name, species;
  - pooled statistics (per-atom energy mean and std, force rms,
    ``avg_num_neigh``, element-wise reference energies) and
    ``modal_statistic`` equal JAX's (1e-12 relative);
  - the config ``multimodal_dataset_from_config`` resolves (modal-wise
    shift, pooled scale and conv_denominator, the modality keys) equals
    JAX's; the model it builds runs on a two-modality batch, the modality
    changes the answer, and one train step runs.
"""

import copy
import os

import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.data import modal_dataset as jmd
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.data import modal_dataset as pmd
from sevennet_exp_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_exp_tpu_torch.data.graph import collate_graphs
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.model import flatten
from sevennet_exp_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, 'nacl_classical_data')
POOLED = ('per_atom_energy_mean', 'per_atom_energy_std', 'force_rms',
          'avg_num_neigh', 'sqrt_avg_num_neigh')
torch.set_num_threads(2)


def _config(files):
    cfg = tiny_model_config({
        'cutoff': 4.0, 'channel': 4, 'lmax': 1,
        'num_convolution_layer': 2,
        'use_modality': True,
        'use_modal_self_inter_intro': True,
        'use_modal_output_block': True,
        'use_modal_wise_shift': True,
        'use_modal_wise_scale': False,
        'shift': 'per_atom_energy_mean',
        'scale': 'force_rms',
        'conv_denominator': 'avg_num_neigh',
        'chemical_species': 'auto',
        'loss': 'mse', 'optimizer': 'adam', 'optim_param': {'lr': 0.01},
        'is_train_stress': True,
    })
    cfg[KEY.LOAD_TRAINSET] = files
    return cfg


@pytest.fixture(scope='module')
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('modal')
    pbe, scan = str(tmp / 'pbe.extxyz'), str(tmp / 'scan.extxyz')
    write_extxyz(pbe, read_extxyz(os.path.join(DATA, 'valid.extxyz'))[:7])
    write_extxyz(scan, read_extxyz(os.path.join(DATA, 'train.extxyz'))[:9])
    files = {'pbe': [pbe], 'scan': [scan]}
    cp, cj = _config(files), _config(copy.deepcopy(files))
    dp = pmd.multimodal_dataset_from_config(cp, str(tmp / 'p'))
    dj = jmd.multimodal_dataset_from_config(cj, str(tmp / 'j'))
    return cp, cj, dp['trainset'], dj['trainset']


def test_modal_map_and_tags_equal_jax(built):
    cp, cj, mm, jm = built
    assert cp[KEY.MODAL_MAP] == cj[KEY.MODAL_MAP] == {'pbe': 0, 'scan': 1}
    assert mm.modal_map == jm.modal_map
    assert len(mm) == len(jm) == 16
    assert [g[KEY.MODAL_TYPE] for g in mm.graphs] == \
        [g[KEY.MODAL_TYPE] for g in jm.graphs] == [0] * 7 + [1] * 9
    assert [g[KEY.DATA_MODALITY] for g in mm.graphs] == \
        [g[KEY.DATA_MODALITY] for g in jm.graphs]
    assert mm.species == jm.species == ['Cl', 'Na']
    assert mm[3][KEY.ENERGY] == jm[3][KEY.ENERGY]


def test_pooled_and_modal_statistics_equal_jax(built):
    _, _, mm, jm = built
    for k in POOLED:
        np.testing.assert_allclose(getattr(mm, k), getattr(jm, k),
                                   rtol=1e-12, err_msg=k)
    np.testing.assert_allclose(mm.elemwise_reference_energies,
                               jm.elemwise_reference_energies,
                               rtol=1e-12, atol=1e-12)
    for k in ('per_atom_energy_mean', 'force_rms', 'avg_num_neigh'):
        mine, theirs = mm.modal_statistic(k), jm.modal_statistic(k)
        assert set(mine) == set(theirs) == {'pbe', 'scan'}
        for m in mine:
            np.testing.assert_allclose(mine[m], theirs[m], rtol=1e-12)
        assert mine['pbe'] != mine['scan']


def test_resolved_config_equals_jax_and_trains(built):
    cp, cj, mm, _ = built
    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR, KEY.USE_MODALITY,
              KEY.NUM_MODALITIES, KEY.CHEMICAL_SPECIES, KEY.TYPE_MAP):
        if isinstance(cj[k], dict) and k == KEY.SHIFT:
            assert set(cp[k]) == set(cj[k])
            for m in cj[k]:
                np.testing.assert_allclose(cp[k][m], cj[k][m], rtol=1e-12)
        elif isinstance(cj[k], float):
            np.testing.assert_allclose(cp[k], cj[k], rtol=1e-12)
        else:
            assert cp[k] == cj[k], k
    assert isinstance(cp[KEY.SHIFT], dict)
    assert isinstance(cp[KEY.SCALE], float)

    model = build_e3_equivariant_model(cp)
    params, mask = model.init(torch.Generator().manual_seed(0))
    model.load_state(flatten(params))
    trainer = Trainer(model, params, mask, cp, device='cpu')
    graphs = [mm.graphs[0], mm.graphs[-1]]
    batch = collate_graphs(graphs, n_node=136, n_edge=8192, n_graph=3)
    assert batch[KEY.MODAL_TYPE].tolist() == [0, 1, 0]
    out = model.apply(trainer.batch_to_device(batch))
    e = out[KEY.PRED_TOTAL_ENERGY].detach().numpy()
    assert np.isfinite(e).all()
    flipped = dict(batch)
    flipped[KEY.MODAL_TYPE] = 1 - batch[KEY.MODAL_TYPE]
    e2 = model.apply(trainer.batch_to_device(flipped))[
        KEY.PRED_TOTAL_ENERGY].detach().numpy()
    assert not np.allclose(e[:2], e2[:2])
    before = {k: v.detach().clone() for k, v in trainer.params.items()}
    trainer.run_one_epoch([batch], is_train=True)
    assert any(not torch.equal(before[k], v)
               for k, v in trainer.params.items())
