"""The port's batch inference (``scripts/inference.py``) against the JAX
package's ``inference()`` on the same checkpoint and structures: five
labelled NaCl frames, batch sizes 1 and 3 (the second batch carries a pad
graph, pad atoms and pad edges), then a two-modality model with
``modal=``. The four files compare row for row: ``per_graph.csv`` and
``per_atom.csv`` within PERF.md's limits (1e-4 eV, 1e-4 eV/A, stress
1e-5 eV/A^3 = 0.0160218 kbar; positions and numbers exact),
``info.csv`` exactly, ``errors.txt`` line for line within the same
limits. The port runs on the CPU with kernels on (their plain version
there); every batch is padded to the loader's one set of capacities.
"""

import csv
import os

import jax
import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops import pallas_tp
from sevennet_exp_tpu.scripts.inference import inference as jinference
from sevennet_exp_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_exp_tpu_torch.scripts.inference import inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
KBAR = 1602.1766208
TOL = {'energy': 1e-4, 'force': 1e-4, 'stress': 1e-5 * KBAR}
FILES = ('per_graph.csv', 'per_atom.csv', 'info.csv', 'errors.txt')
torch.set_num_threads(2)


def _setup(tmp_path, modal=False):
    over = {'lmax': 1, 'num_convolution_layer': 2,
            'weight_nn_hidden_neurons': [16, 16], 'shift': -3.0,
            'scale': 1.5}
    if modal:
        over.update({'use_modality': True,
                     '_modal_map': {'pbe': 0, 'scan': 1},
                     '_number_of_modalities': 2,
                     'use_modal_self_inter_intro': True,
                     'use_modal_output_block': True})
    cfg = tiny_model_config(over)
    jp, _ = jbuild(cfg).init(jax.random.PRNGKey(6))
    ckpt = str(tmp_path / 'model.sevennet')
    jsave(ckpt, cfg, jp, epoch=2)
    data = str(tmp_path / 'five.extxyz')
    write_extxyz(data, read_extxyz(VALID)[:5])
    return ckpt, data


def _rows(path):
    with open(path, newline='') as fh:
        return list(csv.DictReader(fh))


def _tol(col):
    if 'stress' in col:
        return TOL['stress']
    if 'force' in col:
        return TOL['force']
    return TOL['energy']


def _compare(mine, theirs):
    for name in FILES:
        assert os.path.exists(os.path.join(mine, name)), name
    for name in ('per_graph.csv', 'per_atom.csv'):
        a, b = _rows(os.path.join(mine, name)), _rows(
            os.path.join(theirs, name))
        assert len(a) == len(b) > 0
        assert list(a[0]) == list(b[0])
        for ra, rb in zip(a, b):
            for col in rb:
                x, y = float(ra[col]), float(rb[col])
                if col in ('stct_id', 'atom_id', 'atomic_numbers',
                           'num_atoms') or col.startswith('pos_'):
                    assert x == y, col
                elif np.isnan(y):
                    assert np.isnan(x), col
                else:
                    assert abs(x - y) <= _tol(col), (col, x, y)
    assert _rows(os.path.join(mine, 'info.csv')) == \
        _rows(os.path.join(theirs, 'info.csv'))
    la = open(os.path.join(mine, 'errors.txt')).read().splitlines()
    lb = open(os.path.join(theirs, 'errors.txt')).read().splitlines()
    assert [line.split(':')[0] for line in la] == \
        [line.split(':')[0] for line in lb] == \
        ['Energy MAE', 'Energy RMSE', 'Force MAE', 'Force RMSE',
         'Stress MAE', 'Stress RMSE']
    for x, y in zip(la, lb):
        v, w = float(x.split()[2]), float(y.split()[2])
        assert abs(v - w) <= _tol(x.lower()) + 2e-6, (x, y)


@pytest.mark.parametrize('batch_size', [1, 3])
def test_inference_equals_jax(batch_size, tmp_path):
    ckpt, data = _setup(tmp_path)
    mine, theirs = str(tmp_path / 'port'), str(tmp_path / 'jax')
    timings = []
    res = inference(ckpt, [data], mine, batch_size=batch_size,
                    device='cpu', timings=timings)
    with pallas_tp.disabled():
        jres = jinference(ckpt, [data], theirs, batch_size=batch_size)
    assert len(res) == len(jres) == 5
    _compare(mine, theirs)
    # one set of capacities serves every batch
    assert len(timings) == -(-5 // batch_size)
    assert len({(t['n_node'], t['n_edge']) for t in timings}) == 1
    # per graph: stress and energy are each graph's own
    for r, jr in zip(res, jres):
        assert abs(r['pred_energy'] - jr['pred_energy']) <= TOL['energy']
        assert np.abs(r['pred_stress'] - jr['pred_stress']).max() <= 1e-5
    assert np.abs(res[0]['pred_stress'] - res[1]['pred_stress']).max() \
        > 1e-5


def test_inference_modal(tmp_path):
    ckpt, data = _setup(tmp_path, modal=True)
    out = {}
    for modal in ('pbe', 'scan'):
        mine = str(tmp_path / f'port_{modal}')
        theirs = str(tmp_path / f'jax_{modal}')
        out[modal] = inference(ckpt, [data], mine, batch_size=3,
                               modal=modal, device='cpu')
        with pallas_tp.disabled():
            jinference(ckpt, [data], theirs, batch_size=3, modal=modal)
        _compare(mine, theirs)
    assert abs(out['pbe'][0]['pred_energy']
               - out['scan'][0]['pred_energy']) > 1e-3
