"""The port's continue-training (``scripts/processing_continue.py`` and
``train_v2``'s continue branch) against the JAX package's:

  - from one checkpoint, once written by the port and once by the JAX
    package (with an optax state the port's loader drops): the inherited
    shift, scale, conv_denominator and species keys, ``start_epoch``
    (the checkpoint's epoch + 1) and the starting parameters equal JAX's;
    ``train_v2`` then starts from exactly those parameters
    (``checkpoint_0``), writes its first epoch as ``start_epoch``, and its
    first step's loss equals the JAX trainer's loss on the same parameters
    and batch to 1e-5 relative;
  - an architecture mismatch with the checkpoint raises, as in JAX;
  - continuing from a reference ``.pth`` (epoch unknown: start 1) takes
    the converted parameters and trains.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.scripts.processing_continue import (
    processing_continue_v2 as jcontinue,
)
from sevennet_exp_tpu.train.trainer import Trainer as JTrainer
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.checkpoint import (
    load_native_checkpoint,
    save_checkpoint,
)
from sevennet_exp_tpu_torch.data.dataset import datasets_from_config
from sevennet_exp_tpu_torch.data.extxyz import read_extxyz, write_extxyz
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.model import flatten
from sevennet_exp_tpu_torch.scripts.processing_continue import (
    processing_continue_v2,
)
from sevennet_exp_tpu_torch.scripts.train import loader_from_config, train_v2
from sevennet_exp_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
ARCH = {'cutoff': 4.0, 'channel': 4, 'lmax': 1, 'num_convolution_layer': 2,
        'weight_nn_hidden_neurons': [16, 16],
        'self_connection_type': 'linear', 'shift': -3.25, 'scale': 1.7,
        'conv_denominator': 11.5}
torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return {'/'.join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _checkpoint(tmp_path, writer, epoch=4):
    cfg = tiny_model_config(dict(ARCH))
    path = str(tmp_path / f'{writer}.pth.sevennet')
    if writer == 'jax':
        jp, _ = jbuild(cfg).init(jax.random.PRNGKey(9))
        jsave(path, cfg, jp, optimizer_state=optax.adam(1e-3).init(jp),
              epoch=epoch)
    else:
        params, _ = build_e3_equivariant_model(cfg).init(
            torch.Generator().manual_seed(9))
        save_checkpoint(path, cfg, {
            k: {kk: (vv.numpy() if torch.is_tensor(vv) else
                     {a: b.numpy() for a, b in vv.items()})
                for kk, vv in v.items()} for k, v in params.items()},
            epoch=epoch)
    return path


def _train_config(tmp_path, checkpoint, **arch):
    data = str(tmp_path / 'six.extxyz')
    if not os.path.exists(data):
        write_extxyz(data, read_extxyz(VALID)[:6])
    cfg = tiny_model_config(dict(ARCH, **arch))
    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR):
        cfg[k] = {KEY.SHIFT: 'per_atom_energy_mean', KEY.SCALE: 'force_rms',
                  KEY.CONV_DENOMINATOR: 'avg_num_neigh'}[k]
    cfg[KEY.CHEMICAL_SPECIES] = 'auto'
    cfg.update({KEY.LOAD_TRAINSET: [data], KEY.BATCH_SIZE: 3,
                KEY.RANDOM_SEED: 3, KEY.EPOCH: 5, KEY.LOSS: 'huber',
                KEY.LOSS_PARAM: {'delta': 0.01}, KEY.FORCE_WEIGHT: 25.0,
                KEY.STRESS_WEIGHT: 0.01, KEY.OPTIMIZER: 'adam',
                KEY.OPTIM_PARAM: {'lr': 0.004}, KEY.PER_EPOCH: 1,
                KEY.IS_TRAIN_STRESS: True,
                KEY.CONTINUE: {KEY.CHECKPOINT: checkpoint}})
    return cfg


def _first_losses(monkeypatch):
    losses = []
    orig = Trainer.train_step

    def step(self, b):
        stats = orig(self, b)
        losses.append(float(stats['TotalLoss'][0]))
        return stats

    monkeypatch.setattr(Trainer, 'train_step', step)
    return losses


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_continue_equals_jax(writer, tmp_path, monkeypatch):
    ckpt = _checkpoint(tmp_path, writer)
    cfg_p = _train_config(tmp_path, ckpt)
    cfg_j = copy.deepcopy(cfg_p)
    model, state = processing_continue_v2(cfg_p)
    jmodel, jstate = jcontinue(cfg_j)
    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR,
              KEY.CHEMICAL_SPECIES, KEY.NUM_SPECIES, KEY.TYPE_MAP,
              KEY.CHEMICAL_SPECIES_BY_ATOMIC_NUMBER):
        assert cfg_p[k] == cfg_j[k], k
    assert cfg_p[KEY.SHIFT] == -3.25
    assert cfg_p[KEY.SCALE] == float(np.float32(1.7))
    assert cfg_p[KEY.CONV_DENOMINATOR] == [11.5, 11.5]
    assert state['start_epoch'] == jstate['start_epoch'] == 5
    for k in ('reset_optimizer', 'reset_scheduler'):
        assert state[k] == jstate[k]
    mine, theirs = _leaves(state['params']), _leaves(jstate['params'])
    assert set(mine) == set(theirs)
    for k in theirs:
        assert np.array_equal(mine[k], theirs[k]), k
    for k, v in model.state().items():
        assert np.array_equal(v.numpy(), theirs[k]), k

    # the JAX trainer's loss on these parameters and the first batch
    sets = datasets_from_config(copy.deepcopy(cfg_p), str(tmp_path / 'd'))
    batch = next(iter(loader_from_config(cfg_p, sets['trainset'],
                                         is_train=True)))
    _, jmask = jmodel.init(jax.random.PRNGKey(3))
    jtr = JTrainer(jmodel, jstate['params'], jmask, cfg_j)
    want = float(jax.jit(lambda p, b: jtr._loss_fn(p, b)[0])(
        jstate['params'], {k: jnp.asarray(v) for k, v in batch.items()}))

    losses = _first_losses(monkeypatch)
    work = tmp_path / 'run'
    work.mkdir()
    train_v2(_train_config(tmp_path, ckpt), str(work), device='cpu')
    assert abs(losses[0] - want) <= 1e-5 * abs(want)
    start = load_native_checkpoint(str(work / 'checkpoint_0.pth.sevennet'))
    assert start['epoch'] == 4
    for k, v in flatten(start['params']).items():
        assert np.array_equal(v, theirs[k]), k
    rows = (work / 'lc.csv').read_text().splitlines()
    assert len(rows) == 2 and rows[1].startswith('5,')
    last = load_native_checkpoint(str(work / 'checkpoint_last.pth.sevennet'))
    assert last['epoch'] == 5


@pytest.mark.parametrize('arch', [{'channel': 8}, {'lmax': 2},
                                  {'num_convolution_layer': 3}])
def test_architecture_mismatch_raises(arch, tmp_path):
    ckpt = _checkpoint(tmp_path, 'port')
    cfg = _train_config(tmp_path, ckpt, **arch)
    key = next(iter(arch))
    with pytest.raises(ValueError, match=key):
        processing_continue_v2(copy.deepcopy(cfg))
    with pytest.raises(ValueError, match=key):
        jcontinue(copy.deepcopy(cfg))


def test_continue_from_pth(tmp_path, monkeypatch):
    from test_torch_pth_checkpoint import _state_dict, _write_pth
    cfg = tiny_model_config(dict(ARCH))
    jp, _ = jbuild(cfg).init(jax.random.PRNGKey(2))
    jp = _np(jp)
    sd, _ = _state_dict(jbuild(cfg), jp, old=False)
    path = str(tmp_path / 'ref.pth')
    _write_pth(path, dict(cfg, version='0.11.2'), sd, epoch=7)
    cfg_p = _train_config(tmp_path, path)
    cfg_j = copy.deepcopy(cfg_p)
    _, state = processing_continue_v2(cfg_p)
    _, jstate = jcontinue(cfg_j)
    assert state['start_epoch'] == jstate['start_epoch'] == 1
    assert cfg_p[KEY.SHIFT] == cfg_j[KEY.SHIFT]
    mine = _leaves(state['params'])
    for k, v in _leaves(jp).items():
        assert np.array_equal(mine[k], v), k
    losses = _first_losses(monkeypatch)
    work = tmp_path / 'run'
    work.mkdir()
    cfg = _train_config(tmp_path, path)
    cfg[KEY.EPOCH] = 1
    train_v2(cfg, str(work), device='cpu')
    assert len(losses) == 2 and np.isfinite(losses).all()
