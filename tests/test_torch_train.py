"""The port's training path on the CPU against the JAX package:

  - the loss and its parts to 1e-5 relative and every gradient leaf to
    1e-4 of the leaf's largest entry, against ``jax.value_and_grad`` of
    the JAX ``Trainer._loss_fn`` (its XLA path) on the same parameters and
    padded batch: huber and mse, with and without stress, with and without
    NaN labels;
  - the same loss and gradients from a batch padded to larger capacities;
  - ``optim_dict[name]`` against the optax transform of the JAX registry
    on the same given gradients, 5 steps, to 1e-6;
  - ``Scheduler``: equal lr sequences for every name;
  - ``init``: the JAX tree, shapes and trainable mask at 7net-0 width; the
    random leaves from N(0, 1) like JAX's (each leaf of 1,000 entries or
    more: sample std within 10 % of JAX's; the smaller ones pooled), the
    constant leaves equal;
  - end to end: the port's ``train_v2`` for 2 epochs on 8 frames writes
    ``lc.csv`` with the JAX trainer's columns, and its
    ``checkpoint_best.pth.sevennet`` loads in the JAX package, whose E/F
    match the port's to 1e-4 eV and 1e-4 eV/A.
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
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.checkpoint import load_checkpoint as jload
from sevennet_exp_tpu.data import extxyz as jx
from sevennet_exp_tpu.data.graph import atoms_to_graph, collate_graphs
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.scripts.train import train_v2 as jtrain_v2
from sevennet_exp_tpu.train import optim as joptim
from sevennet_exp_tpu.train.trainer import Trainer as JTrainer
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    load_native_checkpoint,
)
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.model import flatten
from sevennet_exp_tpu_torch.parse_input import read_config_yaml
from sevennet_exp_tpu_torch.scripts.train import train_v2
from sevennet_exp_tpu_torch.train import optim as poptim
from sevennet_exp_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
NACL = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')


def _config(loss='huber', stress=True):
    cfg = tiny_model_config({
        'num_convolution_layer': 2, KEY.LOSS: loss,
        KEY.LOSS_PARAM: {'delta': 0.01} if loss == 'huber' else {},
        KEY.FORCE_WEIGHT: 25.0, KEY.STRESS_WEIGHT: 0.01,
        KEY.IS_TRAIN_STRESS: stress})
    return cfg


@pytest.fixture(scope='module')
def graphs():
    return [atoms_to_graph(a, 4.0) for a in jx.read_extxyz(VALID)[:3]]


def _batch(graphs, nan=False, n_node=200, n_edge=None):
    n_edge = n_edge or 128 * ((sum(g[KEY.EDGE_IDX].shape[1]
                                   for g in graphs) + 127) // 128)
    b = collate_graphs(graphs, n_node=n_node, n_edge=n_edge, n_graph=4)
    if nan:
        b[KEY.ENERGY][1] = np.nan
        b[KEY.FORCE][5:9] = np.nan
        b[KEY.FORCE][70, 1] = np.nan
        b[KEY.STRESS][0, 2] = np.nan
        b[KEY.STRESS][2] = np.nan
    return b


def _pair(cfg, seed=0):
    """(JAX trainer, JAX params, port trainer on the CPU with the same
    parameters and trainable mask)."""
    jmodel = jbuild(cfg)
    params, mask = jmodel.init(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    trainer = Trainer(build_e3_equivariant_model(copy.deepcopy(cfg)),
                      np_params, mask, cfg, device='cpu')
    return JTrainer(jmodel, params, mask, cfg), params, trainer


def _jax_loss_and_grads(jtr, params, batch):
    f = jax.value_and_grad(jtr._loss_fn, has_aux=True)
    (loss, _), grads = f(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    return float(loss), flatten(jax.tree_util.tree_map(np.asarray, grads))


def _assert_grads_close(mine, theirs, trainable):
    for k, want in theirs.items():
        got = mine[k].numpy()
        if not trainable[k]:
            assert not got.any(), k
            continue
        lim = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= lim, k


@pytest.mark.parametrize('loss,stress,nan', [
    ('huber', True, True), ('huber', False, False),
    ('mse', True, False), ('mse', False, True)])
def test_loss_and_gradients_equal_jax(graphs, loss, stress, nan):
    cfg = _config(loss, stress)
    jtr, params, trainer = _pair(cfg)
    batch = _batch(graphs, nan)
    want_loss, want_grads = _jax_loss_and_grads(jtr, params, batch)
    got_loss, got_grads = trainer.loss_and_grads(
        trainer.batch_to_device(batch))
    assert abs(float(got_loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert set(got_grads) == set(want_grads)
    _assert_grads_close(got_grads, want_grads, trainer.trainable)
    # the parts of the loss, each against JAX's on the same outputs
    from sevennet_exp_tpu.train.loss import total_loss as jtotal
    with jax.default_device(jax.devices('cpu')[0]):
        from sevennet_exp_tpu.ops import pallas_tp
        with pallas_tp.disabled():
            jout = jtr.model.apply(params, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
        _, jparts = jtotal(jtr.criterion, jtr.loss_specs, jout)
    pb = trainer.batch_to_device(batch)
    _, parts, _ = trainer._loss_fn(pb, create_graph=False)
    assert set(parts) == set(jparts)
    for k in parts:
        assert abs(float(parts[k]) - float(jparts[k])) <= 1e-5 * max(
            abs(float(jparts[k])), 1e-12), k


def test_padding_changes_neither_loss_nor_gradients(graphs):
    """Pad atoms (zero one-hot rows, NODE_MASK 0) and pad edges (EDGE_MASK
    0) add nothing: a batch padded to larger capacities gives the same
    loss and gradients."""
    cfg = _config('huber', True)
    _, _, trainer = _pair(cfg)
    small = trainer.batch_to_device(_batch(graphs, True))
    big = trainer.batch_to_device(_batch(graphs, True, n_node=320,
                                         n_edge=4096))
    l_s, g_s = trainer.loss_and_grads(small)
    l_b, g_b = trainer.loss_and_grads(big)
    assert abs(float(l_s) - float(l_b)) <= 1e-6 * abs(float(l_s))
    for k in g_s:
        lim = 1e-5 * max(float(g_s[k].abs().max()), 1e-30)
        assert float((g_s[k] - g_b[k]).abs().max()) <= lim, k


def test_train_step_updates_only_trainable_leaves(graphs):
    """One step: the trainable leaves move, the frozen ones (denominators,
    shift and scale) do not (adam: a zero gradient moves nothing)."""
    cfg = _config('huber', True)
    cfg[KEY.OPTIM_PARAM] = {'lr': 0.01}
    _, _, trainer = _pair(cfg)
    before = {k: p.detach().clone() for k, p in trainer.params.items()}
    stats = trainer.train_step(trainer.batch_to_device(_batch(graphs)))
    assert set(stats) == {m.name for m in trainer.metrics}
    for k, p in trainer.params.items():
        moved = bool((p.detach() != before[k]).any())
        assert moved == trainer.trainable[k], k


_OPTIMS = [('adam', {}), ('adam', {'betas': (0.8, 0.99), 'eps': 1e-6}),
           ('adamw', {'weight_decay': 0.05}), ('sgd', {}),
           ('sgd', {'momentum': 0.9, 'nesterov': True}), ('adagrad', {}),
           ('radam', {})]


@pytest.mark.parametrize('name,kw', _OPTIMS)
def test_optimizers_equal_optax(name, kw):
    """The same five given gradients through optim_dict[name] and through
    the JAX registry's optax transform: parameters to 1e-6. A frozen leaf
    (zero gradient) moves under adamw's weight decay in both."""
    rng = np.random.default_rng(11)
    shapes = {'a': (7, 5), 'b': (13,), 'frozen': (4,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in
          shapes.items()}
    grads = [{k: (rng.normal(size=s) * (0 if k == 'frozen' else 1))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lr = 0.01
    tx = joptim.optim_dict[name](lr, **copy.deepcopy(kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = poptim.optim_dict[name](list(tp.values()), lr, **kw)
    for g in grads:
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        opt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert (name == 'adamw') == bool((tp['frozen'].numpy() != p0['frozen'])
                                     .any())


def test_radam_rectified_steps_equal_optax():
    """b2 = 0.8: from the 7th step on the rectified update runs."""
    rng = np.random.default_rng(12)
    p0 = rng.normal(size=(9,)).astype(np.float32)
    grads = [rng.normal(size=(9,)).astype(np.float32) for _ in range(12)]
    tx = joptim.optim_dict['radam'](0.01, betas=(0.9, 0.8))
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    t = torch.tensor(p0)
    opt = poptim.optim_dict['radam']([t], 0.01, betas=(0.9, 0.8))
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = jp + upd
        t.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(t.numpy(), np.asarray(jp), rtol=0, atol=1e-6)


_SCHEDULERS = [
    ('constant', {}), ('exponentiallr', {'gamma': 0.9}),
    ('steplr', {'step_size': 3, 'gamma': 0.5}),
    ('multisteplr', {'milestones': [2, 5, 9], 'gamma': 0.3}),
    ('cosineannealinglr', {'T_max': 7, 'eta_min': 1e-4}),
    ('linearlr', {'start_factor': 1.0, 'end_factor': 0.05,
                  'total_iters': 12}),
    ('reducelronplateau', {'patience': 1, 'factor': 0.5}),
]


@pytest.mark.parametrize('name,kw', _SCHEDULERS)
def test_scheduler_lr_sequences_equal_jax(name, kw):
    assert {n for n, _ in _SCHEDULERS} == set(poptim.scheduler_names)
    a = poptim.Scheduler(name, 0.004, **kw)
    b = joptim.Scheduler(name, 0.004, **kw)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.4,
               0.45, 0.46, 0.47, 0.48, 0.49]
    assert [a.step(m) for m in metrics] == [b.step(m) for m in metrics]
    assert a.state_dict() == b.state_dict()


def test_scheduler_sets_the_optimizer_lr(graphs):
    cfg = _config()
    cfg.update({KEY.OPTIM_PARAM: {'lr': 0.004}, KEY.SCHEDULER: 'linearlr',
                KEY.SCHEDULER_PARAM: {'start_factor': 1.0,
                                      'end_factor': 0.05,
                                      'total_iters': 4}})
    _, _, trainer = _pair(cfg)
    trainer.scheduler_step()
    assert trainer.get_lr() == pytest.approx(0.004 * (1 - 0.95 / 4))
    assert all(g['lr'] == trainer.get_lr()
               for g in trainer.optimizer.param_groups)


def test_init_tree_mask_and_distributions_equal_jax():
    """7net-0 width (trained_nacl's config)."""
    cfg = dict(SevenNetCheckpoint(NACL).config)
    cfg[KEY.SHIFT], cfg[KEY.SCALE] = [-3.0, -2.0], [1.5, 1.2]
    cfg[KEY.CONV_DENOMINATOR] = 24.0
    cfg[KEY.TRAIN_SHIFT_SCALE] = True
    jp, jm = jbuild(cfg).init(jax.random.PRNGKey(7))
    pp, pm = build_e3_equivariant_model(cfg).init(
        torch.Generator().manual_seed(7))
    jp, jm, pp, pm = (flatten(t) for t in (jp, jm, pp, pm))
    assert set(pp) == set(jp) and pm == {k: bool(v) for k, v in jm.items()}
    small_p, small_j = [], []
    for k, want in jp.items():
        got, want = pp[k].numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, k
        if float(want.std()) == 0.0 or want.size == 1:
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif want.size >= 1000:
            assert abs(got.std() / want.std() - 1) <= 0.10, k
            assert abs(got.mean()) <= 5 / np.sqrt(want.size), k
        else:
            small_p.append(got.ravel())
            small_j.append(want.ravel())
    a, b = np.concatenate(small_p), np.concatenate(small_j)
    assert abs(a.std() / b.std() - 1) <= 0.10


_YAML = """\
model:
  chemical_species: auto
  cutoff: 4.0
  channel: 4
  lmax: 1
  num_convolution_layer: 2
  weight_nn_hidden_neurons: [64, 64]
  self_connection_type: linear
  conv_denominator: avg_num_neigh
train:
  random_seed: 3
  epoch: 2
  loss: huber
  loss_param: {{delta: 0.01}}
  optimizer: adam
  optim_param: {{lr: 0.004}}
  scheduler: linearlr
  scheduler_param: {{start_factor: 1.0, end_factor: 0.05, total_iters: 2}}
  force_loss_weight: 25.0
  stress_loss_weight: 0.01
  per_epoch: 1
  device: cpu
data:
  shift: elemwise_reference_energies
  scale: force_rms
  batch_size: 3
  load_trainset_path: ['{path}']
  load_validset_path: ['{path}']
"""


def test_train_v2_end_to_end_checkpoint_loads_in_jax(tmp_path):
    frames = jx.read_extxyz(VALID)[:8]
    data = str(tmp_path / 'eight.extxyz')
    jx.write_extxyz(data, frames)
    yaml_path = tmp_path / 'input.yaml'
    yaml_path.write_text(_YAML.format(path=data))
    out = tmp_path / 'port'
    out.mkdir()
    trainer = train_v2(read_config_yaml(str(yaml_path)), str(out))
    names = sorted(os.listdir(out))
    for f in ('checkpoint_0.pth.sevennet', 'checkpoint_1.pth.sevennet',
              'checkpoint_2.pth.sevennet', 'checkpoint_best.pth.sevennet',
              'checkpoint_last.pth.sevennet', 'lc.csv', 'log.sevenn'):
        assert f in names, f
    # the JAX trainer's lc.csv columns, from a JAX run of one epoch
    jcfg = read_config_yaml(str(yaml_path))
    jcfg[KEY.EPOCH] = 1
    jout = tmp_path / 'jax'
    jout.mkdir()
    jtrain_v2(jcfg, str(jout))
    rows = (out / 'lc.csv').read_text().splitlines()
    assert rows[0] == (jout / 'lc.csv').read_text().splitlines()[0]
    assert len(rows) == 3 and rows[1].startswith('1,') \
        and rows[2].startswith('2,')
    # the best checkpoint: numpy only, read by the JAX package
    path = str(out / 'checkpoint_best.pth.sevennet')
    payload = load_native_checkpoint(path)
    assert payload['epoch'] in (1, 2)
    jmodel, jparams = jload(path).build_model()
    at = frames[0]
    res_j = JCalc(model=jmodel, params=jparams,
                  use_pallas=False).calculate(at)
    pat = Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)
    res_p = SevenNetCalculator(path, device='cpu').calculate(pat)
    assert abs(res_p['energy'] - res_j['energy']) <= 1e-4
    assert np.abs(res_p['forces'] - res_j['forces']).max() <= 1e-4
    # the last checkpoint holds the trainer's parameters
    last = load_native_checkpoint(str(out / 'checkpoint_last.pth.sevennet'))
    for k, v in flatten(last['params']).items():
        np.testing.assert_array_equal(
            v, trainer.params[k].detach().numpy(), err_msg=k)
