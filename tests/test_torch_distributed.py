"""The port's data-parallel training (``parallel/distributed.py``, the
loader's ``shard``, the trainer's averaged step, ``sevenn -d``) on the CPU:

  - ``detect_launch_env`` for torchrun, OpenMPI and SLURM, and none for a
    single process;
  - two processes on gloo (``torch.multiprocessing``, spawned; each joined
    with its own timeout) take one data-parallel step on two batches; the
    summed statistics and the parameters after the step equal the JAX
    ``Trainer._train_step_dp`` on a 2-device mesh over the same batches
    (statistics to 1e-5 relative; under SGD each leaf's step, the averaged
    gradient times lr, to 1e-4 of the leaf's largest step, the gradient
    tolerance of tests/test_torch_train.py);
  - the shards of a shuffled epoch partition it; a data-parallel epoch
    takes whole rounds only (the trailing batches are dropped, so no
    process waits for ever in ``all_reduce``);
  - ``sevenn -d`` sets ``IS_DDP``.

Only the JAX oracle imports JAX, inside the test that needs it: the
spawned workers import this module and stay free of it.
"""

import copy
import os
import socket

import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.data.loader import GraphLoader
from sevennet_exp_tpu_torch.parallel import distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
LAUNCH_VARS = ('WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'OMPI_COMM_WORLD_SIZE',
               'OMPI_COMM_WORLD_RANK', 'OMPI_COMM_WORLD_LOCAL_RANK',
               'SLURM_NTASKS', 'SLURM_PROCID', 'SLURM_LOCALID')


@pytest.fixture
def clean_env(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize('env,want', [
    ({}, None),
    ({'WORLD_SIZE': '1', 'RANK': '0'}, None),
    ({'WORLD_SIZE': '4', 'RANK': '2', 'LOCAL_RANK': '0'},
     ('torchrun', 4, 2, 0)),
    ({'OMPI_COMM_WORLD_SIZE': '8', 'OMPI_COMM_WORLD_RANK': '5',
      'OMPI_COMM_WORLD_LOCAL_RANK': '1'}, ('ompi', 8, 5, 1)),
    ({'SLURM_NTASKS': '2', 'SLURM_PROCID': '1', 'SLURM_LOCALID': '1'},
     ('slurm', 2, 1, 1)),
    ({'SLURM_NTASKS': 'x'}, None),
], ids=['none', 'torchrun1', 'torchrun', 'ompi', 'slurm', 'garbled'])
def test_detect_launch_env(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    got = dist.detect_launch_env()
    assert (None if got is None else tuple(got)) == want
    if want is None:
        # a single process: nothing to initialise
        assert dist.maybe_initialize(device='cpu') is False
        assert dist.world() == (0, 1)


def _config():
    return tiny_model_config({
        'num_convolution_layer': 2, KEY.LOSS: 'mse',
        KEY.FORCE_WEIGHT: 1.0, KEY.STRESS_WEIGHT: 0.01,
        KEY.IS_TRAIN_STRESS: True, KEY.OPTIMIZER: 'sgd',
        KEY.OPTIM_PARAM: {'lr': 0.1}})


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _dp_worker(rank, world, port, config, params, mask, batches, queue):
    """One data-parallel process: join the gloo group, take one step on
    its batch, send back its statistics and parameters."""
    torch.set_num_threads(1)
    from sevennet_exp_tpu_torch.model.build import (
        build_e3_equivariant_model)
    from sevennet_exp_tpu_torch.train.trainer import Trainer
    torch.distributed.init_process_group(
        'gloo', init_method=f'tcp://127.0.0.1:{port}', world_size=world,
        rank=rank)
    try:
        cfg = dict(config, **{KEY.IS_DDP: True})
        tr = Trainer(build_e3_equivariant_model(copy.deepcopy(cfg)), params,
                     mask, cfg, device='cpu')
        assert tr.dp == (rank, world)
        stats = tr.train_step(tr.batch_to_device(batches[rank]))
        queue.put((rank, {k: tuple(float(x) for x in v)
                          for k, v in stats.items()},
                   {k: p.detach().numpy().copy()
                    for k, p in tr.params.items()}))
    finally:
        torch.distributed.destroy_process_group()


def _jax_batches(config):
    from sevennet_exp_tpu.data import extxyz as jx
    from sevennet_exp_tpu.data.graph import atoms_to_graph, collate_graphs
    graphs = [atoms_to_graph(a, config[KEY.CUTOFF])
              for a in jx.read_extxyz(VALID)[:4]]
    n_edge = 128 * ((max(sum(g[KEY.EDGE_IDX].shape[1] for g in pair)
                         for pair in (graphs[:2], graphs[2:])) + 127) // 128)
    return [collate_graphs(graphs[i:i + 2], n_node=160, n_edge=n_edge,
                           n_graph=3) for i in (0, 2)]


def test_two_process_dp_step_equals_jax():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from sevennet_exp_tpu.model.build import build_e3_equivariant_model
    from sevennet_exp_tpu.train.trainer import Trainer as JTrainer
    from sevennet_exp_tpu_torch.model.model import flatten

    config = _config()
    batches = _jax_batches(config)
    jmodel = build_e3_equivariant_model(copy.deepcopy(config))
    params, mask = jmodel.init(jax.random.PRNGKey(3))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    mesh = Mesh(np.array(jax.devices()[:2]), ('dp',))
    jtr = JTrainer(jmodel, params, mask, config, mesh=mesh)
    stacked = {k: jnp.asarray(np.stack([b[k] for b in batches]))
               for k in batches[0]}
    new_params, _, jstats = jtr._train_step_dp(jtr.params, jtr.opt_state,
                                               stacked)
    want = flatten(jax.tree_util.tree_map(np.asarray, new_params))
    before = flatten(np_params)

    ctx = torch.multiprocessing.get_context('spawn')
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_dp_worker,
                         args=(r, 2, port, config, np_params, mask, batches,
                               queue)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, stats, state = queue.get(timeout=120)
            got[rank] = (stats, state)
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    for rank in (0, 1):
        stats, state = got[rank]
        for name, (s, c) in stats.items():
            js, jc = (float(np.asarray(v)) for v in jstats[name])
            assert abs(s - js) <= 1e-5 * abs(js), (name, s, js)
            assert c == jc, name
        assert set(state) == set(want)
        moved = 0
        for k, w in want.items():
            step = w - before[k]
            lim = 1e-4 * max(float(np.abs(step).max()), 1e-30)
            assert np.abs((state[k] - before[k]) - step).max() <= lim, \
                (rank, k)
            moved += bool(np.abs(step).max() > 0)
        assert moved > len(want) // 2
    # both processes took the same optimizer step
    for k in want:
        assert np.array_equal(got[0][1][k], got[1][1][k]), k


def _graphs(n):
    return [{KEY.NUM_ATOMS: np.array(2), KEY.EDGE_IDX: np.zeros((2, 1), int),
             'tag': np.array(i)} for i in range(n)]


@pytest.fixture
def tags_only(monkeypatch):
    """The loader yields each batch's graph tags instead of collating."""
    from sevennet_exp_tpu_torch.data import loader as loader_mod
    monkeypatch.setattr(loader_mod, 'collate_graphs',
                        lambda batch, **kw: sorted(int(g['tag'])
                                                   for g in batch))


@pytest.mark.parametrize('n,world', [(24, 2), (24, 3), (20, 3)])
def test_shards_partition_the_epoch(tags_only, n, world):
    graphs = _graphs(n)
    full = list(GraphLoader(graphs, 4, shuffle=True, seed=7))
    parts = [list(GraphLoader(graphs, 4, shuffle=True, seed=7,
                              shard=(r, world))) for r in range(world)]
    assert sorted(sum(parts, [])) == sorted(full)
    assert sorted(sum(full, [])) == list(range(n))
    for r, p in enumerate(parts):
        assert p == full[r::world]
        assert len(GraphLoader(graphs, 4, shard=(r, world))) == len(p)


@pytest.mark.parametrize('n_batches,world,steps', [(6, 2, 3), (7, 2, 3),
                                                   (7, 3, 2), (2, 3, 0)])
def test_dp_epoch_takes_whole_rounds(tags_only, n_batches, world, steps):
    """Every rank takes n_batches // world steps: the trailing round that
    some ranks cannot fill is dropped by all."""
    from sevennet_exp_tpu_torch.train.trainer import Trainer
    graphs = _graphs(n_batches * 2)
    taken = []
    for rank in range(world):
        tr = Trainer.__new__(Trainer)
        tr.dp, tr.rank = (rank, world), rank
        seen = []
        tr.batch_to_device = lambda b: b
        tr.train_step = lambda b: seen.append(b) or {}
        tr.run_one_epoch(GraphLoader(graphs, 2, shard=(rank, world)),
                         is_train=True)
        assert len(seen) == steps, (rank, seen)
        taken += seen
    # the rounds taken are the epoch's first batches, each once
    assert sorted(sum(taken, [])) == list(range(2 * steps * world))


def test_sevenn_d_parses(monkeypatch, tmp_path):
    from sevennet_exp_tpu_torch.main import cli
    from sevennet_exp_tpu_torch.scripts import train as train_mod
    seen = {}

    def fake(config, working_dir, device=None):
        seen.update(config=config, wd=working_dir, device=device)

    monkeypatch.setattr(train_mod, 'train_v2', fake)
    yaml = os.path.join(ROOT, 'trained_nacl', 'input.yaml')
    cli.main_sevenn([yaml, '-d', '-w', str(tmp_path), '--device', 'cpu'])
    assert seen['config'][KEY.IS_DDP] is True
    seen.clear()
    cli.main_sevenn([yaml, '-w', str(tmp_path), '--device', 'cpu'])
    assert not seen['config'].get(KEY.IS_DDP)
