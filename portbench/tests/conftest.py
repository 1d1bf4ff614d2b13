"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker, the card fixture, the cuts of
the mixes that the CPU runs use, and the entry of an MD cell whose mix is
kept for a later cell. Nothing here imports JAX."""

import contextlib
import copy
import os
import sys
from unittest import mock

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, 'portbench')):
    if p not in sys.path:
        sys.path.insert(0, p)
# the CPU runs are small: a few threads a test process is the fastest
torch.set_num_threads(min(4, torch.get_num_threads()))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs an NVIDIA GPU (skips without one)')


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the conv kernels have no CPU mode')
    return torch.device('cuda')


# the MD cells' limits for the CPU runs: what the 7,776-atom cell was held
# to on the card (PERF.md)
MD_LIMITS = {'force_err': 1.7e-4, 'velocity_err': 2.1e-5}
# the per-layer metrics an MD cell reports, and the end-to-end ones
MD_METRICS = [('device_idle_pct.md', '%'), ('mfu_pct.md', '%'),
              ('dense_pair_roofline', '%'), ('geom_pair_roofline', '%'),
              ('md.steps_per_chunk', 'steps')]
MD_E2E = [('ns_per_day', 'ns/day'), ('peak_mem_gib', 'GiB'),
          ('setup_s', 's')]


def tiny_mix(mix_name: str = 'nvt-8k'):
    """An MD mix cut to 64 atoms (2^3 conventional cells, the smallest box
    the engine's minimum image takes at 5 A), a cadence of 3, and 1200 K,
    so that a CPU window of a second holds Verlet-list builds."""
    from portbench.harness import traffic
    mix = copy.deepcopy(traffic.load(mix_name))
    mix['structure']['reps'] = 2
    mix['rebuild_every'] = 3
    mix['temperature_K'] = 1200.0
    return mix


def md_cell(mix_name: str):
    """The entry ``manifest.cell`` would give an MD cell of the
    ``sevennet-0.nacl`` configuration on ``mix_name``."""
    import json
    with open(os.path.join(ROOT, 'portbench', 'configs',
                           'sevennet-0.nacl.json')) as fh:
        cfg = json.load(fh)
    name = f'sevennet-0.nacl.{mix_name}'
    return {'workload': {'name': name, 'config': 'sevennet-0.nacl',
                         'traffic': mix_name, 'chips': 1},
            'config': cfg,
            'end_to_end': [{'name': n, 'unit': u} for n, u in MD_E2E],
            'per_layer': [{'name': n, 'unit': u} for n, u in MD_METRICS]}


@contextlib.contextmanager
def small_mix(mix_name: str):
    """A cell's mix cut for a CPU run: MD to 64 atoms (``tiny_mix``);
    training to batches of 2 from the first 8 structures of the seeded
    order, so that a window's whole pass is 4 steps."""
    from portbench.harness import traffic
    mix = copy.deepcopy(traffic.load(mix_name))
    if mix['kind'] != 'train':
        yield tiny_mix(mix_name)
        return
    mix['batch_size'] = 2
    every = traffic.train_inputs

    def eight(*args):
        structs, order = every(*args)
        return structs, order[:8]

    with mock.patch.object(traffic, 'train_inputs', eight):
        yield mix
