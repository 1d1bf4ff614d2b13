"""The plain reference against the program's plain path on the CPU at 64
atoms: model energy and forces, one NVT step; the choice of the steps an
MD run holds to the reference; and the reference's imports (nothing of
the program, the JAX package or JAX). The training step is held to the
reference in ``test_portbench_faults.py``."""

import ast
import glob
import os

import numpy as np
import pytest
import torch
from conftest import ROOT, md_cell, tiny_mix

from portbench.harness import md, traffic
from portbench.reference.model import ReferenceModel, energy_forces
from portbench.reference.neighbors import edge_list

FORBIDDEN = {'sevennet_exp_tpu_torch', 'sevennet_exp_tpu', 'jax', 'jaxlib',
             'flax'}


@pytest.fixture(scope='module')
def setup():
    torch.manual_seed(0)
    cell = md_cell('nvt-8k')
    mix = tiny_mix('nvt-8k')
    inputs = traffic.md_inputs(mix, 987654321987)
    ck = md.checkpoint_config(cell['config'], ROOT)
    return cell, mix, inputs, ck


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, 'portbench', 'reference',
                                       '*.py')):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ''] if not node.level else []
            else:
                continue
            for n in names:
                assert n.split('.')[0] not in FORBIDDEN, (path, n)


def test_model_energy_forces(setup):
    cell, mix, inputs, ck = setup
    cfg = cell['config']
    eng, tap = md.program_setup(cfg, mix, inputs, 1, torch.device('cpu'),
                                ck['path'])
    s = eng.state
    ref = ReferenceModel(cfg['model'], ck['params'], ck['config']['_type_map'],
                         'cpu')
    cell_t = torch.as_tensor(inputs['cell'], dtype=torch.float32)
    e, f = energy_forces(lambda p: ref.energy(
        p, inputs['z'], edge_list(p, cell_t, ref.cutoff)), s.pos)
    n = len(inputs['z'])
    assert abs(float(e) - float(s.energy)) / n < 1e-6
    assert float(torch.max(torch.abs(f - s.forces))) < 1e-5
    assert float(torch.max(torch.abs(f))) > 0.05


def test_one_nvt_step(setup):
    cell, mix, inputs, ck = setup
    dev = torch.device('cpu')
    eng, tap = md.program_setup(cell['config'], mix, inputs, 2, dev,
                                ck['path'])
    eng.run(1)
    got = md._state(tap.last)
    ref = md.reference_step(ck, cell['config'], mix, inputs,
                            md._state(tap.prev), dev)
    nums = md.compare(got, ref)
    assert float(torch.max(torch.abs(got['pos'] - ref['pos']))) < 1e-5
    assert abs(float(got['energy'] - ref['energy'])) / len(inputs['z']) < 1e-6
    assert nums['force_err'] < 1e-5
    assert nums['velocity_err'] < 1e-5


@pytest.mark.parametrize('builds', [0, 2, 3, 10])
def test_checked_steps_span_the_window(builds):
    tap = md.StepTap.__new__(md.StepTap)
    tap.kept = [({'i': i}, {'i': i}) for i in range(builds)]

    class State:
        def __init__(self, i):
            for k in ('pos', 'vel', 'forces', 'energy', 'xi'):
                setattr(self, k, torch.full((1,), float(i)))

    tap.prev, tap.last = State(-2), State(-1)
    steps = md.checked_steps(tap, 99)
    picked = [s[1]['i'] for s in steps[:-1]]
    assert steps[-1][0] == 'last step'
    assert float(steps[-1][2]['pos']) == -1.0
    assert len(picked) == min(3, builds)
    parts = np.array_split(np.arange(builds), min(3, builds)) if builds else []
    assert all(i in part for i, part in zip(picked, parts))
