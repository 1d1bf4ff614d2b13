"""A whole run on the CPU (the harness without its look for a chip, on a
cut of the cell's mix) comes out correct, and comes out not correct when
the timed path is broken underneath (``portbench/harness/faults.py``):
for MD a step that returns its state unchanged, forces altered where
they are produced in every step, and in the first step after each
Verlet-list build only (which the window's last step does not show);
for training an optimizer step that leaves the parameters unchanged,
half of each batch left out (the means over the rest), and the loss
altered where it is produced. The MD runs take the mixes kept for the
MD cells that wait (PERF.md)."""

import pytest
from conftest import MD_LIMITS, md_cell, small_mix, tiny_mix

import run
from portbench.harness import faults

MD_MIXES = ['nvt-8k', 'nvt-97k']
TRAIN = 'sevennet-0.nacl.train-b16'


def _md(mix):
    cell = md_cell(mix)
    result, lines = run.execute(cell['workload']['name'], 424242424242, 1.0,
                                False, 'cpu', 0.0, mix=tiny_mix(mix),
                                limits=MD_LIMITS, cell=cell)
    assert list(result)[-1] == 'checks'
    return result


def _train():
    with small_mix('train-b16') as mix:
        result, lines = run.execute(TRAIN, 515151515151, 0.1, False, 'cpu',
                                    0.0, mix=mix)
    assert list(result)[-1] == 'checks' and len(lines) >= 3
    return result


@pytest.mark.parametrize('mix', MD_MIXES)
def test_sound_md_run_is_correct(mix):
    result = _md(mix)
    assert result['correct'] is True, result['checks']
    # builds fell inside the window, so steps other than the last are held
    assert result['counters']['steps_checked'] >= 2, result['counters']


@pytest.mark.parametrize('fault', ['md_state_unchanged', 'md_forces_altered',
                                   'md_forces_altered_after_builds'])
@pytest.mark.parametrize('mix', MD_MIXES[:1])
def test_broken_md_step_is_not_correct(mix, fault):
    with faults.FAULTS[fault]():
        result = _md(mix)
    assert result['correct'] is False, result['checks']


def test_sound_training_run_is_correct():
    result = _train()
    assert result['correct'] is True, result['checks']


@pytest.mark.parametrize('fault', ['train_state_unchanged',
                                   'train_half_batch', 'train_loss_altered'])
def test_broken_training_step_is_not_correct(fault):
    with faults.FAULTS[fault]():
        assert _train()['correct'] is False
