"""Faults planted underneath the timed path, to show that the check fails
them: each is a context manager that patches the program for its span.
The tests run them on the CPU; ``calibrate.py --fault`` reads them on the
card at a cell's own size, where they set a training cell's upper
readings."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def md_state_unchanged():
    """The MD step returns the state it was given."""
    from sevennet_exp_tpu_torch.md import integrate
    with mock.patch.object(integrate, 'make_nose_hoover_step',
                           lambda *a, **k: (lambda state, nl: state)):
        yield


@contextlib.contextmanager
def md_forces_altered(delta: float = 0.01):
    """One force component of every step's result moved by ``delta``
    eV/A where the step produces it."""
    from sevennet_exp_tpu_torch.md import integrate
    make = integrate.make_nose_hoover_step

    def altered_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def altered(state, nl):
            out = step(state, nl)
            forces = out.forces.clone()
            forces[0, 0] += delta
            return out._replace(forces=forces)

        return altered

    with mock.patch.object(integrate, 'make_nose_hoover_step', altered_make):
        yield


@contextlib.contextmanager
def md_forces_altered_after_builds(delta: float = 0.01):
    """One force component moved by ``delta`` eV/A in the first step after
    every Verlet-list build only, as a wrong list would leave them: the
    window's last step is, as a rule, untouched."""
    from sevennet_exp_tpu_torch.md import engine, integrate
    make = integrate.make_nose_hoover_step
    build = engine.MolecularDynamics._build_nl
    fresh = [False]

    def flagged_build(self, *args, **kwargs):
        fresh[0] = True
        return build(self, *args, **kwargs)

    def altered_make(*args, **kwargs):
        step = make(*args, **kwargs)

        def altered(state, nl):
            out = step(state, nl)
            if not fresh[0]:
                return out
            fresh[0] = False
            forces = out.forces.clone()
            forces[0, 0] += delta
            return out._replace(forces=forces)

        return altered

    with mock.patch.object(engine.MolecularDynamics, '_build_nl',
                           flagged_build), \
            mock.patch.object(integrate, 'make_nose_hoover_step',
                              altered_make):
        yield


@contextlib.contextmanager
def train_state_unchanged():
    """The optimizer's step leaves the parameters as they were."""
    with mock.patch.object(torch.optim.Adam, 'step',
                           lambda self, closure=None: None):
        yield


@contextlib.contextmanager
def train_half_batch():
    """Half of each batch's structures masked out: the loss's means are
    taken over the rest."""
    from sevennet_exp_tpu_torch import _keys as KEY
    from sevennet_exp_tpu_torch.train import trainer as trainer_mod
    to_device = trainer_mod.Trainer.batch_to_device

    def half(self, batch):
        out = to_device(self, batch)
        n_g = int(out[KEY.NUM_ATOMS].shape[0]) - 1
        keep = (torch.arange(n_g + 1, device=out[KEY.BATCH].device)
                < n_g // 2)
        out[KEY.GRAPH_MASK] = out[KEY.GRAPH_MASK] * keep
        out[KEY.NODE_MASK] = out[KEY.NODE_MASK] * keep[out[KEY.BATCH]]
        return out

    with mock.patch.object(trainer_mod.Trainer, 'batch_to_device', half):
        yield


@contextlib.contextmanager
def train_loss_altered(factor: float = 1.001):
    """The loss scaled by ``factor`` where the trainer produces it."""
    from sevennet_exp_tpu_torch.train import trainer as trainer_mod
    total = trainer_mod.total_loss

    def altered(*args, **kwargs):
        tot, parts = total(*args, **kwargs)
        return tot * factor, parts

    with mock.patch.object(trainer_mod, 'total_loss', altered):
        yield


FAULTS = {
    'md_state_unchanged': md_state_unchanged,
    'md_forces_altered': md_forces_altered,
    'md_forces_altered_after_builds': md_forces_altered_after_builds,
    'train_state_unchanged': train_state_unchanged,
    'train_half_batch': train_half_batch,
    'train_loss_altered': train_loss_altered,
}
