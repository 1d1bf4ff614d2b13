"""Optimizer & LR-scheduler registries (reference sevenn/train/optim.py).

Counterpart of ``sevennet_exp_tpu/train/optim.py``: the same registry
names on ``torch.optim``, each set up to take the steps of the optax
transform the JAX package builds for that name, and a copy of its
pure-python epoch -> lr scheduler (torch.optim.lr_scheduler semantics,
host side), which the trainer writes into the optimizer's
``param_groups``. The optax defaults where torch's differ:

  - adagrad: optax starts the accumulator at 0.1 and divides by
    sqrt(sum + 1e-7); ``torch.optim.Adagrad`` with eps = 0 divides by
    sqrt(sum), so it starts at 0.1 + 1e-7;
  - radam: optax puts eps inside the bias correction, torch outside
    (sqrt(1 - b2^t) eps against eps; 1e-8 either way).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch


def _adam(params, lr, **kw):
    betas = tuple(kw.get('betas', (0.9, 0.999)))
    return torch.optim.Adam(params, lr=lr, betas=betas,
                            eps=kw.get('eps', 1e-8))


def _adamw(params, lr, **kw):
    betas = tuple(kw.get('betas', (0.9, 0.999)))
    return torch.optim.AdamW(params, lr=lr, betas=betas,
                             weight_decay=kw.get('weight_decay', 0.01),
                             eps=kw.get('eps', 1e-8))


def _sgd(params, lr, **kw):
    momentum = kw.get('momentum', 0.0)
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           nesterov=bool(kw.get('nesterov', False))
                           and momentum > 0)


def _adagrad(params, lr, **kw):
    return torch.optim.Adagrad(params, lr=lr,
                               initial_accumulator_value=0.1 + 1e-7, eps=0.0)


def _radam(params, lr, **kw):
    betas = tuple(kw.get('betas', (0.9, 0.999)))
    return torch.optim.RAdam(params, lr=lr, betas=betas, eps=1e-8)


# name -> f(params, lr, **optim_param) -> torch.optim.Optimizer
optim_dict: Dict[str, Callable] = {
    'sgd': _sgd,
    'adagrad': _adagrad,
    'adam': _adam,
    'adamw': _adamw,
    'radam': _radam,
}


class Scheduler:
    """torch.optim.lr_scheduler-compatible epoch -> lr (host side)."""

    def __init__(self, name: str, base_lr: float, **kw):
        self.name = (name or 'constant').lower()
        self.base_lr = base_lr
        self.kw = kw
        self.epoch = 0
        self.lr = base_lr
        # ReduceLROnPlateau state
        self._best: Optional[float] = None
        self._bad = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        n, kw = self.name, self.kw
        if n == 'constant':
            pass
        elif n == 'exponentiallr':
            self.lr = self.base_lr * kw.get('gamma', 0.99) ** self.epoch
        elif n == 'steplr':
            step = kw.get('step_size', 30)
            self.lr = (self.base_lr
                       * kw.get('gamma', 0.1) ** (self.epoch // step))
        elif n == 'multisteplr':
            ms = sorted(kw.get('milestones', []))
            k = sum(1 for m in ms if m <= self.epoch)
            self.lr = self.base_lr * kw.get('gamma', 0.1) ** k
        elif n == 'cosineannealinglr':
            tmax = kw.get('T_max', 100)
            eta_min = kw.get('eta_min', 0.0)
            self.lr = eta_min + (self.base_lr - eta_min) * (
                1 + math.cos(math.pi * self.epoch / tmax)) / 2
        elif n == 'linearlr':
            s = kw.get('start_factor', 1.0 / 3)
            e = kw.get('end_factor', 1.0)
            total = kw.get('total_iters', 5)
            t = min(self.epoch, total)
            self.lr = self.base_lr * (s + (e - s) * t / total)
        elif n == 'reducelronplateau':
            assert metric is not None, 'plateau scheduler needs a metric'
            mode = kw.get('mode', 'min')
            thr = kw.get('threshold', 1e-4)
            better = (self._best is None
                      or (mode == 'min' and metric < self._best - thr)
                      or (mode == 'max' and metric > self._best + thr))
            if better:
                self._best = metric
                self._bad = 0
            else:
                self._bad += 1
                if self._bad > kw.get('patience', 10):
                    self.lr = max(self.lr * kw.get('factor', 0.1),
                                  kw.get('min_lr', 0.0))
                    self._bad = 0
        else:
            raise ValueError(f'unknown scheduler {n}')
        return self.lr

    def state_dict(self) -> Dict[str, Any]:
        return {'name': self.name, 'base_lr': self.base_lr, 'kw': self.kw,
                'epoch': self.epoch, 'lr': self.lr,
                'best': self._best, 'bad': self._bad}

    def load_state_dict(self, d: Dict[str, Any]):
        self.epoch = d['epoch']
        self.lr = d['lr']
        self._best = d.get('best')
        self._bad = d.get('bad', 0)


scheduler_names = [
    'steplr', 'multisteplr', 'exponentiallr', 'cosineannealinglr',
    'reducelronplateau', 'linearlr', 'constant',
]


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group['lr'] = lr
