"""Activation normalization constants (e3nn ``normalize2mom``), in torch.

Counterpart of ``sevennet_exp_tpu/ops/normalize.py``: every activation f
is rescaled so E[f(z)^2] = 1 for z ~ N(0, 1). The constants are the same
hard-coded e3nn seed-0 estimates; they are part of the checkpoint's
numerical contract.

Frozen copy of ``sevennet_exp_tpu_torch/ops/normalize.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

NORMALIZE2MOM_CST = {
    'silu': 1.6791767923989418,
    'tanh': 1.5937334472592695,
    'relu': 1.4163393446331365,
    'abs': 1.001110600838467,
    'sigmoid': 1.8467055342154763,
    'elu': 1.2467863885570512,
    'ssp': 1.878204668541552,
}

_LN2 = math.log(2.0)


def _ssp(x):
    # ShiftedSoftPlus, reference sevenn/nn/activation.py:6-8
    return F.softplus(x) - _LN2


RAW_ACTIVATION = {
    'silu': F.silu,
    'tanh': torch.tanh,
    'relu': F.relu,
    'abs': torch.abs,
    'sigmoid': torch.sigmoid,
    'elu': F.elu,
    'ssp': _ssp,
}


def normalized_activation(name: str) -> Callable:
    """f(x) * cst with cst = E[f(z)^2]^(-1/2) (e3nn normalize2mom)."""
    f = RAW_ACTIVATION[name]
    cst = NORMALIZE2MOM_CST[name]
    return lambda x: f(x) * cst
