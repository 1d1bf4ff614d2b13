"""Loss definitions (reference sevenn/train/loss.py, mask-based).

Counterpart of ``sevennet_exp_tpu/train/loss.py``. Per-atom energy
(eV/atom), force (eV/A), stress (kbar, x1602.1766208). NaN labels and
padded rows are excluded through masks (a masked mean in place of the
reference's boolean indexing, so a batch keeps its padded shapes).
Optional per-structure data weights (reference loss.py:49-76).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch

from .. import _keys as KEY
from .._const import KBAR_COEFF

Tensor = torch.Tensor


def mse(pred, ref):
    return (pred - ref) ** 2


def make_huber(delta: float = 1.0):
    def huber(pred, ref):
        err = torch.abs(pred - ref)
        quad = 0.5 * err ** 2
        lin = delta * (err - 0.5 * delta)
        return torch.where(err < delta, quad, lin)
    return huber


CRITERIA = {'mse': lambda **kw: mse,
            'huber': lambda **kw: make_huber(kw.get('delta', 1.0))}


def _masked_mean(values, mask):
    s = torch.sum(values * mask)
    c = torch.sum(mask)
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), s * 0.0)


def _not_nan(ref, dtype):
    return (~torch.isnan(ref)).to(dtype)


@dataclass(frozen=True)
class LossSpec:
    name: str       # 'Energy' | 'Force' | 'Stress'
    unit: str
    weight: float
    use_weight: bool = False

    def compute(self, criterion: Callable, data: Dict[str, Tensor]) -> Tensor:
        if self.name == 'Energy':
            pred = data[KEY.PRED_TOTAL_ENERGY]
            n = torch.clamp(data[KEY.NUM_ATOMS].to(pred.dtype), min=1.0)
            pred = pred / n
            ref = data[KEY.ENERGY] / n
            mask = data[KEY.GRAPH_MASK] * _not_nan(ref, pred.dtype)
            if self.use_weight:
                mask = mask * data.get('data_weight_energy', 1.0)
            return _masked_mean(criterion(pred, torch.nan_to_num(ref)), mask)
        if self.name == 'Force':
            pred = data[KEY.PRED_FORCE].reshape(-1)
            ref = data[KEY.FORCE].reshape(-1)
            m = torch.repeat_interleave(data[KEY.NODE_MASK], 3)
            m = m * _not_nan(ref, pred.dtype)
            if self.use_weight:
                w = data.get('data_weight_force')
                if w is not None:
                    m = m * torch.repeat_interleave(
                        w[data[KEY.BATCH].long()], 3)
            return _masked_mean(criterion(pred, torch.nan_to_num(ref)), m)
        if self.name == 'Stress':
            pred = (data[KEY.PRED_STRESS] * KBAR_COEFF).reshape(-1)
            ref = (data[KEY.STRESS] * KBAR_COEFF).reshape(-1)
            m = torch.repeat_interleave(data[KEY.GRAPH_MASK], 6)
            m = m * _not_nan(ref, pred.dtype)
            if self.use_weight:
                w = data.get('data_weight_stress')
                if w is not None:
                    m = m * torch.repeat_interleave(w, 6)
            return _masked_mean(criterion(pred, torch.nan_to_num(ref)), m)
        raise ValueError(self.name)


def loss_functions_from_config(config) -> Tuple[Callable, List[LossSpec]]:
    """Mirrors reference loss.py:199-223."""
    name = config.get(KEY.LOSS, 'mse').lower()
    criterion = CRITERIA[name](**config.get(KEY.LOSS_PARAM, {}))
    use_weight = config.get(KEY.USE_WEIGHT, False)
    specs = [
        LossSpec('Energy', 'eV/atom', 1.0, use_weight),
        LossSpec('Force', 'eV/A', float(config.get(KEY.FORCE_WEIGHT, 0.1)),
                 use_weight),
    ]
    if config.get(KEY.IS_TRAIN_STRESS, True):
        specs.append(
            LossSpec('Stress', 'kbar',
                     float(config.get(KEY.STRESS_WEIGHT, 1e-6)), use_weight))
    return criterion, specs


def total_loss(criterion, specs: List[LossSpec], data) -> Tuple[Tensor, Dict]:
    parts = {}
    tot = 0.0
    for spec in specs:
        val = spec.compute(criterion, data)
        parts[spec.name] = val
        tot = tot + spec.weight * val
    return tot, parts
