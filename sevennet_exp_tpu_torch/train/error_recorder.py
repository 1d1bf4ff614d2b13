"""Streaming error metrics (reference sevenn/error_recorder.py).

Counterpart of ``sevennet_exp_tpu/train/error_recorder.py``. Metrics
accumulate (sum, count) pairs; batch statistics are computed on the
device, mask-based, from the padded batch.

RMSE convention matches the reference (error_recorder.py:155-176): the
squared error is summed over the vector dimension (3 for force, 6 for
stress) and averaged over vectors, then sqrt.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from .. import _keys as KEY
from .._const import GPA_COEFF, KBAR_COEFF

_ERROR_TYPES = {
    'TotalEnergy': dict(name='Energy', unit='eV', vdim=1, per_atom=False,
                        coeff=1.0),
    'Energy': dict(name='Energy', unit='eV/atom', vdim=1, per_atom=True,
                   coeff=1.0),
    'Force': dict(name='Force', unit='eV/A', vdim=3, per_atom=False,
                  coeff=1.0),
    'Stress': dict(name='Stress', unit='kbar', vdim=6, per_atom=False,
                   coeff=KBAR_COEFF),
    'Stress_GPa': dict(name='Stress', unit='GPa', vdim=6, per_atom=False,
                       coeff=GPA_COEFF),
    'TotalLoss': dict(name='TotalLoss', unit=None, vdim=1, per_atom=False,
                      coeff=1.0),
}


@dataclass
class MetricSpec:
    err_type: str        # key of _ERROR_TYPES (ignored for combined)
    metric: str          # 'RMSE' | 'MAE' | 'ComponentRMSE' | 'Loss' | 'None'
    name: str            # display name, e.g. Energy_RMSE
    # weighted sum of OTHER metrics by display name (the reference's
    # CombinedError, error_recorder.py:261-288); such a metric carries
    # no batch statistics of its own
    combine: Optional[Tuple[Tuple[str, float], ...]] = None

    @property
    def unit(self) -> Optional[str]:
        if self.combine is not None:
            return None
        return _ERROR_TYPES[self.err_type]['unit']

    def key_str(self) -> str:
        u = self.unit
        return f'{self.name} ({u})' if u else self.name


def _residuals(err_type: str, data):
    """(residual_flat, mask_flat, vdim) for an error type."""
    t = _ERROR_TYPES[err_type]
    if t['name'] == 'Energy':
        pred = data[KEY.PRED_TOTAL_ENERGY]
        ref = data[KEY.ENERGY]
        if t['per_atom']:
            n = torch.clamp(data[KEY.NUM_ATOMS].to(pred.dtype), min=1.0)
            pred, ref = pred / n, ref / n
        mask = data[KEY.GRAPH_MASK] * (~torch.isnan(ref)).to(pred.dtype)
        return (pred - torch.nan_to_num(ref))[:, None], mask, 1
    if t['name'] == 'Force':
        pred = data[KEY.PRED_FORCE]
        ref = data[KEY.FORCE]
        mask = data[KEY.NODE_MASK] * (~torch.isnan(ref[:, 0])).to(pred.dtype)
        return (pred - torch.nan_to_num(ref)), mask, 3
    if t['name'] == 'Stress':
        pred = data[KEY.PRED_STRESS] * t['coeff']
        ref = data[KEY.STRESS] * t['coeff']
        mask = data[KEY.GRAPH_MASK] * (~torch.isnan(ref[:, 0])).to(pred.dtype)
        return (pred - torch.nan_to_num(ref)), mask, 6
    raise ValueError(err_type)


@torch.no_grad()
def batch_metric_stats(
    metrics: List[MetricSpec], data, total_loss_val=None
) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Per-batch (sum, count) per metric, on the batch's device."""
    out = {}
    for m in metrics:
        if m.combine is not None:
            continue  # combined metrics are derived at read time
        if m.err_type == 'TotalLoss':
            val = (torch.as_tensor(float('nan')) if total_loss_val is None
                   else total_loss_val.detach())
            out[m.name] = (val.float(), torch.ones_like(val.float()))
            continue
        res, mask, vdim = _residuals(m.err_type, data)
        res = res.detach()
        if m.metric == 'RMSE':
            se = torch.sum(res * res, dim=-1)  # per-vector
            out[m.name] = (torch.sum(se * mask), torch.sum(mask))
        elif m.metric == 'ComponentRMSE':
            se = res * res
            out[m.name] = (torch.sum(se * mask[:, None]),
                           torch.sum(mask) * vdim)
        elif m.metric == 'MAE':
            ae = torch.abs(res)
            out[m.name] = (torch.sum(ae * mask[:, None]),
                           torch.sum(mask) * vdim)
        elif m.metric in ('Loss', 'None'):
            se = torch.sum(res * res, dim=-1)
            out[m.name] = (torch.sum(se * mask), torch.sum(mask))
        else:
            raise ValueError(m.metric)
    return out


class ErrorRecorder:
    """Host-side accumulator over batches (one per train/valid set)."""

    def __init__(self, metrics: List[MetricSpec]):
        self.metrics = metrics
        self.reset()

    def reset(self):
        self._sum = {m.name: 0.0 for m in self.metrics}
        self._count = {m.name: 0.0 for m in self.metrics}
        self.history: List[Dict[str, float]] = []

    def update(self, stats: Dict[str, Tuple]):
        for name, (s, c) in stats.items():
            if name in self._sum:
                self._sum[name] += float(s)
                self._count[name] += float(c)

    def get(self, name: str) -> float:
        m = next(mm for mm in self.metrics if mm.name == name)
        if m.combine is not None:
            return sum(w * self.get(member) for member, w in m.combine)
        c = self._count[name]
        if c == 0:
            return float('nan')
        mean = self._sum[name] / c
        if m.metric in ('RMSE', 'ComponentRMSE'):
            return math.sqrt(mean)
        return mean

    def get_current(self) -> Dict[str, float]:
        return {m.name: self.get(m.name) for m in self.metrics}

    def epoch_forward(self) -> Dict[str, float]:
        vals = self.get_current()
        self.history.append(vals)
        self.reset()
        return vals

    @staticmethod
    def from_config(config) -> 'ErrorRecorder':
        """Reference error_recorder.py:387-430: error_record YAML list."""
        entries = config.get(KEY.ERROR_RECORD) or [
            ['Energy', 'RMSE'], ['Force', 'RMSE'], ['Stress', 'RMSE'],
            ['TotalLoss', 'None'],
        ]
        is_stress = config.get(KEY.IS_TRAIN_STRESS, True)
        metrics = []
        for err_type, metric in entries:
            if err_type.startswith('Stress') and not is_stress:
                continue
            if err_type == 'TotalLoss':
                metrics.append(MetricSpec('TotalLoss', 'Loss', 'TotalLoss'))
            elif metric == 'Loss':
                metrics.append(
                    MetricSpec(err_type, 'Loss', f'{err_type}_Loss')
                )
            else:
                metrics.append(
                    MetricSpec(err_type, metric, f'{err_type}_{metric}')
                )
        return ErrorRecorder(metrics)
