"""Trainer: the loss, its gradients and the optimizer step on one device.

Counterpart of ``sevennet_exp_tpu/train/trainer.py`` (reference
sevenn/train/trainer.py:20-230) without its data-parallel mesh (ROADMAP
A.7). The parameters are the model's buffers, in the flat layout of
``SevenNetModel.state``; the trainable ones require a gradient. The loss
runs ``model.apply(create_graph=True)`` on the padded batch, every
convolution on the plain chain (``USE_KERNELS_KEY`` False: the forces in
the loss need gradients of gradients, which the fused conv does not
have), as the JAX trainer runs its XLA path. Frozen leaves get zero
gradients and stay in the optimizer, so ``adamw``'s weight decay moves
them as optax's does when JAX masks only the gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .. import _keys as KEY
from ..model.model import SevenNetModel, flatten
from ..ops.fused_conv import USE_KERNELS_KEY
from .error_recorder import ErrorRecorder, MetricSpec, batch_metric_stats
from .loss import loss_functions_from_config, total_loss
from .optim import Scheduler, optim_dict, set_lr

_INT_KEYS = (KEY.ATOMIC_NUMBERS, KEY.BATCH, KEY.EDGE_IDX, KEY.NUM_ATOMS)


class Trainer:
    """``params`` and ``trainable_mask``: the trees of
    ``SevenNetModel.init`` (None: the model's current buffers, all
    trainable); ``device``: where the model trains (default the config's
    ``device``, else 'cuda')."""

    def __init__(self, model: SevenNetModel, params=None,
                 trainable_mask=None, config: Optional[Dict] = None,
                 device=None):
        config = config or {}
        self.config = config
        self.device = torch.device(device or config.get('device', 'cuda'))
        self.model = model.to(self.device)
        if params is not None:
            self.model.load_state({k: torch.tensor(np.asarray(v))
                                   for k, v in flatten(params).items()})
        self.params: Dict[str, torch.Tensor] = self.model.state()
        mask = flatten(trainable_mask) if trainable_mask is not None else {}
        self.trainable = {k: bool(mask.get(k, True)) for k in self.params}
        for k, p in self.params.items():
            p.requires_grad_(self.trainable[k])
        self.criterion, self.loss_specs = loss_functions_from_config(config)

        lr = float(config.get(KEY.OPTIM_PARAM, {}).get('lr', 0.01))
        optim_name = config.get(KEY.OPTIMIZER, 'adam').lower()
        optim_args = {k: v for k, v in config.get(KEY.OPTIM_PARAM, {}).items()
                      if k != 'lr'}
        self.optimizer = optim_dict[optim_name](list(self.params.values()),
                                                lr, **optim_args)
        self.scheduler = Scheduler(config.get(KEY.SCHEDULER, 'constant'), lr,
                                   **config.get(KEY.SCHEDULER_PARAM, {}))
        self.metrics: List[MetricSpec] = ErrorRecorder.from_config(
            config).metrics

    @staticmethod
    def from_config(model, params, trainable_mask, config,
                    device=None) -> 'Trainer':
        return Trainer(model, params, trainable_mask, config, device)

    # -- batches -------------------------------------------------------
    def batch_to_device(self, batch: Dict[str, np.ndarray]) -> Dict:
        """A loader's numpy batch as tensors on the device, integer index
        arrays as int64, every convolution on the plain chain."""
        out = {k: torch.as_tensor(
                   v, dtype=torch.long if k in _INT_KEYS else None,
                   device=self.device)
               for k, v in batch.items()}
        out[USE_KERNELS_KEY] = False
        return out

    # -- steps ---------------------------------------------------------
    def _loss_fn(self, batch, create_graph: bool):
        out = self.model.apply(batch, create_graph=create_graph)
        tot, parts = total_loss(self.criterion, self.loss_specs, out)
        return tot, parts, out

    def loss_and_grads(self, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        """The loss of a device batch and its gradient with respect to
        every parameter (zeros for the frozen ones), flat keys."""
        keys = [k for k in self.params if self.trainable[k]]
        tot, _, _ = self._loss_fn(batch, create_graph=True)
        grads = torch.autograd.grad(tot, [self.params[k] for k in keys],
                                    allow_unused=True)
        got = {k: g for k, g in zip(keys, grads) if g is not None}
        return tot.detach(), {k: got.get(k, torch.zeros_like(p))
                              for k, p in self.params.items()}

    def train_step(self, batch) -> Dict[str, Tuple]:
        self.optimizer.zero_grad(set_to_none=True)
        tot, _, out = self._loss_fn(batch, create_graph=True)
        tot.backward()
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return batch_metric_stats(self.metrics, out, tot)

    def eval_step(self, batch) -> Dict[str, Tuple]:
        tot, _, out = self._loss_fn(batch, create_graph=False)
        return batch_metric_stats(self.metrics, out, tot)

    # -- epoch loop ----------------------------------------------------
    def run_one_epoch(self, loader: Iterable, is_train: bool = False,
                      error_recorder: Optional[ErrorRecorder] = None):
        """``loader`` yields padded numpy batches (``GraphLoader``)."""
        for batch in loader:
            batch = self.batch_to_device(batch)
            stats = (self.train_step(batch) if is_train
                     else self.eval_step(batch))
            if error_recorder is not None:
                error_recorder.update(stats)

    def scheduler_step(self, metric: Optional[float] = None):
        set_lr(self.optimizer, self.scheduler.step(metric))

    def get_lr(self) -> float:
        return self.scheduler.lr

    def get_checkpoint_pieces(self) -> Tuple[Any, Any]:
        """(params, aux): the parameters in the JAX tree layout and the
        optimizer and scheduler state, numpy and builtins only."""
        params = {}
        for key, p in self.params.items():
            node = params
            *path, leaf = key.split('/')
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = p.detach().cpu().numpy().copy()
        return params, {'opt_state': _to_numpy(self.optimizer.state_dict()),
                        'scheduler': self.scheduler.state_dict()}


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree
