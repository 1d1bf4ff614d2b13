"""Native checkpoint writer and loader (no JAX, no optax).

Counterpart of the native-format part of ``sevennet_exp_tpu/checkpoint.py``.
``save_checkpoint`` writes the JAX package's format from the port's
trainer: ``params`` in the JAX tree layout and an ``optimizer_state`` of
numpy arrays and builtins only, so that the JAX ``load_checkpoint`` reads
a checkpoint the port trained.
A native checkpoint is a pickle of ``{config, params, optimizer_state,
epoch, version, hash}`` whose ``params`` are plain numpy arrays. Its
``optimizer_state`` holds optax named tuples, and a plain ``pickle.load``
imports optax -- which imports JAX. ``load_native_checkpoint`` therefore
unpickles with a restricted ``find_class``:

  - every ``optax.*`` global becomes an inert stub and the optimizer
    state is thrown away;
  - ``numpy._core.*`` maps to ``numpy.core.*`` where the installed numpy
    predates the rename;
  - any other module outside numpy, the builtins and the standard
    containers raises, so a corrupt or foreign pickle is not swallowed.
"""

from __future__ import annotations

import importlib
import os
import pickle
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import _keys as KEY
from .model.build import build_e3_equivariant_model
from .model.model import SevenNetModel


class _Stub:
    """Inert stand-in for an optax class inside the optimizer state."""

    def __init__(self, *args, **kwargs):
        pass


_ALLOWED_MODULES = ('numpy', 'builtins', 'collections', 'copyreg',
                    '_codecs')


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split('.')[0]
        if root == 'optax':
            return type(name, (_Stub,), {'__module__': 'stub.' + module})
        if root not in _ALLOWED_MODULES:
            raise pickle.UnpicklingError(
                f'checkpoint names {module}.{name}: not a numpy/builtin '
                'global, refusing to import it')
        if module.startswith('numpy._core'):
            try:
                importlib.import_module(module)
            except ImportError:
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def save_checkpoint(path: str, config: Dict, params,
                    optimizer_state=None, epoch: Optional[int] = None):
    """{config, params, optimizer_state, epoch, version, hash} as a
    pickle (JAX ``save_checkpoint``); ``params`` and ``optimizer_state``
    must hold numpy arrays and builtins (``Trainer.get_checkpoint_pieces``).
    """
    payload = {
        'config': config,
        'params': params,
        'optimizer_state': optimizer_state,
        'epoch': epoch,
        'version': '0.1.0+tpu',
        'hash': uuid.uuid4().hex,
    }
    with open(path, 'wb') as f:
        pickle.dump(payload, f)


def load_native_checkpoint(path: str) -> Dict[str, Any]:
    """{config, params, epoch, version, hash}; optimizer state dropped."""
    with open(path, 'rb') as fh:
        payload = _CheckpointUnpickler(fh).load()
    if not isinstance(payload, dict) or 'params' not in payload:
        raise ValueError(f'{path}: not a native SevenNet checkpoint')
    payload['optimizer_state'] = None
    return payload


def params_from_numpy(params: Dict[str, Any], device='cpu'
                      ) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts of numpy arrays) -> the port's
    flat state {'layer/sub/key': float32 tensor}, for
    ``SevenNetModel.load_state``."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f'{prefix}{k}'
            if isinstance(v, dict):
                walk(v, key + '/')
            else:
                out[key] = torch.as_tensor(
                    np.array(v, dtype=np.float32), device=device)

    walk(params, '')
    return out


# stored configs may still carry dataset-statistic keywords; the stored
# parameters hold the resolved arrays, so the build only needs numeric
# placeholders (as sevennet_exp_tpu.checkpoint.SevenNetCheckpoint)
_PLACEHOLDERS = {KEY.SHIFT: 0.0, KEY.SCALE: 1.0, KEY.CONV_DENOMINATOR: 1.0}


class SevenNetCheckpoint:
    """Handle on a native checkpoint; builds the port's model."""

    def __init__(self, checkpoint_path: str):
        self.checkpoint_path = os.path.abspath(checkpoint_path)
        payload = load_native_checkpoint(self.checkpoint_path)
        self.config: Dict[str, Any] = dict(payload['config'])
        self.params = payload['params']
        self.epoch = payload.get('epoch')

    def build_model(self, device='cuda') -> Tuple[SevenNetModel,
                                                   Dict[str, torch.Tensor]]:
        """(model on ``device`` with the stored weights, flat state)."""
        cfg = dict(self.config)
        for k, v in _PLACEHOLDERS.items():
            if isinstance(cfg.get(k), str):
                cfg[k] = v
        model = build_e3_equivariant_model(cfg).to(device)
        state = params_from_numpy(self.params, device=device)
        model.load_state(state)
        return model, state
