"""Reads a native SevenNet checkpoint (a pickle of numpy trees) without the
program: a restricted unpickler that admits numpy and builtins only and
turns the optimizer's optax classes into inert stubs."""

from __future__ import annotations

import hashlib
import importlib
import pickle
from typing import Any, Dict

_ALLOWED = ('numpy', 'builtins', 'collections', 'copyreg', '_codecs')


class _Stub:
    def __init__(self, *args, **kwargs):
        pass


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split('.')[0]
        if root == 'optax':
            return type(name, (_Stub,), {'__module__': 'stub.' + module})
        if root not in _ALLOWED:
            raise pickle.UnpicklingError(f'checkpoint names {module}.{name}')
        if module.startswith('numpy._core'):
            try:
                importlib.import_module(module)
            except ImportError:
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def sha256(path: str) -> str:
    with open(path, 'rb') as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def load(path: str) -> Dict[str, Any]:
    """{'config': dict, 'params': nested dict of numpy arrays}."""
    with open(path, 'rb') as fh:
        payload = _Unpickler(fh).load()
    return {'config': payload['config'], 'params': payload['params']}
