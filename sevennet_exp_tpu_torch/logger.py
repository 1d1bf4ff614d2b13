"""File + screen logger with timers (reference sevenn/sevenn_logger.py).

Counterpart of ``sevennet_exp_tpu/logger.py`` for the calls the port's
``train_v2`` and ``processing_epoch_v2`` make (one process: rank 0).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

_LOGO = r"""
   _____             _  _        _   _          _____ _____  _    _
  / ____|           (_)| \      | \ | |        |_   _|  __ \| |  | |
 | (___   _____   __ _ |  \     |  \| | ___  ___ | | | |__) | |  | |
  \___ \ / _ \ \ / /| | . \     | . ` |/ _ \/ _ \| | |  ___/| |  | |
  ____) |  __/\ V / | | |\  \   | |\  |  __/ (_) | |_| |    | |__| |
 |_____/ \___| \_/  |_|_| \__\  |_| \_|\___|\___/____|_|     \____/
     E(3)-equivariant interatomic potentials: PyTorch / CUDA port
"""


class Singleton(type):
    _instances: Dict = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


class Logger(metaclass=Singleton):
    def __init__(self, filename: Optional[str] = None,
                 screen: bool = False, rank: int = 0):
        self.rank = rank
        self.screen = screen
        self.file = None
        if filename and rank == 0:
            self.file = open(filename, 'w', buffering=1)
        self._timers: Dict[str, float] = {}

    def init_file(self, filename: str):
        """Log to ``filename`` from now on (a later run in the same
        process gets its own file)."""
        if self.rank == 0:
            if self.file is not None:
                self.file.close()
            self.file = open(filename, 'w', buffering=1)

    def writeline(self, line: str = ''):
        self.write(line + '\n')

    def write(self, content: str):
        if self.rank != 0:
            return
        if self.file:
            self.file.write(content)
        if self.screen:
            sys.stdout.write(content)

    def greeting(self):
        self.writeline(_LOGO)

    def bar(self):
        self.writeline('-' * 72)

    def format_k_v(self, key, val, write=False):
        line = f'{key:<32}: {val}'
        if write:
            self.writeline(line)
        return line

    def dict_write(self, d: Dict, header: str = ''):
        if header:
            self.writeline(header)
        for k, v in d.items():
            if isinstance(v, dict):
                self.writeline(f'{k}:')
                for kk, vv in v.items():
                    self.format_k_v(f'  {kk}', vv, write=True)
            else:
                self.format_k_v(k, v, write=True)

    def statistic_write(self, stats: Dict):
        for name, st in stats.items():
            if name.startswith('_'):
                continue
            if isinstance(st, dict) and 'mean' in st:
                self.writeline(
                    f'{name:>16}: mean {st["mean"]:.6f}  std {st["std"]:.6f}'
                    f'  median {st["median"]:.6f}  count {st["count"]}'
                )

    def epoch_write(self, epoch: int, lr: float,
                    train_vals: Dict[str, float],
                    valid_vals: Optional[Dict[str, float]] = None):
        self.bar()
        self.writeline(f'Epoch {epoch}  (lr: {lr:.6g})')
        keys = list(train_vals)
        header = f'{"":<12}' + ''.join(f'{k:>18}' for k in keys)
        self.writeline(header)
        self.writeline(
            f'{"Train":<12}'
            + ''.join(f'{train_vals[k]:>18.6f}' for k in keys)
        )
        if valid_vals:
            self.writeline(
                f'{"Valid":<12}'
                + ''.join(f'{valid_vals.get(k, float("nan")):>18.6f}'
                          for k in keys)
            )

    # -- timers --------------------------------------------------------
    def timer_start(self, name: str):
        self._timers[name] = time.time()

    def timer_end(self, name: str, message: str = ''):
        dt = time.time() - self._timers.pop(name, time.time())
        self.writeline(f'{message or name}: elapsed {dt:.2f} s')
        return dt

    # -- model info ----------------------------------------------------
    def print_model_info(self, model, params=None, mask=None):
        """Per-layer irreps + trainable parameter count (reference
        sevenn_logger.py:320-338) and the route of every convolution."""
        from .model import layers as L
        from .model.model import flatten

        self.writeline('Irreps of features')
        for name, layer in model.layers.items():
            irreps = getattr(layer, 'irreps_out', None)
            if irreps is None and isinstance(layer, L.IrrepsConvolution):
                irreps = layer.tp.irreps_in1
            if irreps is not None:
                self.format_k_v(name, str(irreps), write=True)
        if params is not None:
            m = flatten(mask) if mask is not None else {}
            n = sum(int(v.numel()) for k, v in flatten(params).items()
                    if m.get(k, True))
            self.writeline(f'# learnable parameters: {n}')
        self.writeline()
