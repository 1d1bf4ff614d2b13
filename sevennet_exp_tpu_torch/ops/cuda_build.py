"""Build and binding of the port's hand-written CUDA kernels: nvcc -> one
shared library per source under ``_build/`` (named by the source's hash)
-> ctypes. Nothing here touches the GPU; a module that owns kernels keeps
its own ``argtypes`` next to its wrappers.

The launch counters of every kernel of the port live here too: a wrapper
adds one where it launches its kernel and nowhere else (``chip_smoke.py``
resets and reads them around each path).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC')

# the sources, by the name their library carries
SOURCES = {
    'fused_conv': 'fused_conv.cu',
    'fused_conv_terms': 'fused_conv_terms.cu',
    'fused_tp': 'fused_tp.cu',
}

launch_counts: Dict[str, int] = {
    'fused_conv_fwd': 0, 'fused_conv_bwd': 0,
    'fused_conv_geom_fwd': 0, 'fused_conv_geom_bwd': 0,
    'fused_conv_extw_fwd': 0, 'fused_conv_extw_bwd': 0,
    'fused_conv_edge_fwd': 0, 'fused_conv_edge_bwd': 0,
    'fused_conv_terms_fwd': 0, 'fused_conv_terms_bwd': 0,
    'fused_tp_fwd': 0, 'fused_tp_bwd': 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def nvcc_path() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None and os.path.exists('/usr/local/cuda/bin/nvcc'):
        nvcc = '/usr/local/cuda/bin/nvcc'
    if nvcc is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                           'csrc/*.cu at first use')
    return nvcc


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, SOURCES[name])


def library_path(name: str) -> str:
    with open(source_path(name), 'rb') as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')


def _start(name: str):
    """Start nvcc on one source; returns (final path, temporary path,
    process), or (path, None, None) when the library is already there."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *NVCC_FLAGS, '-Xptxas', '-v', '-o', tmp,
           source_path(name)]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def build_all(names: Iterable[str] = tuple(SOURCES),
              verbose: bool = False) -> List[str]:
    """Compile the named sources for sm_90a, one nvcc each, all started
    together (once per source hash); returns the libraries' paths. verbose
    prints ptxas' register and shared-memory report of each."""
    jobs = [(name, *_start(name)) for name in names]
    outs = []
    for name, out, tmp, proc in jobs:
        if proc is not None:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed on {SOURCES[name]} '
                                   f'({proc.returncode}):\n{stdout}\n{stderr}')
            os.replace(tmp, out)
            if verbose:
                print(stderr.strip())
        outs.append(out)
    return outs


def build(name: str, verbose: bool = False) -> str:
    return build_all((name,), verbose)[0]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of one source, built at first use."""
    return ctypes.CDLL(build(name))


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err}')
