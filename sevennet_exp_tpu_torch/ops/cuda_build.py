"""Build and binding of the port's hand-written CUDA kernels: nvcc -> one
shared library per source under ``_build/`` (named by the hash of the
source and of every ``csrc/*.cuh`` header) -> ctypes. Nothing here touches
the GPU; a module that owns kernels keeps its own ``argtypes`` next to its
wrappers.

The launch counters of every kernel of the port live here too: a wrapper
adds one where it launches its kernel and nowhere else (``chip_smoke.py``
resets and reads them around each path).
"""

from __future__ import annotations

import ctypes
import functools
import glob
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
    'fused_conv_geom': 'fused_conv_geom.cu',
    'fused_conv_geom_ssp': 'fused_conv_geom.cu',
    'fused_conv_geom_extw': 'fused_conv_geom.cu',
    'fused_conv_terms': 'fused_conv_terms.cu',
    'fused_tp': 'fused_tp.cu',
    'bench_pieces': 'fused_conv_geom.cu',
    'bench_cgmxu': 'bench_cgmxu.cu',
    'bench_dot': 'bench_dot.cu',
    'bench_cg': 'bench_cg.cu',
    'bench_layout': 'bench_layout.cu',
    'bench_tile': 'bench_tile.cu',
}

# the macros of a library built from a shared source: the shifted-softplus
# instances of the conv kernels are a library of their own, so that a
# model without that activation never compiles them; the external-weight
# pair is one too, compiled without the file's other kernels, and so are
# the micro-benchmark bench_pieces' forwards with pieces stubbed
DEFINES = {'fused_conv_geom_ssp': ('-DFUSED_CONV_SSP=1',),
           'fused_conv_geom_extw': ('-DFUSED_CONV_EXTW=1',),
           'bench_pieces': ('-DFUSED_CONV_PIECES=1',)}

# the micro-benchmark kernels, by variant (tools/bench_*.py)
BENCH_KERNELS = (
    'bench_pieces_full', 'bench_pieces_nomlp', 'bench_pieces_nocg',
    'bench_pieces_now', 'bench_pieces_noagg', 'bench_pieces_nosi2',
    'bench_cgmxu_st', 'bench_cgmxu_outer', 'bench_cgmxu_dots',
    'bench_dot_fp32', 'bench_dot_bf16',
    'bench_cg_a', 'bench_cg_b', 'bench_cg_c',
    'bench_layout_rowmajor', 'bench_layout_colmajor',
    'bench_layout_transpose',
    'bench_tile_d', 'bench_tile_a', 'bench_tile_b', 'bench_tile_c')

launch_counts: Dict[str, int] = {
    'fused_conv_fwd': 0, 'fused_conv_bwd': 0,
    'fused_conv_geom_fwd': 0, 'fused_conv_geom_bwd': 0,
    'fused_conv_extw_fwd': 0, 'fused_conv_extw_bwd': 0,
    'fused_conv_edge_fwd': 0, 'fused_conv_edge_bwd': 0,
    'fused_conv_terms_fwd': 0, 'fused_conv_terms_bwd': 0,
    'fused_tp_fwd': 0, 'fused_tp_bwd': 0, 'fused_tp_bwd_table': 0,
    **dict.fromkeys(BENCH_KERNELS, 0)}


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
    """The library's path, named by the hash of its source and of every
    ``csrc/*.cuh``, so that an edit of either builds it anew."""
    digest = hashlib.sha1()
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, '*.cuh')))
    for path in [source_path(name), *headers]:
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f'lib{name}_{digest.hexdigest()[:12]}.so')


def _start(name: str):
    """Start nvcc on one source; returns (final path, temporary path,
    process), or (path, None, None) when the library is already there."""
    out = library_path(name)
    if os.path.exists(out):
        return out, None, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = [nvcc_path(), *NVCC_FLAGS, *DEFINES.get(name, ()), '-Xptxas',
           '-v', '-o', tmp, source_path(name)]
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
