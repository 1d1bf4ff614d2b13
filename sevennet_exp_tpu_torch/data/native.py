"""ctypes binding of the native (C++) neighbor list, ``csrc/neighbor.cpp``.

Counterpart of ``sevennet_exp_tpu/data/native.py``. The source is compiled
with ``g++ -O3 -shared -fPIC`` at first use into the package's ``_build/``
under a name that carries the source's hash (as ``ops/cuda_build.py`` names
the CUDA libraries), so an edited source builds anew. The route is decided
without a hidden fallback:

  - ``SEVENN_NO_NATIVE`` set (non-empty): the cKDTree path;
  - no library built yet and no ``g++`` on PATH: the cKDTree path, with one
    warning;
  - otherwise the native list; a failed compile raises with the compiler's
    stderr, a library that does not load raises its ``OSError``.

``data/neighborlist.py::neighbor_list`` calls it first and records the
route it took in ``neighborlist.ROUTE``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG_DIR, 'csrc', 'neighbor.cpp')
BUILD_DIR = os.path.join(_PKG_DIR, '_build')
CXX_FLAGS = ('-O3', '-shared', '-fPIC')

_LIB = None
_WARNED = False


def library_path() -> str:
    with open(SRC_PATH, 'rb') as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f'libsevenn_neighbor_{digest}.so')


def build_library() -> str:
    """Compile the source into ``_build/`` (once per source hash); returns
    the library's path. Raises RuntimeError with g++'s stderr on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    res = subprocess.run(['g++', *CXX_FLAGS, SRC_PATH, '-o', tmp],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f'g++ failed on {SRC_PATH} ({res.returncode}):\n'
                           f'{res.stderr}')
    os.replace(tmp, out)
    return out


def get_library() -> Optional[ctypes.CDLL]:
    """The bound library, or None where the route is the cKDTree path."""
    global _LIB, _WARNED
    if os.environ.get('SEVENN_NO_NATIVE'):
        return None
    if _LIB is not None:
        return _LIB
    path = library_path()
    if not os.path.exists(path):
        if shutil.which('g++') is None:
            if not _WARNED:
                warnings.warn('no g++ on PATH: the neighbor list runs on the '
                              'cKDTree path (csrc/neighbor.cpp is not built)')
                _WARNED = True
            return None
        path = build_library()
    lib = ctypes.CDLL(path)
    fn = lib.sevenn_neighbor_list
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_neighbor_list(
    pos: np.ndarray, cell: np.ndarray, pbc, cutoff: float,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(edge_i, edge_j, edge_vec, shift) from the C++ cell list, or None
    where ``get_library`` selects the cKDTree path."""
    lib = get_library()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    cell = np.ascontiguousarray(cell, dtype=np.float64)
    pbc_arr = np.ascontiguousarray(
        np.asarray(pbc, dtype=bool).astype(np.uint8))
    n = len(pos)
    # the JAX package's generous first guess; on overflow the call returns
    # the exact count and one retry at that size fits
    vol = abs(np.linalg.det(cell))
    density = n / vol if vol > 1e-12 else 0.05
    cap = int(max(1024, n * (density * 4.2 * cutoff ** 3 * 1.5 + 20)))
    for _ in range(3):
        out_i = np.empty(cap, dtype=np.int32)
        out_j = np.empty(cap, dtype=np.int32)
        out_vec = np.empty((cap, 3), dtype=np.float64)
        out_shift = np.empty((cap, 3), dtype=np.int32)
        res = lib.sevenn_neighbor_list(
            _ptr(pos, ctypes.c_double), ctypes.c_int64(n),
            _ptr(cell, ctypes.c_double), _ptr(pbc_arr, ctypes.c_uint8),
            ctypes.c_double(cutoff), ctypes.c_int64(cap),
            _ptr(out_i, ctypes.c_int32), _ptr(out_j, ctypes.c_int32),
            _ptr(out_vec, ctypes.c_double), _ptr(out_shift, ctypes.c_int32),
        )
        if res >= 0:
            e = int(res)
            return (out_i[:e].astype(np.int64), out_j[:e].astype(np.int64),
                    out_vec[:e], out_shift[:e].astype(np.int64))
        cap = int(-res) + 16
    raise RuntimeError(f'native neighbor list: {n} atoms overflowed the '
                       f'edge capacity {cap} three times')
