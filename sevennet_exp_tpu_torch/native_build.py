"""Builds of the port's native serving pieces with g++, at first use, into
``_build/`` (each named by the hash of its sources and of the PyTorch
version, as ``ops/cuda_build.py`` names the CUDA libraries):

  - ``exec_library()``  ``libsevenn_exec_<hash>.so``, the C API of a
                        deployed artifact (``csrc/sevenn_exec.cpp``)
                        against the installed PyTorch;
  - ``exec_host()``     ``sevenn_exec_host_<hash>``, the same source built
                        with ``-DSEVENN_EXEC_MAIN``: the file-protocol host
                        (``inputs.manifest`` -> ``out_<i>.bin``);
  - ``harness()``       ``sevenn_lammps_harness_<hash>``, the LAMMPS pair
                        style ``lammps_pair/pair_sevennet_torch.cpp``
                        compiled unmodified against the mock LAMMPS headers
                        ``lammps_pair/mock/`` and driven by
                        ``lammps_pair/harness.cpp``, linked to the exec
                        library (the JAX package's
                        ``tools/build_lammps_harness.sh``).

``build_all()`` runs the g++ of the shim of the dispatcher ops and of both
torch builds together (each ~20-40 s on PyTorch's headers), then the
harness's.
"""

from __future__ import annotations

import glob
import os
from typing import Dict

from .ops import torch_ops

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
EXEC_SRC = os.path.join(_PKG_DIR, 'csrc', 'sevenn_exec.cpp')
PAIR_DIR = os.path.join(_PKG_DIR, 'lammps_pair')
PAIR_SRC = os.path.join(PAIR_DIR, 'pair_sevennet_torch.cpp')
HARNESS_SRC = os.path.join(PAIR_DIR, 'harness.cpp')
MOCK_DIR = os.path.join(PAIR_DIR, 'mock')
# the LAMMPS version the mock headers stand for
LAMMPS_FLAGS = ('-std=c++17', '-DLAMMPS_VERSION_NUMBER=20240829',
                f'-I{MOCK_DIR}', f'-I{PAIR_DIR}')


def _exec_job(main: bool):
    stem = 'sevenn_exec_host' if main else 'libsevenn_exec'
    out = torch_ops.hashed_path(stem, [EXEC_SRC], suffix='' if main
                                else '.so')
    flags = (['-DSEVENN_EXEC_MAIN'] if main else ['-shared'])
    return torch_ops.start_gxx(out, [EXEC_SRC],
                               [*flags, *torch_ops.cxx_flags(), '-ldl'])


def exec_library() -> str:
    return torch_ops.finish_gxx(_exec_job(False))


def exec_host() -> str:
    return torch_ops.finish_gxx(_exec_job(True))


def harness(exec_lib: str = None) -> str:
    """The harness binary over ``exec_lib`` (default: ``exec_library()``)."""
    exec_lib = exec_lib or exec_library()
    sources = [PAIR_SRC, HARNESS_SRC, *sorted(glob.glob(
        os.path.join(PAIR_DIR, '*.h'))), *sorted(glob.glob(
            os.path.join(MOCK_DIR, '*.h')))]
    out = torch_ops.hashed_path('sevenn_lammps_harness', sources,
                                extra=exec_lib, suffix='')
    lib_dir = os.path.dirname(os.path.abspath(exec_lib))
    return torch_ops.finish_gxx(torch_ops.start_gxx(
        out, [PAIR_SRC, HARNESS_SRC, exec_lib],
        [*LAMMPS_FLAGS, '-O1', '-Wall', '-Wextra',
         f'-Wl,-rpath,{lib_dir}']))


def build_all() -> Dict[str, str]:
    """The shim, the exec library and host (their g++ in parallel), then
    the harness; returns their paths by name."""
    jobs = {'torch_ops': torch_ops.start_build(),
            'exec_library': _exec_job(False), 'exec_host': _exec_job(True)}
    out = {name: torch_ops.finish_gxx(job) for name, job in jobs.items()}
    out['harness'] = harness(out['exec_library'])
    return out
