"""The edge-row pair (kernels 1-2 at ``agg_d = 0``) as PyTorch dispatcher
ops: ``torch.ops.sevenn_torch.conv_edge_fwd`` / ``conv_edge_bwd``.

``csrc/torch_ops.cpp`` defines both schemas and their CUDA implementation
(the C entries ``fused_conv_edge_fwd`` / ``_bwd`` of the kernel library,
opened at the first launch); it is compiled with g++ against the installed
PyTorch at first use into ``_build/libsevenn_torch_ops_<hash>.so``, the
hash taken over the source and the PyTorch version. This module loads it
(``torch.ops.load_library``) and registers both ops' output shapes
(``register_fake``: the forward's (E, d_out), the backward's like xg, sh,
emb).

``FusedConv.kernel_forward`` / ``kernel_backward`` launch the edge pair
through ``edge_forward`` / ``edge_backward`` below, inside
``fused_conv._FusedConvFn``, whose backward supplies the gradient: so a
traced graph (``make_fx`` records the ops of an autograd Function's forward
and backward), an AOTInductor artifact and a C++ host launch the same
kernels as the calculator (``scripts/deploy.py``). A launch is counted
where it happens, in the shim (``shim_launches``); the wrappers add the
shim's count to ``cuda_build.launch_counts``, so a call on fake tensors
(a trace) counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
from typing import List, Sequence

import torch

from . import cuda_build

SRC_PATH = os.path.join(cuda_build.CSRC_DIR, 'torch_ops.cpp')
NAMESPACE = 'sevenn_torch'
# the kernel libraries the ops open, by sevenn_torch_ops_set_library's index
KERNEL_LIBRARIES = ('fused_conv_geom', 'fused_conv_geom_ssp')
_ACT_SSP = 2


def cxx_flags() -> List[str]:
    """g++ flags of a library or program against the installed PyTorch:
    its headers, its libraries (all of them linked, so that a CUDA build
    registers its runtime) and its C++ ABI."""
    from torch.utils import cpp_extension

    lib_dir = cpp_extension.library_paths()[0]
    libs = ['-ltorch', '-ltorch_cpu', '-lc10']
    for name in ('torch_cuda', 'c10_cuda'):
        if os.path.exists(os.path.join(lib_dir, f'lib{name}.so')):
            libs.append(f'-l{name}')
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return ['-std=c++17', '-O2', '-fPIC',
            f'-D_GLIBCXX_USE_CXX11_ABI={abi}',
            *(f'-I{p}' for p in cpp_extension.include_paths()),
            f'-L{lib_dir}', f'-Wl,-rpath,{lib_dir}', '-Wl,--no-as-needed',
            *libs]


def hashed_path(stem: str, sources: Sequence[str], extra: str = '',
                suffix: str = '.so') -> str:
    """``_build/<stem>_<hash><suffix>``, the hash over the sources, the
    PyTorch version and ``extra``."""
    digest = hashlib.sha1(torch.__version__.encode() + extra.encode())
    for path in sources:
        with open(path, 'rb') as fh:
            digest.update(fh.read())
    return os.path.join(cuda_build.BUILD_DIR,
                        f'{stem}_{digest.hexdigest()[:12]}{suffix}')


def start_gxx(out: str, sources: Sequence[str], flags: Sequence[str]):
    """Start g++ into ``out`` (through a temporary file); returns (out,
    tmp, process), or (out, None, None) when it is built already."""
    if os.path.exists(out):
        return out, None, None
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    cmd = ['g++', *sources, *flags, '-o', tmp]
    return out, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)


def finish_gxx(job) -> str:
    out, tmp, proc = job
    if proc is not None:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed on {out} ({proc.returncode}):\n'
                               f'{stderr}')
        os.replace(tmp, out)
    return out


def library_path() -> str:
    return hashed_path('libsevenn_torch_ops', [SRC_PATH])


def start_build():
    """Start the shim's g++ (it takes ~20-30 s: PyTorch's headers)."""
    return start_gxx(library_path(), [SRC_PATH], ['-shared', *cxx_flags()])


def build() -> str:
    return finish_gxx(start_build())


def has_schema() -> bool:
    """Whether the ops' schemas are in this process's dispatcher (loaded
    from the package's shim or from a deployed artifact's copy)."""
    try:
        torch.ops.sevenn_torch.conv_edge_fwd
    except AttributeError:
        return False
    return True


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the shim, register the fake
    shapes; returns the shim's ctypes handle (its
    ``sevenn_torch_ops_set_library`` / ``sevenn_torch_ops_launches``)."""
    path = build()
    if has_schema():
        raise RuntimeError(f'the {NAMESPACE} ops are registered already by '
                           'another library')
    torch.ops.load_library(path)
    lib = ctypes.CDLL(path)
    lib.sevenn_torch_ops_set_library.argtypes = [ctypes.c_int,
                                                 ctypes.c_char_p]
    lib.sevenn_torch_ops_set_library.restype = ctypes.c_int
    lib.sevenn_torch_ops_launches.argtypes = [ctypes.c_void_p]
    lib.sevenn_torch_ops_launches.restype = None
    _register_python_side()
    return lib


def kernel_library(act_code: int) -> str:
    """The kernel library of an activation code (``_dims``' act)."""
    return KERNEL_LIBRARIES[int(act_code == _ACT_SSP)]


# the kernel library files named to the shim, by name
_library_paths = {}


def set_kernel_library(name: str, path: str):
    """Name to the shim the file of kernel library ``name``; the next
    launch with its activation opens it. A library opened before stays
    loaded (launches may be in flight), so an A/B of two builds switches
    between them (``tools/geom_ab.py --edge``, ``tools/geom_passes.py``)."""
    err = load().sevenn_torch_ops_set_library(KERNEL_LIBRARIES.index(name),
                                              path.encode())
    if err != 0:
        raise RuntimeError(f'{NAMESPACE}: cannot name {path} ({err})')
    _library_paths[name] = path


def use_kernel_library(name: str):
    """Build the kernel library ``name`` (nvcc, at first use) and name it
    to the shim, unless a file is named already."""
    if name not in _library_paths:
        set_kernel_library(name, cuda_build.build(name))


def shim_launches() -> List[int]:
    """[forward, backward] launches the shim made in this process."""
    out = (ctypes.c_int64 * 2)()
    load().sevenn_torch_ops_launches(out)
    return [int(out[0]), int(out[1])]


def op_dims(dims) -> List[int]:
    """``FusedConv._dims`` as the ops' ``int[] dims``: the 14 ints, then the
    4 floats' float32 bit patterns."""
    return [int(v) for v in dims[:14]] + [
        struct.unpack('<i', struct.pack('<f', float(v)))[0]
        for v in dims[14:]]


def _register_python_side():
    ns = f'{NAMESPACE}::'

    @torch.library.register_fake(ns + 'conv_edge_fwd')
    def _fwd_fake(xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2, si2t, ins,
                  col_ins, col_w, nz_idx, nz_coef, grp, grp_alpha, xent,
                  xins, dims):
        return xg.new_empty((xg.shape[0], dims[6]))

    @torch.library.register_fake(ns + 'conv_edge_bwd')
    def _bwd_fake(g, xg, sh, emb, ms, w0, w1, w1t, w2, w2t, si2, si2t, ins,
                  col_ins, col_w, nz_idx, nz_coef, grp, grp_alpha, xent,
                  xins, dims):
        return torch.empty_like(xg), torch.empty_like(sh), \
            torch.empty_like(emb)


def _op_tail(conv, xg, mlp_ws, si2_ws):
    """The ops' arguments after the activations: the packed weights, the
    kernel tables and ``op_dims``."""
    load()
    if xg.device.type == 'cuda':
        use_kernel_library(kernel_library(conv.act_code))
    t = conv.kernel_tables(xg.device)
    return (*conv._pack(mlp_ws, si2_ws), *conv.table_tensors(t),
            op_dims(conv._dims(t, xg.shape[0])))


def _counted(which: int, op, *args):
    """``op(*args)``, adding to ``launch_counts`` the launches the shim made
    in it (``which``: 0 forward, 1 backward)."""
    before = shim_launches()[which]
    out = op(*args)
    name = ('fused_conv_edge_fwd', 'fused_conv_edge_bwd')[which]
    cuda_build.launch_counts[name] += shim_launches()[which] - before
    return out


def edge_forward(conv, xg, sh, emb, ms, mlp_ws, si2_ws) -> torch.Tensor:
    """(E, d_out): the edge pair's forward of ``conv`` (a ``FusedConv`` at
    ``agg_d = 0``) through ``sevenn_torch::conv_edge_fwd``. On a CUDA tensor
    the op launches ``fused_conv_edge_fwd``; on another device it runs what
    is registered there (nothing by default)."""
    tail = _op_tail(conv, xg, mlp_ws, si2_ws)     # loads the ops first
    return _counted(0, torch.ops.sevenn_torch.conv_edge_fwd, xg, sh, emb, ms,
                    *tail)


def edge_backward(conv, g, xg, sh, emb, ms, mlp_ws, si2_ws):
    """(dxg, dsh, demb): the edge pair's backward through
    ``sevenn_torch::conv_edge_bwd``."""
    tail = _op_tail(conv, xg, mlp_ws, si2_ws)
    return _counted(1, torch.ops.sevenn_torch.conv_edge_bwd, g, xg, sh, emb,
                    ms, *tail)
