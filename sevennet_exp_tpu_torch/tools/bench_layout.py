"""Edge-major against feature-major elementwise work, on the card.

    python -m sevennet_exp_tpu_torch.tools.bench_layout

Counterpart of ``tools/bench_layout.py`` (no arguments; B = 256, MUL = 32,
NSLICE = 16, R = 24, GRID = 128, D = 512): R passes of 16 sliced products
of two (32768, 512) fp32 operands summed into (32768, 32), by three kernels
of ``csrc/bench_layout.cu``:

  rowmajor    (B, 32) slices of the edge-major inputs
  colmajor    (32, B) slices of the tool's feature-major inputs,
              ``x.T.reshape(GRID * D, B)`` (``bench_layout.py:92-93``: the
              row-major reshape of the whole transpose, not a transpose per
              block), out (GRID * 32, B)
  transpose   the edge-major inputs through one transpose in and one out in
              shared memory; the same function as rowmajor

Each kernel is held against its plain version within 1e-4 max|plain|, and
rowmajor against transpose, then timed (CUDA events); prints ms and GMAC/s
as ``bench_layout.py:106-111`` (whose GMAC/s divides MACs by milliseconds,
so it reads 1,000x low; this tool divides by seconds). The inputs are the
JAX tool's own (``np.random.default_rng(0)``). Needs a card: without one
the tool exits nonzero. On CPU tensors the wrappers run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Dict

import numpy as np
import torch

from ..ops import cuda_build
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

B = 256          # edge rows per block
MUL = 32         # channel width of the sliced ops (the 7net-0 l=2 mul)
NSLICE = 16      # slices of MUL columns
R = 24           # repeated passes
GRID = 128       # blocks per launch
D = MUL * NSLICE
VARIANTS = ('rowmajor', 'colmajor', 'transpose')
COUNTER = {v: f'bench_layout_{v}' for v in VARIANTS}
REL_TOL = 1e-4   # kernel against plain, and rowmajor against transpose


def make_inputs(device, grid: int = GRID, seed: int = 0):
    """(x_rm, y_rm), (GRID B, D) float32, as ``bench_layout.py:90-91``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(grid * B, D)).astype(np.float32)
    y = rng.normal(size=(grid * B, D)).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(y, device=device))


def colmajor_inputs(x_rm: Tensor) -> Tensor:
    """``x_rm.T.reshape(GRID * D, B)`` (``bench_layout.py:92``)."""
    grid = x_rm.shape[0] // B
    return x_rm.t().contiguous().reshape(grid * D, B)


def inputs_for(variant: str, x_rm, y_rm):
    if variant == 'colmajor':
        return colmajor_inputs(x_rm), colmajor_inputs(y_rm)
    return x_rm, y_rm


def plain(variant: str, x, y) -> Tensor:
    """R times the sum over the 16 slices, in the variant's layout (the
    passes repeat the same sum, so R x it is the function; the JAX kernels
    accumulate them one by one, within ~1e-6 of it)."""
    if variant in ('rowmajor', 'transpose'):
        return R * (x * y).reshape(-1, NSLICE, MUL).sum(dim=1)
    if variant == 'colmajor':
        grid = x.shape[0] // D
        return R * (x * y).reshape(grid, NSLICE, MUL, B).sum(dim=1).reshape(
            grid * MUL, B)
    raise ValueError(variant)


def library(variant: str, x, y) -> Tensor:
    """One PyTorch call for one pass of the function (the yardstick of the
    bytes, both being bound by them): an einsum over the slices."""
    if variant in ('rowmajor', 'transpose'):
        return torch.einsum('esu,esu->eu', x.view(-1, NSLICE, MUL),
                            y.view(-1, NSLICE, MUL))
    if variant == 'colmajor':
        grid = x.shape[0] // D
        return torch.einsum('isub,isub->iub', x.view(grid, NSLICE, MUL, B),
                            y.view(grid, NSLICE, MUL, B)).reshape(
                                grid * MUL, B)
    raise ValueError(variant)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

_P, _L = ctypes.c_void_p, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_layout')
    for fn in (lib.layout_rowmajor, lib.layout_colmajor,
               lib.layout_transpose):
        fn.argtypes = [_P, _P, _L, _P, _P]
        fn.restype = ctypes.c_int
    return lib


def kernel(variant: str, x, y) -> Tensor:
    """Launch the variant's kernel of csrc/bench_layout.cu (CUDA tensors
    only)."""
    n = x.shape[0]
    width = B if variant == 'colmajor' else D
    for name, t in (('x', x), ('y', y)):
        if t.dim() != 2 or tuple(t.shape) != (n, width) or \
                t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != x.device:
            raise ValueError(f'{name}: want contiguous float32 ({n}, {width}) '
                             f'on one device, got {tuple(t.shape)}')
    P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    if variant == 'colmajor':
        if n % D:
            raise ValueError(f'colmajor: {n} rows is not a multiple of {D}')
        out = torch.empty((n // D * MUL, B), dtype=x.dtype, device=x.device)
        err = lib.layout_colmajor(P(x), P(y), n // D, P(out), stream)
    elif variant in ('rowmajor', 'transpose'):
        if variant == 'transpose' and n % 32:
            raise ValueError(f'transpose: {n} rows is not a multiple of 32')
        out = torch.empty((n, MUL), dtype=x.dtype, device=x.device)
        fn = lib.layout_rowmajor if variant == 'rowmajor' else \
            lib.layout_transpose
        err = fn(P(x), P(y), n, P(out), stream)
    else:
        raise ValueError(variant)
    cuda_build.check(err, COUNTER[variant])
    cuda_build.launch_counts[COUNTER[variant]] += 1
    return out


def forward(variant: str, x, y) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = x.device.type
    if dev == 'cuda':
        return kernel(variant, x, y)
    if dev == 'cpu':
        return plain(variant, x, y)
    raise ValueError(f'bench_layout: no kernel for device {dev}')


def macs(grid: int = GRID) -> int:
    """Multiply-adds per launch, as ``bench_layout.py:105``."""
    return grid * B * D * R


def cost(grid: int = GRID):
    """(flops, bytes) of the function, the same for the three layouts: a
    multiply-add per pass, slice and output; x and y read and out written
    once."""
    E = grid * B
    return 2.0 * macs(grid), 4.0 * (2 * E * D + E * MUL)


def check(what: str, got, ref) -> float:
    """max|got - ref|, raising above REL_TOL max|ref| (or if not finite)."""
    err = float((got - ref).abs().max())
    lim = REL_TOL * float(ref.abs().max())
    if not err <= lim:
        raise AssertionError(f'bench_layout {what}: |err| {err:.3e} > '
                             f'{lim:.3e}')
    return err


def run(reps: int = 20) -> Dict:
    """Each kernel once, held against its plain version and rowmajor
    against transpose; then each timed; prints as the JAX tool does.
    Returns {'inputs', 'out', 'ms', 'err', 'cross_err'}."""
    x, y = make_inputs('cuda')
    ins = {v: inputs_for(v, x, y) for v in VARIANTS}
    res = {'inputs': ins, 'out': {}, 'ms': {}, 'err': {}}
    for v in VARIANTS:
        res['out'][v] = forward(v, *ins[v])
        res['err'][v] = check(v, res['out'][v], plain(v, *ins[v]))
    res['cross_err'] = check('transpose against rowmajor',
                             res['out']['transpose'], res['out']['rowmajor'])
    ops = macs()
    names = {'rowmajor': f'rowmajor  (B,{MUL}) slices :',
             'colmajor': f'colmajor  ({MUL},B) slices :',
             'transpose': 'transpose-in-kernel        :'}
    for v in VARIANTS:
        ms = res['ms'][v] = cuda_ms(lambda: forward(v, *ins[v]), reps=reps)
        print(f'{names[v]} {ms:8.3f} ms  {ops / ms / 1e6:7.1f} GMAC/s',
              flush=True)
    return res


def main(argv=None) -> int:
    if not require_card('bench_layout'):
        return 2
    print(card(), flush=True)
    run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
