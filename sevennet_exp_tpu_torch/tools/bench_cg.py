"""Three formulations of one CG instruction, on the card.

    python -m sevennet_exp_tpu_torch.tools.bench_cg [E]

Counterpart of ``tools/bench_cg.py``: the (l1, l2, l3) = (2, 2, 2) uvu
instruction at mul = 32, x (E, 160), y (E, 5) -> out (E, 160), E rows
(default 32768), by three kernels of ``csrc/bench_cg.cu``:

  a:per-term      the nonzero terms of w3j(2, 2, 2), one thread per
                  (row, channel)
  b:3d-reshape    S = y @ C per row (C (5, 25)), then the sum over m of
                  x (5, 32) times S (5, 5)
  c:full-width    St = S @ T, the S row tiled to (800,) by the (25, 800)
                  table T, then one (160,) product per p and the group sum

C and T are built as ``bench_cg.py:59-69``. Each variant is held against
the first within 1e-4, as the JAX tool holds them, then timed (CUDA
events). The inputs come from a seeded ``torch.Generator`` on the card
(the JAX PRNG stream cannot be reproduced). Needs a card: without one the
tool exits nonzero. On CPU tensors the wrappers run the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Dict

import numpy as np
import torch

from ..ops import cuda_build
from ..ops.wigner import wigner_3j
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

MUL, L1, L2, L3 = 32, 2, 2, 2
D1, D2, D3 = 2 * L1 + 1, 2 * L2 + 1, 2 * L3 + 1
W = MUL * D1
VARIANTS = ('a:per-term', 'b:3d-reshape', 'c:full-width')
COUNTER = {'a:per-term': 'bench_cg_a', 'b:3d-reshape': 'bench_cg_b',
           'c:full-width': 'bench_cg_c'}
CROSS_TOL = 1e-4     # bench_cg.py:132


def terms():
    """The nonzero (m, n, p, c) of w3j(2, 2, 2), as ``bench_cg.py:36-39``."""
    w3j = np.asarray(wigner_3j(L1, L2, L3))
    return [(m, n, p, float(w3j[m, n, p]))
            for m in range(D1) for n in range(D2) for p in range(D3)
            if abs(w3j[m, n, p]) > 1e-12]


def tables():
    """(C (d2, d1 d3), T (d1 d3, d3 W)) as ``bench_cg.py:59-69``."""
    C = np.zeros((D2, D1 * D3), np.float32)
    for (m, n, p, c) in terms():
        C[n, m * D3 + p] = c
    T = np.zeros((D1 * D3, D3 * W), np.float32)
    for m in range(D1):
        for p in range(D3):
            T[m * D3 + p, p * W + m * MUL:p * W + (m + 1) * MUL] = 1.0
    return C, T


def make_inputs(E: int, device, seed: int = 0):
    """(x, y) standard normal from one seeded generator."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn(E, W, generator=gen, device=device),
            torch.randn(E, D2, generator=gen, device=device))


def plain(variant: str, x, y) -> Tensor:
    """The three formulations in plain PyTorch, as the JAX kernels."""
    if variant == 'a:per-term':
        cache, acc = {}, [None] * D3
        for (m, n, p, c) in terms():
            if (m, n) not in cache:
                cache[(m, n)] = x[:, m * MUL:(m + 1) * MUL] * y[:, n:n + 1]
            t = cache[(m, n)] * c
            acc[p] = t if acc[p] is None else acc[p] + t
        return torch.cat([a if a is not None else x.new_zeros(x.shape[0], MUL)
                          for a in acc], dim=1)
    C, T = (torch.as_tensor(a, device=x.device) for a in tables())
    S = y @ C                                   # (E, d1 d3): S[m d3 + p]
    if variant == 'b:3d-reshape':
        S3 = S.reshape(-1, D1, D3)
        x3 = x.reshape(-1, D1, MUL)
        return torch.cat([(x3 * S3[:, :, p:p + 1]).sum(dim=1)
                          for p in range(D3)], dim=1)
    if variant == 'c:full-width':
        St = S @ T                              # (E, d3 W)
        outs = []
        for p in range(D3):
            prod = x * St[:, p * W:(p + 1) * W]
            acc = prod[:, 0:MUL]
            for m in range(1, D1):
                acc = acc + prod[:, m * MUL:(m + 1) * MUL]
            outs.append(acc)
        return torch.cat(outs, dim=1)
    raise ValueError(variant)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_cg')
    lib.cg_a.argtypes = [_P] * 4 + [_I, _L, _P, _P]
    lib.cg_b.argtypes = [_P] * 3 + [_L, _P, _P]
    lib.cg_c.argtypes = [_P] * 4 + [_L, _P, _P]
    for fn in (lib.cg_a, lib.cg_b, lib.cg_c):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _host_terms():
    """The terms sorted by p, as cg_a takes them: (m | n << 8 | p << 16,
    coefficient) in host arrays."""
    ts = sorted(terms(), key=lambda t: t[2])
    idx = np.asarray([m | (n << 8) | (p << 16) for (m, n, p, _) in ts],
                     np.int32)
    coef = np.asarray([c for (_, _, _, c) in ts], np.float32)
    return idx, coef


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device):
    """C and T on ``device``, made once per device."""
    return tuple(torch.as_tensor(a, device=device) for a in tables())


def kernel(variant: str, x, y) -> Tensor:
    """Launch the variant's kernel of csrc/bench_cg.cu (CUDA tensors
    only)."""
    E = x.shape[0]
    for name, t, width in (('x', x, W), ('y', y, D2)):
        if tuple(t.shape) != (E, width) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{name}: want contiguous float32 ({E}, {width}) '
                             f'on one device, got {tuple(t.shape)}')
    out = torch.empty((E, D3 * MUL), dtype=x.dtype, device=x.device)
    P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    if variant == 'a:per-term':
        idx, coef = _host_terms()
        err = lib.cg_a(P(x), P(y), idx.ctypes.data_as(_P),
                       coef.ctypes.data_as(_P), len(idx), E, P(out), stream)
    else:
        C, T = _device_tables(x.device)
        if variant == 'b:3d-reshape':
            err = lib.cg_b(P(x), P(y), P(C), E, P(out), stream)
        elif variant == 'c:full-width':
            err = lib.cg_c(P(x), P(y), P(C), P(T), E, P(out), stream)
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
    raise ValueError(f'bench_cg: no kernel for device {dev}')


def library(x, y) -> Tensor:
    """The one PyTorch call that computes the instruction:
    out[e, p mul + u] = sum_{m, n} w3j[m, n, p] x[e, m mul + u] y[e, n]."""
    w3j = torch.as_tensor(np.asarray(wigner_3j(L1, L2, L3), np.float32),
                          device=x.device)
    return torch.einsum('mnp,emu,en->epu', w3j, x.view(-1, D1, MUL),
                        y).reshape(-1, D3 * MUL)


def cost(E: int):
    """(flops, bytes) of the function all three variants compute: a
    multiply, a multiply and an add per nonzero term and channel, and x, y
    read and out written once."""
    return E * 3.0 * len(terms()) * MUL, 4.0 * E * (W + D2 + D3 * MUL)


def formulation_flops(variant: str, E: int) -> float:
    """The arithmetic each formulation does (a: the terms; b: S, then d1 d3
    multiply-adds per channel; c: S, the dense tiling product St, then the
    products and sums); printed beside the bound, not part of it."""
    s = 2.0 * D2 * D1 * D3
    return E * {'a:per-term': 3.0 * len(terms()) * MUL,
                'b:3d-reshape': s + 2.0 * D1 * D3 * MUL,
                'c:full-width': s + 2.0 * D1 * D3 * D3 * W
                + 2.0 * D1 * D3 * MUL}[variant]


def run(E: int = 32768, reps: int = 20) -> Dict:
    """Each variant once (outputs kept and held against the first within
    1e-4), then timed; prints as the JAX tool does. Returns {'inputs',
    'out', 'ms', 'cross_err'}."""
    nz = terms()
    print(f'instruction ({L1},{L2},{L3}) mul={MUL}: {len(nz)} nz terms, '
          f'dim1*dim3={D1 * D3}', flush=True)
    inputs = make_inputs(E, 'cuda')
    res = {'inputs': inputs, 'out': {}, 'ms': {}, 'cross_err': {}}
    ref = None
    for variant in VARIANTS:
        out = res['out'][variant] = forward(variant, *inputs)
        if ref is None:
            ref = out
        else:
            err = float((out - ref).abs().max())
            res['cross_err'][variant] = err
            if not err < CROSS_TOL:
                raise AssertionError(f'{variant} differs from '
                                     f'{VARIANTS[0]} by {err:.3e}')
        ms = cuda_ms(lambda: forward(variant, *inputs), reps=reps)
        res['ms'][variant] = ms
        print(f'{variant:14s} {ms:7.3f} ms', flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('bench_cg'):
        return 2
    E = int(argv[0]) if len(argv) > 0 else 32768
    print(card(), flush=True)
    run(E)
    return 0


if __name__ == '__main__':
    sys.exit(main())
