"""Four ways to form the lane tile of a packed CG inner loop, on the card.

    python -m sevennet_exp_tpu_torch.tools.bench_tile [E]

Counterpart of ``tools/bench_tile.py`` (E rows, default 32768; mul = 32,
d1 = 5, W = 160, reps = 8): out[e, u] = sum_r (1 + r) sum_m x[e, 32 m + u]
s[e, m], x (E, 160), s (E, 5) -> out (E, 32), with the tiled row
st[32 m + u] = s[e, m] (1 + r) formed four ways by the kernels of
``csrc/bench_tile.cu``:

  d:per-slice    the unpacked baseline: each slice times its s column
  a:repeat       a register broadcast of s[e, m] (``__shfl_sync``)
  b:bcast+cat    the tiled row staged in shared memory: every pass writes
                 all 160 columns and reads its 5 back (two staging rows a
                 warp, alternating by pass)
  c:mxu-tile     the tiled row as (s (1 + r)) @ T, T the (5, 160) ones-block
                 (``bench_tile.py:34-36``), on CUDA cores in fp32, T read
                 from device memory into each lane's registers (a half-warp
                 a row, each lane on two channels)

b and c walk the rows on a persistent grid, the next row's loads in flight
while a row's passes run. b's own floor is its staging traffic
(``b_shared_bytes``, ``b_shared_floor_ms``), c's the arithmetic of its
tiling product (``formulation_bound_ms``); both are printed beside the
bound of the function, which is bytes.

Each variant is held against d within 1e-3, as ``bench_tile.py:118-124``,
and against its own plain version within 1e-4 max|plain|; a variant that
fails to build, launch or match stops the tool (nonzero exit). Then each is
timed (CUDA events) over ``COPIES`` input copies that rotate, built before
the timed window (x (1 + 1e-6 i), in the spirit of the JAX tool's loop), so
that the inputs of one launch are out of the 50 MB L2 cache by its next.
The inputs come from a seeded ``torch.Generator`` (the JAX tool draws x and
s from one PRNG key; that stream cannot be reproduced). Needs a card:
without one the tool exits nonzero. On CPU tensors the wrappers run the
plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import sys
from typing import Dict

import numpy as np
import torch

from ..ops import cuda_build
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

B, MUL, D1 = 256, 32, 5
W = MUL * D1
REPS = 8           # passes, each (1 + r) times the tile
VARIANTS = ('d:per-slice', 'a:repeat', 'b:bcast+cat', 'c:mxu-tile')
COUNTER = {v: f'bench_tile_{v[0]}' for v in VARIANTS}
CROSS_TOL = 1e-3   # bench_tile.py:124
REL_TOL = 1e-4     # each kernel against its plain version
COPIES = 4         # 4 x 25.8 MB of inputs rotate through the timed launches
# H100 SXM: 67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s (NVIDIA's data
# sheet); 132 SMs, each with 32 shared-memory banks of 4 bytes a clock, at
# most 1.98 GHz
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
SMS, SMEM_BYTES_PER_CLOCK, CLOCK_HZ = 132, 128, 1.98e9


def ones_block() -> np.ndarray:
    """T (d1, W): T[m, 32 m:32 m + 32] = 1, as ``bench_tile.py:34-36``."""
    T = np.zeros((D1, W), np.float32)
    for m in range(D1):
        T[m, m * MUL:(m + 1) * MUL] = 1.0
    return T


def make_inputs(E: int, device, seed: int = 0):
    """(x (E, 160), s (E, 5)) standard normal from one seeded generator."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn(E, W, generator=gen, device=device),
            torch.randn(E, D1, generator=gen, device=device))


def input_copies(x, s):
    """``COPIES`` copies of the inputs, x scaled by (1 + 1e-6 i): made
    before a timed window, so that each launch reads its inputs from device
    memory."""
    return [(x * (1.0 + 1e-6 * i), s.clone()) for i in range(COPIES)]


def rotate(fn, copies):
    """A call of fn(x, s) on the next copy at each call."""
    it = itertools.count()
    return lambda: fn(*copies[next(it) % len(copies)])


def _groupsum(prod):
    acc = prod[:, 0:MUL]
    for m in range(1, D1):
        acc = acc + prod[:, m * MUL:(m + 1) * MUL]
    return acc


def plain(variant: str, x, s, T=None) -> Tensor:
    """The four formulations in plain PyTorch, as the JAX kernels."""
    acc = None
    for r in range(REPS):
        sr = s * (1.0 + r)
        if variant == 'd:per-slice':
            g = None
            for m in range(D1):
                t = x[:, m * MUL:(m + 1) * MUL] * sr[:, m:m + 1]
                g = t if g is None else g + t
        else:
            if variant == 'a:repeat':
                st = torch.repeat_interleave(sr, MUL, dim=1)
            elif variant == 'b:bcast+cat':
                st = torch.cat([sr[:, m:m + 1].expand(-1, MUL)
                                for m in range(D1)], dim=1)
            elif variant == 'c:mxu-tile':
                if T is None:
                    T = torch.as_tensor(ones_block(), device=x.device)
                st = sr @ T
            else:
                raise ValueError(variant)
            g = _groupsum(x * st)
        acc = g if acc is None else acc + g
    return acc


def library(x, s) -> Tensor:
    """One PyTorch call for one pass of the function (sum_m x s, r = 0):
    the yardstick of the bytes, the function being bound by them."""
    return torch.einsum('emu,em->eu', x.view(-1, D1, MUL), s)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

_P, _L = ctypes.c_void_p, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_tile')
    lib.tile_dab.argtypes = [ctypes.c_char, _P, _P, _L, _P, _P]
    lib.tile_c.argtypes = [_P, _P, _P, _L, _P, _P]
    for fn in (lib.tile_dab, lib.tile_c):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _device_T(device: torch.device) -> Tensor:
    """T on ``device``, made once per device."""
    return torch.as_tensor(ones_block(), device=device)


def kernel(variant: str, x, s, T=None) -> Tensor:
    """Launch the variant's kernel of csrc/bench_tile.cu (CUDA tensors
    only); c reads T (default: the ones-block) from device memory."""
    E = x.shape[0]
    for name, t, width in (('x', x, W), ('s', s, D1)):
        if tuple(t.shape) != (E, width) or t.dtype != torch.float32 or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{name}: want contiguous float32 ({E}, {width}) '
                             f'on one device, got {tuple(t.shape)}')
    out = torch.empty((E, MUL), dtype=x.dtype, device=x.device)
    P = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _lib()
    if variant == 'c:mxu-tile':
        T = _device_T(x.device) if T is None else T
        if tuple(T.shape) != (D1, W) or T.dtype != torch.float32 or \
                not T.is_contiguous() or T.device != x.device:
            raise ValueError(f'T: want contiguous float32 ({D1}, {W})')
        err = lib.tile_c(P(x), P(s), P(T), E, P(out), stream)
    elif variant in VARIANTS:
        err = lib.tile_dab(variant[0].encode(), P(x), P(s), E, P(out),
                           stream)
    else:
        raise ValueError(variant)
    cuda_build.check(err, COUNTER[variant])
    cuda_build.launch_counts[COUNTER[variant]] += 1
    return out


def forward(variant: str, x, s, T=None) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = x.device.type
    if dev == 'cuda':
        return kernel(variant, x, s, T)
    if dev == 'cpu':
        return plain(variant, x, s, T)
    raise ValueError(f'bench_tile: no kernel for device {dev}')


def cost(E: int):
    """(flops, bytes) of the function all four variants compute: a
    multiply-add per pass, slice and output; x, s read and out written
    once."""
    return 2.0 * REPS * D1 * MUL * E, 4.0 * E * (W + D1 + MUL)


def formulation_flops(variant: str, E: int) -> float:
    """The arithmetic each formulation does (c adds its dense tiling
    product, (E, 5) @ (5, 160) per pass); printed beside the bound, not
    part of it."""
    extra = 2.0 * REPS * D1 * W * E if variant == 'c:mxu-tile' else 0.0
    return cost(E)[0] + extra


def formulation_bound_ms(variant: str, E: int) -> float:
    """The least time of a formulation's own arithmetic at the fp32 peak
    (c: 0.0075 ms at E = 32,768, just under the 0.0077 ms of the
    function's bytes)."""
    return formulation_flops(variant, E) / PEAK_FP32 * 1e3


def b_shared_bytes(E: int) -> float:
    """Bytes b moves through shared memory: each of its REPS passes writes
    the whole tiled row (W floats) and reads it back, 2 x 8 x 160 x 4 =
    10,240 bytes a row."""
    return 2.0 * REPS * W * 4 * E


def b_shared_floor_ms(E: int) -> float:
    """The least time of b's staging traffic: ``b_shared_bytes`` at 128
    bytes a clock on each SM (0.0100 ms at E = 32,768 on 132 SMs at 1.98
    GHz), above the 0.0077 ms of its device-memory bytes."""
    return b_shared_bytes(E) / (SMEM_BYTES_PER_CLOCK * SMS * CLOCK_HZ) * 1e3


def run(E: int = 32768, reps: int = 20) -> Dict:
    """Each variant once (outputs kept), held against d and against its
    plain version, then timed over rotating input copies; prints as the JAX
    tool does. Returns {'inputs', 'copies', 'out', 'ms', 'err',
    'cross_err'}."""
    x, s = make_inputs(E, 'cuda')
    copies = input_copies(x, s)
    res = {'inputs': (x, s), 'copies': copies, 'out': {}, 'ms': {},
           'err': {}, 'cross_err': {}}
    ref = None
    for v in VARIANTS:
        out = res['out'][v] = forward(v, x, s)
        p = plain(v, x, s)
        err = float((out - p).abs().max())
        lim = REL_TOL * float(p.abs().max())
        if not err <= lim:
            raise AssertionError(f'bench_tile {v}: |err| against plain '
                                 f'{err:.3e} > {lim:.3e}')
        res['err'][v] = err
        if ref is None:
            ref = out
        else:
            cross = float((out - ref).abs().max())
            if not cross < CROSS_TOL:
                raise AssertionError(f'bench_tile {v}: differs from '
                                     f'{VARIANTS[0]} by {cross:.3e}')
            res['cross_err'][v] = cross
        ms = res['ms'][v] = cuda_ms(
            rotate(lambda xi, si: forward(v, xi, si), copies), reps=reps)
        floor = {'b:bcast+cat': ('shared memory', b_shared_floor_ms(E)),
                 'c:mxu-tile': ('its fp32 arithmetic',
                                formulation_bound_ms(v, E))}.get(v)
        print(f'{v:14s} {ms:7.4f} ms' + (
            f' (floor of {floor[0]}: {floor[1]:.4f} ms)' if floor else ''),
            flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('bench_tile'):
        return 2
    E = int(argv[0]) if len(argv) > 0 else 32768
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    run(E)
    return 0


if __name__ == '__main__':
    sys.exit(main())
