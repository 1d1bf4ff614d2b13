"""Small-matmul cost law on the card: fp32 against bf16 inputs.

    python -m sevennet_exp_tpu_torch.tools.bench_dot

Counterpart of ``tools/bench_dot.py``: out[g] = C^T Z[g] for G = 128
slices, C (K, M), Z (G, K, N), fp32 out, on the CG-operator shapes the
fused conv kernels care about, by the two kernels of ``csrc/bench_dot.cu``:
``fp32`` on the CUDA cores, ``bf16`` rounding the fp32 inputs to bf16 in
the kernel and multiplying on the tensor cores (mma.sync, fp32
accumulation). Prints per shape and type the microseconds per dot (one
launch over G) and the rate in Tmac/s, as the JAX tool does, and beside them
cuBLAS's time for the same function (``torch.bmm`` in fp32) and for the
same product on inputs already in bf16. Times are CUDA events. The inputs
come from a seeded ``torch.Generator`` on the card. Needs a card: without
one the tool exits nonzero. On CPU tensors the wrappers run the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import Callable, Dict, Optional

import torch

from ..ops import cuda_build
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

G = 128
DTYPES = ('fp32', 'bf16')
COUNTER = {d: f'bench_dot_{d}' for d in DTYPES}
SHAPES = (
    (27, 20, 16384),    # i1=1 CG fwd
    (45, 22, 8192),     # i1=2 CG fwd
    (20, 27, 16384),    # i1=1 CG bwd (transpose)
    (128, 128, 16384),  # full tile, same N
    (32, 32, 16384),
    (64, 64, 16384),
    (27, 20, 32768),    # N scaling
    (27, 20, 65536),
    (8, 128, 16384),    # K tiny, M full
    (128, 8, 16384),    # K full, M tiny
)


def make_inputs(K: int, M: int, N: int, device, g: int = G, seed: int = 0):
    """(C (K, M), Z (g, K, N)) standard normal from one seeded generator."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.randn(K, M, generator=gen, device=device),
            torch.randn(g, K, N, generator=gen, device=device))


def plain(dtype: str, C, Z) -> Tensor:
    """fp32: C^T Z[g] in fp32; bf16: the same fp32 product of the inputs
    rounded to bf16 (nearest even), which the kernel multiplies exactly
    and sums in fp32."""
    if dtype == 'bf16':
        C, Z = C.bfloat16().float(), Z.bfloat16().float()
    elif dtype != 'fp32':
        raise ValueError(dtype)
    return torch.matmul(C.t(), Z)


def library(C, Z) -> Tensor:
    """The one PyTorch call for the fp32 function: torch.bmm (cuBLAS)."""
    return torch.bmm(C.t().unsqueeze(0).expand(Z.shape[0], -1, -1), Z)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_dot')
    for fn in (lib.dot_fp32, lib.dot_bf16):
        fn.argtypes = [_P, _P, _I, _I, _I, _L, _P, _P]
        fn.restype = _I
    return lib


def kernel(dtype: str, C, Z) -> Tensor:
    """Launch the dtype's kernel of csrc/bench_dot.cu (CUDA tensors only;
    N a multiple of 128)."""
    if C.dim() != 2 or Z.dim() != 3 or Z.shape[1] != C.shape[0]:
        raise ValueError(f'C {tuple(C.shape)}, Z {tuple(Z.shape)}: want '
                         '(K, M) and (G, K, N)')
    for t in (C, Z):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != C.device:
            raise ValueError('bench_dot takes contiguous float32 tensors '
                             'on one device')
    g, K, N = Z.shape
    M = C.shape[1]
    if N % 128:
        raise ValueError(f'N = {N} is not a multiple of 128')
    out = torch.empty((g, M, N), dtype=C.dtype, device=C.device)
    fn = {'fp32': _lib().dot_fp32, 'bf16': _lib().dot_bf16}[dtype]
    err = fn(ctypes.c_void_p(C.data_ptr()), ctypes.c_void_p(Z.data_ptr()),
             g, K, M, N, ctypes.c_void_p(out.data_ptr()),
             ctypes.c_void_p(torch.cuda.current_stream(C.device).cuda_stream))
    cuda_build.check(err, COUNTER[dtype])
    cuda_build.launch_counts[COUNTER[dtype]] += 1
    return out


def forward(dtype: str, C, Z) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = C.device.type
    if dev == 'cuda':
        return kernel(dtype, C, Z)
    if dev == 'cpu':
        return plain(dtype, C, Z)
    raise ValueError(f'bench_dot: no kernel for device {dev}')


def cost(K: int, M: int, N: int, dtype: str, g: int = G):
    """(flops, bytes, peak flop/s) of one launch: 2 K M N per slice, C and
    Z read and out written once in fp32; the peak is fp32 outside the
    tensor cores, or dense bf16 on them."""
    peak = 67e12 if dtype == 'fp32' else 989e12
    return 2.0 * g * K * M * N, 4.0 * (K * M + g * (K * N + M * N)), peak


def run(reps: int = 20, check: Optional[Callable] = None) -> Dict:
    """Each shape and type launched once, then timed, with cuBLAS beside;
    prints as the JAX tool does. ``check(shape, dtype, C, Z, out)`` is
    called with each first launch's output (the outputs are up to 1 GB and
    not kept). Returns {(K, M, N): {'fp32' | 'bf16' | 'cublas_fp32' |
    'cublas_bf16': ms per launch}}."""
    res = {}
    for K, M, N in SHAPES:
        C, Z = make_inputs(K, M, N, 'cuda')
        row = res[(K, M, N)] = {}
        for dtype in DTYPES:
            out = forward(dtype, C, Z)
            if check is not None:
                check((K, M, N), dtype, C, Z, out)
            del out
            ms = row[dtype] = cuda_ms(lambda: forward(dtype, C, Z),
                                      reps=reps)
            per_dot = ms * 1e-3 / G
            print(f'K={K:4d} M={M:4d} N={N:6d} {dtype}: {per_dot * 1e6:8.2f} '
                  f'us/dot  {K * M * N / per_dot / 1e12:7.2f} Tmac/s',
                  flush=True)
        row['cublas_fp32'] = cuda_ms(lambda: library(C, Z), reps=reps)
        Cb, Zb = C.bfloat16(), Z.bfloat16()
        row['cublas_bf16'] = cuda_ms(
            lambda: torch.matmul(Cb.t(), Zb), reps=reps)
        print(f'{"":22s}cuBLAS fp32 {row["cublas_fp32"] * 1e3 / G:8.2f} '
              f'us/dot, bf16 inputs {row["cublas_bf16"] * 1e3 / G:8.2f}; '
              f'fp32/bf16 {row["fp32"] / row["bf16"]:.2f}', flush=True)
        del C, Z, Cb, Zb
    return res


def main(argv=None) -> int:
    if not require_card('bench_dot'):
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
