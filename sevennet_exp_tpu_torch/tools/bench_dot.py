"""Small-matmul cost law on the card: fp32 against bf16 inputs.

    python -m sevennet_exp_tpu_torch.tools.bench_dot

Counterpart of ``tools/bench_dot.py``: out[g] = C^T Z[g] for G = 128
slices, C (K, M), Z (G, K, N), fp32 out, on the CG-operator shapes the
fused conv kernels care about, by the two kernels of ``csrc/bench_dot.cu``:
``fp32`` on the CUDA cores, ``bf16`` rounding the fp32 inputs to bf16 in
the kernel and multiplying on the tensor cores (mma.sync, fp32
accumulation). ``fp32`` is one of two kernels that ``plan`` picks per
shape: ``stream`` for the shapes bound by bytes (a block holds all of M for
its N tile, so Z is read once, and streams Z through a cp.async ring) and
``tile`` for those bound by operations (a register-blocked 128 x 128
SGEMM). ``bf16`` is bound by bytes on every shape; ``plan(..., dtype=
'bf16')`` gives its launch: a persistent grid over the N tiles of all of M
(at most 128 rows a block, so Z is read once), C^T rounded once and kept
in registers as A fragments, Z streamed through a 4- or 8-stage cp.async
ring and rounded once per landed piece, sums stored as full lines. Prints
per shape and type the microseconds per dot (one launch over G) and the
rate in Tmac/s, as the JAX tool does, and beside them
cuBLAS's time for the same function (``torch.bmm`` in fp32) and for the
same product on inputs already in bf16. Times are CUDA events. The inputs
come from a seeded ``torch.Generator`` on the card. Needs a card: without
one the tool exits nonzero. On CPU tensors the wrappers run the plain
versions.
"""

from __future__ import annotations

import ctypes
import functools
import math
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


# ---------------------------------------------------------------------
# the kernels' launch plans
# ---------------------------------------------------------------------

PEAK_BYTES = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
N_SM = 132                    # H100 SXM streaming multiprocessors
THREADS = 256
SMEM_BLOCK = 232448           # shared bytes a block may use (227 KB)
SMEM_SM = 233472              # shared bytes of an SM (228 KB)
SMEM_RESERVED = 1024          # the runtime's share of each block
# stream: the kernel's instances by rows a thread (TM), those also built
# with 8 columns a thread (CW = 8, BN = 256 only), its ring's stages, the
# most bytes of Z one stage holds
STREAM_TMS = (1, 2, 3, 4, 5, 6, 7, 8, 16)
STREAM_TMS_CW8 = (8,)
STREAM_STAGES = 3
STAGE_BYTES = 32 * 1024
# tile: the block's output tile, K step and stages (csrc/bench_dot.cu)
TILE_BM, TILE_BN, TILE_BK, TILE_STAGES = 128, 128, 8, 4
# 8 columns a thread where the FFMAs take at least this share of the time
# the bytes take (fewer shared loads per FFMA; (64, 64) alone of the ten)
CW8_FROM = 0.5
# bf16: the kernel's instances by k16 steps (C^T held in registers, so K <=
# 128), its ring's stages (a tile of at most BF16_DEEP_ITEMS K chunks and
# K <= 64 runs one block an SM on the deep ring, any other two blocks on
# the short ring),
# the landed pieces in bf16 (one barrier an item), the most bytes of Z one
# stage holds, the rows of M a block holds, the most columns a warp stages
# at a time (its staging rows are 8 floats wider)
BF16_KS = (1, 2, 3, 4, 8)
BF16_STAGES, BF16_DEEP, BF16_DEEP_ITEMS = 4, 8, 2
BF16_PIECES = 2
BF16_STAGE_BYTES = 16 * 1024
BF16_MT = 128
BF16_SW = 64
WARPS = THREADS // 32


def tm_pad(tm: int) -> int:
    """A stream thread's C rows as stored in shared memory: padded to a
    16-byte vector (8 bytes for 2 rows)."""
    return tm if tm <= 2 else -(-tm // 4) * 4


def _stream_plan(K: int, M: int, N: int, g: int, n_sm: int, cw8: bool):
    """The stream kernel's launch, or None when all of M does not fit one
    block's registers or its C and stages do not fit shared memory."""
    best = None
    for bn, cw in ((256, 8), (256, 4), (128, 4)):
        if N % bn or (cw == 8) != cw8:
            continue
        tmg = THREADS // (bn // cw)
        tms = STREAM_TMS_CW8 if cw == 8 else STREAM_TMS
        tm = next((t for t in tms if t * tmg >= M), None)
        if tm is not None:
            key = (tm * tmg - M, -tm)     # least padding, then more rows
            if best is None or key < best[0]:
                best = (key, bn, cw, tmg, tm)
    if best is None:
        return None if not cw8 else _stream_plan(K, M, N, g, n_sm, False)
    _, bn, cw, tmg, tm = best
    nkc = -(-K // (STAGE_BYTES // (4 * bn)))
    kc = -(-K // nkc)
    c_len = -(-K * tmg * tm_pad(tm) // 4) * 4
    smem = 4 * (c_len + STREAM_STAGES * kc * bn)
    if smem > SMEM_BLOCK:
        return None
    per_sm = min(2, SMEM_SM // (smem + SMEM_RESERVED))
    tiles = g * (N // bn)
    return {'cls': 'stream', 'tm': tm, 'cw': cw, 'tmg': tmg, 'mp': tm * tmg,
            'bn': bn, 'kc': kc, 'nkc': nkc, 'stages': STREAM_STAGES,
            'tiles': tiles, 'grid': (min(tiles, n_sm * per_sm), 1, 1),
            'threads': THREADS, 'smem': smem}


def _tile_plan(K: int, M: int, N: int, g: int):
    grid = (-(-M // TILE_BM), N // TILE_BN, g)
    return {'cls': 'tile', 'tm': 8, 'cw': 8, 'tmg': 16,
            'mp': grid[0] * TILE_BM,
            'bn': TILE_BN, 'kc': TILE_BK, 'nkc': -(-K // TILE_BK),
            'stages': TILE_STAGES, 'tiles': grid[0] * grid[1] * g,
            'grid': grid, 'threads': THREADS,
            'smem': 4 * TILE_STAGES * TILE_BK * (TILE_BM + TILE_BN)}


def _bf16_plan(K: int, M: int, N: int, g: int, n_sm: int):
    """The bf16 kernel's launch (``csrc/bench_dot.cu::bf16_plan``)."""
    if K > 16 * BF16_KS[-1]:
        raise ValueError(f'bench_dot bf16 holds C^T in registers: K <= '
                         f'{16 * BF16_KS[-1]}, got {K}')
    ks = next(k for k in BF16_KS if 16 * k >= K)
    strips = 1
    while strips * 16 < min(M, BF16_MT):
        strips *= 2
    nt8 = 4 if strips == 1 else 8
    wn = WARPS // strips
    bn = wn * 8 * nt8
    kc = K if 4 * K * bn <= BF16_STAGE_BYTES else \
        BF16_STAGE_BYTES // (4 * bn) // 16 * 16
    kcp = -(-kc // 16) * 16
    nkc = -(-K // kc)
    deep = nkc <= BF16_DEEP_ITEMS and ks <= 4
    stages = BF16_DEEP if deep else BF16_STAGES
    sw = min(8 * nt8, BF16_SW)
    smem = 4 * (stages * kc * bn + WARPS * 8 * (sw + 8)) + \
        2 * BF16_PIECES * kcp * (bn + 8)
    per_sm = 1 if deep else min(2, SMEM_SM // (smem + SMEM_RESERVED))
    ntiles = g * -(-N // bn)              # (slice, N tile) of one M block
    mtiles = -(-M // BF16_MT)
    return {'cls': 'bf16', 'ks': ks, 'nt8': nt8, 'strips': strips,
            'wn': wn, 'mp': 16 * strips, 'mtiles': mtiles, 'bn': bn, 'sw': sw,
            'kc': kc, 'kcp': kcp, 'nkc': nkc, 'stages': stages,
            'tiles': ntiles * mtiles,
            'grid': (min(ntiles, n_sm * per_sm), mtiles, 1),
            'threads': THREADS, 'smem': smem}


@functools.lru_cache(maxsize=None)
def plan(K: int, M: int, N: int, g: int = G, n_sm: int = N_SM,
         dtype: str = 'fp32') -> Dict:
    """The kernel and its launch for C (K, M), Z (g, K, N).

    fp32: 'stream' where the shape is bound by bytes (``cost``) and all of
    M fits one block (at most 16 rows a thread), else 'tile'. Returns the
    class, the tile (rows ``tm`` and columns ``cw`` a thread, thread
    groups across M ``tmg``, padded M ``mp``, N tile ``bn``, K step ``kc``
    and steps ``nkc``), the ring's stages, the output tiles, the grid
    (stream: persistent blocks, two an SM; tile: one block a tile), the
    threads and the dynamic shared bytes a block.

    bf16 (class 'bf16'): the k16 steps ``ks`` (C^T's A fragments a thread
    holds), the M16 ``strips`` of a 128-row block of M (``mp`` rows) and
    its ``mtiles`` blocks, the n8 sums a warp ``nt8``, the warps across N
    ``wn``, the N tile ``bn``, the K rows a stage ``kc`` (``kcp`` rounded up
    to 16) and chunks ``nkc``, the ring's stages (8 and one block an SM for
    a tile of at most two chunks and K <= 64, else 4 and two blocks), the
    tiles ((slice, N tile) for each block of M), the grid (persistent
    blocks across the tiles, times ``mtiles``), the threads and the
    dynamic shared bytes.

    Raises on N % 128, g outside 1..65535, K or M < 1, an unknown dtype,
    and for bf16 on K > 128."""
    if N < 128 or N % 128:
        raise ValueError(f'N = {N} is not a multiple of 128')
    if not 1 <= g <= 65535 or K < 1 or M < 1:
        raise ValueError(f'bench_dot: want 1 <= G <= 65535, K, M >= 1; got '
                         f'G = {g}, K = {K}, M = {M}')
    if dtype == 'bf16':
        return _bf16_plan(K, M, N, g, n_sm)
    if dtype != 'fp32':
        raise ValueError(dtype)
    flops, nbytes, peak = cost(K, M, N, 'fp32', g)
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    if t_bytes >= t_ops:
        got = _stream_plan(K, M, N, g, n_sm, t_ops >= CW8_FROM * t_bytes)
        if got is not None:
            return got
    return _tile_plan(K, M, N, g)


def stream_c(p: Dict, C) -> Tensor:
    """C as the stream kernel stages it in shared memory, (K, tmg, tm_pad):
    [k, mg, i] = C[k, mg tm + i], zero past M and past tm."""
    K, M = C.shape
    tm, tmg = p['tm'], p['tmg']
    cp = C.new_zeros(K, tmg, tm_pad(tm))
    full = C.new_zeros(K, tmg * tm)
    full[:, :M] = C
    cp[:, :, :tm] = full.view(K, tmg, tm)
    return cp


def walk(p: Dict, C, Z) -> Tensor:
    """The planned launch replayed on the CPU, block by block with the
    plan's tiles, offsets and padding (the kernels' sums in their order of
    k, as products of the staged pieces; bf16: of the pieces rounded to
    bf16); raises if a tile is visited twice or never."""
    g, K, N = Z.shape
    M = C.shape[1]
    out = torch.full((g, M, N), float('nan'), dtype=C.dtype)
    seen = torch.zeros(p['tiles'], dtype=torch.int64)
    if p['cls'] == 'bf16':
        bn, kc, P = p['bn'], p['kc'], p['grid'][0]
        ntn = -(-N // bn)
        for my in range(p['mtiles']):
            m0 = my * BF16_MT
            rows = min(BF16_MT, M - m0)
            # A: C^T of the block's rows, rounded, zero past M and past K
            a = C.new_zeros(16 * p['ks'], p['mp'])
            a[:K, :rows] = C[:, m0:m0 + rows].bfloat16().float()
            for b in range(P):
                for t in range(b, ntn * g, P):
                    seen[my * ntn * g + t] += 1
                    gi, n0 = t // ntn, (t % ntn) * bn
                    acc = C.new_zeros(p['mp'], bn)
                    for ch in range(p['nkc']):
                        k0 = ch * kc
                        kl = min(kc, K - k0)
                        kp = -(-kl // 16) * 16
                        # the landed piece, zero past kl and past N
                        piece = Z.new_zeros(kp, bn)
                        cols = min(bn, N - n0)
                        piece[:kl, :cols] = Z[gi, k0:k0 + kl, n0:n0 + cols]
                        acc += a[k0:k0 + kp].t() @ piece.bfloat16().float()
                    cols = min(bn, N - n0)
                    out[gi, m0:m0 + rows, n0:n0 + cols] = acc[:rows, :cols]
        assert bool((seen == 1).all()), 'a tile is walked twice or never'
        return out
    if p['cls'] == 'stream':
        bn, kc, P = p['bn'], p['kc'], p['grid'][0]
        c_s = stream_c(p, C)[:, :, :p['tm']].reshape(K, p['mp'])
        ntn = N // bn
        for b in range(P):
            for t in range(b, p['tiles'], P):
                seen[t] += 1
                gi, n0 = t // ntn, (t % ntn) * bn
                acc = C.new_zeros(p['mp'], bn)
                for ch in range(p['nkc']):
                    k0 = ch * kc
                    kl = min(kc, K - k0)
                    acc += c_s[k0:k0 + kl].t() @ Z[gi, k0:k0 + kl, n0:n0 + bn]
                out[gi, :, n0:n0 + bn] = acc[:M]
        assert bool((seen == 1).all()), 'a tile is walked twice or never'
        return out
    bm, bn, bk = TILE_BM, TILE_BN, TILE_BK
    gx, gy, gz = p['grid']
    Kp = p['nkc'] * bk
    a = C.new_zeros(Kp, gx * bm)
    a[:K, :M] = C
    for z in range(gz):
        zp = Z.new_zeros(Kp, N)
        zp[:K] = Z[z]
        for x in range(gx):
            for y in range(gy):
                seen[(z * gy + y) * gx + x] += 1
                acc = C.new_zeros(bm, bn)
                for kt in range(p['nkc']):
                    ks = slice(kt * bk, (kt + 1) * bk)
                    acc += a[ks, x * bm:(x + 1) * bm].t() @ \
                        zp[ks, y * bn:(y + 1) * bn]
                rows = min(bm, M - x * bm)
                out[z, x * bm:x * bm + rows, y * bn:(y + 1) * bn] = acc[:rows]
    assert bool((seen == 1).all()), 'a tile is walked twice or never'
    return out


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
CLS_ID = {'stream': 0, 'tile': 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load('bench_dot')
    lib.dot_fp32.argtypes = [_P, _P, _I, _I, _I, _L] + [_I] * 5 + [_L, _I,
                                                                  _P, _P]
    lib.dot_bf16.argtypes = [_P, _P, _I, _I, _I, _L] + [_I] * 5 + [_L, _I,
                                                                  _P, _P]
    for fn in (lib.dot_fp32, lib.dot_bf16):
        fn.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel(dtype: str, C, Z) -> Tensor:
    """Launch the dtype's kernel of csrc/bench_dot.cu (CUDA tensors only;
    N a multiple of 128; bf16: K <= 128)."""
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
    if dtype not in DTYPES:
        raise ValueError(dtype)
    out = torch.empty((g, M, N), dtype=C.dtype, device=C.device)
    ptrs = (ctypes.c_void_p(C.data_ptr()), ctypes.c_void_p(Z.data_ptr()),
            g, K, M, N)
    tail = (ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(C.device).cuda_stream))
    p = plan(K, M, N, g, _n_sm(C.device.index or 0), dtype)
    if dtype == 'fp32':
        err = _lib().dot_fp32(*ptrs, CLS_ID[p['cls']], p['tm'], p['cw'],
                              p['bn'], p['kc'], math.prod(p['grid']),
                              p['smem'], *tail)
    else:
        err = _lib().dot_bf16(*ptrs, p['ks'], p['nt8'], p['wn'], p['bn'],
                              p['kc'], p['grid'][0], p['smem'], *tail)
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
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('bench_dot'):
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    run()
    return 0


if __name__ == '__main__':
    sys.exit(main())
