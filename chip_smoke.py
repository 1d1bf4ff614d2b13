#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sevennet_exp_tpu_torch``) on
one NVIDIA GPU: the 7net-0 NVT MD path at 1,000 atoms (whole-array
convolutions, kernels ``fused_conv_fwd`` / ``fused_conv_bwd``, the
geometry-fused pair's template without the geometry) and at
97,336 atoms (chunked convolutions, the geometry-fused kernels
``fused_conv_geom_fwd`` / ``fused_conv_geom_bwd``), the 1k path with the
radial MLP on the half list (the external-weight kernels
``fused_conv_extw_fwd`` / ``fused_conv_extw_bwd``), and the single-point
calculator with stress (kernels 1-2 in their edge-row form, one output row
per edge: the edge pair ``fused_conv_edge_fwd`` / ``fused_conv_edge_bwd``),
then the
independently derived ``terms`` kernels (``fused_conv_terms_fwd`` /
``fused_conv_terms_bwd``) under 1k NPT, the other ensembles, the bare
tensor-product kernels (``fused_tp_fwd`` / ``fused_tp_bwd``), and the
six kernel micro-benchmarks (``tools/bench_pieces.py``,
``bench_cgmxu.py``, ``bench_dot.py``, ``bench_cg.py``, ``bench_layout.py``,
``bench_tile.py``, twenty-one kernels), and last the port's training:
fault C.1's routes on the card and ``train_v2`` at 7net-0 width, and at
the end Grimme D3 (``SevenNetD3Calculator``, ``MolecularDynamics(d3=...)``
at 1k and 97k) and the multi-cutoff, multi-modal and FCN-readout models.

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure raises, exits non-zero and prints no result):
  1. card name and power limit; TF32 off; build the CUDA kernels
     (csrc/*.cu, one nvcc per source, all started together; ptxas' report);
     per layer, the registers, local bytes and blocks an SM of kernels 1-2
     as launched (at least three forward and two backward blocks, no local
     memory), of their edge-row form, the edge pair (at least two each
     way, no local memory), and of the redesigned terms pair (both forms)
     and external-weight pair, each way (at most 128 registers, at least
     two blocks, no local memory);
  2. each kernel against its plain PyTorch version on the 1k path's real
     inputs (trained checkpoint; kernels 1-2 on all five layers, their pad
     rows' gradients exactly zero and a second launch bit-identical; the
     geom kernels on layers 0, 1 and 4 through the geometry-fused
     whole-array branch, so on the same grid): max abs error against the
     stated limit, median times, the bound;
  3. 1k energy and forces: kernel path against plain path; the
     geometry-fused branch against the default branch, with both times per
     force call; chunks of 96 atoms (a remainder chunk), geometry-fused
     and not, against the whole-array result;
  4. 1k NVT (300 K, 2 fs, rebuild every 20 steps): warm-up, then 200 timed
     steps with the launch counters reset just before them; every force
     call must have gone through 5 forward + 5 backward launches of
     kernels 1-2 and none of the geom kernels; prints the force calls of
     the timed steps (a stale chunk re-runs) and the cadence of every
     chunk over warm-up and timed steps (it drops onto a ladder when a
     chunk goes stale and climbs back to 20 when chunks are quiet);
  5. 97,336 atoms: engine start-up time; the geom kernels against their
     plain versions on one full chunk of a mid layer; energy and forces of
     the chunked kernel path against the chunked plain path, each kernel
     launch of the force call timed (ms a launch and share of the bound at
     layers 0, 1-3 and 4); peak memory;
  5b. fault C.4: the chunked convolution on the plain chain
     (``use_kernels=False``, every chunk under checkpointing): a 1k force
     call in chunks of 96 atoms and a 97k force call (a new engine with
     the switch, on phase 5's grid and positions) against the kernel path
     (F_TOL, E_TOL_PER_ATOM), no kernel launched; the 97k call's time and
     peak memory;
  6. 97k NVT, same settings: a 10-step warm-up (in which the engine
     settles its rebuild cadence), then 10 timed steps with the
     counters reset just before them; every force call must have launched
     5 x chunks geom forward and backward kernels and none of kernels 1-2;
  7. the external-weight kernels against their plain versions on the 1k
     path's real inputs with ``half_mlp`` (all five layers; pad rows of
     dxg, dsh and dweff exactly zero, a second launch bit-identical),
     median times, the bound;
  8. 1k energy and forces with ``half_mlp`` against the default kernel
     path; both force-call times in turns and both peak memories; then 100
     timed NVT steps with ``half_mlp``: every force call must have launched
     5 + 5 external-weight kernels and none of kernels 1-2;
  9. the calculator on the 1k cell and on a sheared, 2 % strained copy:
     the edge-row kernels against their plain versions on the call's real
     inputs (all five layers; the pad rows' outputs and gradients exactly
     zero, a second launch bit-identical); energy, forces and the six stress components
     through the kernels against the same calculator through the plain
     versions, the spread between two kernel runs (``index_add_`` adds by
     atomics), repeated calls timed after the first, 5 + 5 launches of the
     edge-row kernels per call and of no other kernel;
 10. the ``terms`` kernels against their plain versions and against kernels
     1-2, per layer, on the 1k grid's real inputs (``agg_d = 32``) and on
     the calculator's padded edge list (``agg_d = 0``); pad rows exactly
     zero (at ``agg_d = 0`` the outputs' too), a second launch
     bit-identical; the times of both pairs side by side;
 11. 1k energy, forces and stress of the engine's NPT potential
     (``_efs_fn``): ``cg_mode='terms'`` against ``'cmshared'`` and against
     the plain path, and the engine's stress against the calculator's;
 12. 1k NPT with ``cg_mode='terms'`` (300 K, 2 fs, 1 GPa, a short barostat
     time so that the cell moves in float32): warm-up, then 50 timed steps:
     5 + 5 launches of the terms kernels per force call and none of
     kernels 1-2, the volume below the start; then the same warm-up and 100
     steps each of ``npt_aniso`` and ``langevin`` with the default kernels:
     finite, mean temperature within 150-450 K (a 300 K draw on a
     near-perfect lattice halves at first, then the thermostat rings), the
     cell symmetrically strained;
 13. the bare tensor product: ``make_fused_tp`` driven through autograd on
     the five layers' specs at the 1k grid's rows (counters reset just
     before), then each kernel against its plain version, times, bound
     (the backward, redesigned, carries a ``status`` in the kernels line);
 14. the SASS of the three pairs of csrc/fused_conv_geom.cu (the geom
     kernels, kernels 1-2 and their edge-row form), 12 instances in each
     of its two builds (``fused_conv_geom``, run-time silu / tanh, and
     ``fused_conv_geom_ssp``, the shifted softplus), compiled together: no
     tensor-core and no local-memory opcode, and the silu / tanh instances
     at the SASS they had before the shifted softplus joined
     (``PARENT_GEOM_SASS``); the external-weight pair's four instances
     (the build ``fused_conv_geom_extw``: the backward at 4, 9, 16 SH, at
     the SASS of its redesign, ``EXTW_BWD_SASS``, and the forward), the
     terms pair's four (at the SASS they had before the bare TP's backward
     was redesigned, ``TERMS_SASS``) and ``bench_pieces``' six (the same
     source built with its stub mask; checked in phase 15), compiled with
     them: no tensor-core and no local-memory opcode; ``fused_tp``: the
     forward at ``TP_FWD_SASS``, the backward's 32 instances with no
     tensor-core or local-memory opcode; the entries of the twelve
     kernels above (the six kernels, the edge-row form of kernels 1-2, the
     terms pair and the tensor-product pair);
 15. the micro-benchmarks at their default sizes through their entry
     points (``bench_cgmxu`` at i1 = 1 and 2), every counter reset just
     before: each prints its times and (``bench_pieces``) its piece costs;
     the redesigned bf16 ``bench_dot``, ``outer``, ``st``, ``bench_cg``
     c, ``bench_layout`` transpose and ``bench_tile`` b and c kernels carry
     a ``status`` in the kernels line;
     then each of the twenty-one kernels against its plain version on the
     tool's inputs (``bench_pieces``: ``full`` is kernel 1 and ``-agg`` the
     edge-row kernel 1, by their SASS digests (``PARENT_GEOM_SASS``) and
     their outputs against those kernels' on the same inputs, none with
     local memory, the other four at kernel 1's blocks an SM, each variant
     timed beside its production kernel in turns;
     bf16 ``bench_dot`` against the fp32 product of the rounded inputs,
     1e-5 x K x max|plain|; ``bench_layout`` row-major against transpose,
     ``bench_tile`` a, b and c against d within 1e-3), plain and library
     times, bounds, and for every ``bench_dot`` shape and both dots
     classes the share of the bound and the time over the library call's;
     the SASS of ``bench_layout`` and ``bench_tile`` must issue every
     repeated pass (cuobjdump: 24 x 16 FFMA per output, and 8 x 4 per
     output, the fifth product of each pass being the FMUL that starts
     it; ``bench_tile`` c 8 x 24 with its tiling product, b each pass's
     whole tiled row stored to shared memory and its 5 columns loaded
     back, >= 160 bytes each way a lane and row), each dots and outer
     instance d3tot x K FFMA per column a thread owns, each st instance
     every multiply of its dense tables and products (FFMA + FMUL), c its
     tiling product as HMMA.1688.F32.TF32 (outer, st, c, ``bench_tile`` b
     and c and the bf16 ``bench_dot`` instances nothing in local memory,
     the bf16 ones HMMA), the fp32 ``bench_dot`` kernels no tensor-core
     opcode, and those, the dots kernels, ``bench_cg``'s a
     and b, ``bench_layout``'s row- and col-major kernels and
     ``bench_tile``'s d and a the SASS they had before the kernels beside
     them were redesigned (``PARENT_MICRO_SASS``), no ``bench_layout``
     kernel anything in local memory; st (i1 = 1, 2) and c also against
     their plain versions on a ragged E (1,184 and 1,003 rows), c within
     1e-4 of a there; ``bench_tile`` b and c on E = 1, 7, 100, 1,003 and
     32,773 against their plain versions and within 1e-3 of d (c also
     with T altered, which must move its output);
 16. fault C.1 on the card: a tiny model with hidden [32, 32] routes every
     conv to the plain chain, launches no conv kernel and gives the CPU's
     E/F; a 1x1o+1x0e filter layer is refused and matches the CPU; a tiny
     ssp model routes to the kernels, whose shifted-softplus build (its
     dense, edge and geom pairs) and the terms pair's ssp branch match
     their plain versions. Then training: ``train_v2`` on ``trained_nacl/input.yaml``
     (7net-0 width, ``nacl_classical_data/``, batch 8, one epoch: 47 train
     steps, 6 valid batches) in a temporary dir, after the first step's
     loss and gradients on the card against the CPU (same parameters and
     batch); ms a step after the first, peak memory, the epoch's RMSEs;
     the loss falls, no conv kernel launches, and ``checkpoint_last``
     reloads in the calculator on the card; three more steps traced
     (device kernel time, idle share, launches, top kernels);
 17. the D3 overlay and the model's other forms, at full width: (a)
     ``SevenNetD3Calculator`` (``damp_bj``, ``pbe``, rthr 9000, cn_thr
     1600, on the card by default) on the 1k NaCl through the kernels
     against the same call with ``use_kernels=False`` and against
     ``SevenNetCalculator`` + ``D3Calculator`` summed, 5 + 5 launches of
     the edge-row kernels 1-2 a call, ms a call; (b) 1k NVT with ``d3=`` on
     the dense grid: the engine's first E/F against (a), 40 timed steps
     with and 40 without D3 in the same call, 5 + 5 launches of kernels 1-2
     a force call; (c) one 97,336-atom chunked force call with ``d3=``
     (the tiled minimum-image sweep, its cell past the guard's 2 r_vdw)
     against the model alone plus the tiled D3 by autograd, 5 x chunks
     launches of the geom pair, its ms and peak memory; (d) trained_nacl's
     config with per-layer cutoffs [5.0, 5.0, 4.5, 4.5, 4.0], with two
     modalities and ``multi_modal.yaml``'s modal flags, and with the FCN
     readout, weights from a seed: each layer's route (multi-cutoff and
     FCN: the kernels, the modal convolutions without si2: the plain
     chain), the 1k calculator through the kernels against
     ``use_kernels=False`` (5 + 5 edge-row launches a call, none for the
     modal model), 216 atoms on the card against the CPU, and the
     multi-cutoff model's 1k engine force call through kernels 1-2 (5 + 5
     launches, no geom kernel) against the plain chain;
 then a ``{"kernels": [...]}`` line (33 entries), the card line and the
 result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package. Details go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(HERE, 'trained_nacl', 'checkpoint_best.pth.sevennet')

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain version: max abs error <= REL_TOL * max|plain| (fp32,
# different summation order over up to ~26 rows x 256 products)
REL_TOL = 1e-4
# energy/forces of one path against another on the card
F_TOL = 1e-3           # eV/A
E_TOL_PER_ATOM = 1e-5  # eV/atom
S_TOL = 1e-5           # eV/A^3, each of the six stress components

N_LARGE = 97336        # 8 x 23^3: the large leg
# SASS digests of csrc/fused_conv_geom.cu's run-time-activation instances
# (silu, tanh) by (pair, label), before the shifted softplus joined the
# source (tests/test_torch_cuda.py holds them too)
PARENT_GEOM_SASS = {
    ('dense', 'fwd'): 'ed74768ed1fc', ('dense', 'bwd4'): 'c79437837836',
    ('dense', 'bwd9'): '28421c2cd7d5', ('dense', 'bwd16'): '5128e637db46',
    ('geom', 'fwd'): '282ef8d7e2ab', ('geom', 'bwd4'): '9eca060d6abd',
    ('geom', 'bwd9'): '4fded89d1077', ('geom', 'bwd16'): 'daa9f3ecb780',
    ('edge', 'fwd'): '1bd8cca68cf4', ('edge', 'bwd4'): '2b2ea3b3dae0',
    ('edge', 'bwd9'): '785447e4d5fa', ('edge', 'bwd16'): '3d5b2d34c0c5',
}

# SASS digests of the external-weight backward's three instances (16, 9, 4
# SH) as redesigned, before the external-weight forward joined its build
# (tests/test_torch_cuda.py holds them too)
EXTW_BWD_SASS = ('5455282fa6b2', '9fa855366a9d', 'd8cf526f5ab8')

# SASS digests of the kernels beside the redesigned bare-TP backward and
# layout transpose, as they were before them: the bare TP's forward (row 9),
# the terms pair's four instances (rows 3-4), bench_layout's row- and
# col-major kernels (tests/test_torch_cuda.py holds them too)
TP_FWD_SASS = ('f27695869423',)
TERMS_SASS = ('58069b73147a', '90e5aa393ecc', 'caa01d830e0d', 'dc6feb1dee3b')
LAYOUT_SASS = ('e39d08c7e3a2', '251bf32cd9a4')

# SASS digests of bench_tile's d and a, as they were before b and c were
# redesigned for Hopper
TILE_SASS = ('93cfa8d49dbf', '08b3263bc8c0')

# SASS digests of the micro-benchmark kernels beside the redesigned ones
# (the fp32 bench_dot kernels, bench_cgmxu's dots, bench_cg's a and b,
# bench_layout's row- and col-major, bench_tile's d and a), as they were
# before the kernels beside them were redesigned for Hopper, by the
# kernel-name stems they are read under (tests/test_torch_cuda.py holds
# them too)
PARENT_MICRO_SASS = {
    'bench_dot': ('4539c5e9a7f6', '43900b2b462c', 'cffb86f3b49f',
                  '40053fb204ef', 'e6250dfce0f8', 'e61ab816330d',
                  '24ccc4e63ba3', '24a040861ee6', '20ebae4a7d96',
                  '5d330983afe7', '2cde1487ece9'),
    'bench_cgmxu': ('5e3d3e051d91', '40b05ac7fb83', '73a9cda46545'),
    'bench_cg': ('a450a1e2efb4', '09bc131a86bb'),
    'bench_layout': LAYOUT_SASS,
    'bench_tile': TILE_SASS,
}
MICRO_SASS_STEMS = {'bench_dot': ('dot_fp32_',),
                    'bench_cgmxu': ('cgmxu_dots_',),
                    'bench_cg': ('cg_a_', 'cg_b_'),
                    'bench_layout': ('layout_rowmajor', 'layout_colmajor'),
                    'bench_tile': ('tile_d_kernel', 'tile_a_kernel')}

# the micro-benchmark kernels redesigned for Hopper: their status in the
# kernels line
REDESIGNED = {
    'bench_dot_bf16': 'redesigned for Hopper: csrc/bench_dot.cu::'
                      'dot_bf16_kernel<KS, NT8>, a persistent grid over the '
                      'N tiles of all of M (Z read once), C^T rounded once '
                      'into mma.sync A fragments held in registers, Z through '
                      'a 4- or 8-stage cp.async ring rounded once a piece and '
                      'read by ldmatrix.trans, full-line streaming stores',
    'bench_cgmxu_outer': 'redesigned for Hopper: csrc/bench_cgmxu.cu::'
                         'cgmxu_outer_kernel<D1, F, D3>, the class at compile '
                         'time, 4 edges a thread, Z built in registers, C as '
                         'LDS.128 broadcasts in the loop\'s order, the weight '
                         'fused, 512-byte streaming stores a warp',
    'bench_cgmxu_st': 'redesigned for Hopper: csrc/bench_cgmxu.cu::'
                      'cgmxu_st_kernel<D1, F, D3>, the class and its '
                      'instruction list at compile time, 4 edges a thread, '
                      'the tables staged in loop order as LDS.128 '
                      'broadcasts, S and the products in registers, the '
                      'weight fused, 512-byte streaming stores a warp',
    'bench_layout_transpose': 'redesigned for Hopper: csrc/bench_layout.cu::'
                              'layout_transpose_kernel, one persistent block '
                              'an SM over 32-row tiles, a 5-stage cp.async '
                              'ring of 32 KB pieces (a tile in flight while '
                              'the passes run), conflict-free '
                              'diagonal reads, the output tile as whole '
                              '128-byte lines',
    'bench_cg_c': 'redesigned for Hopper: csrc/bench_cg.cu::cg_c_kernel, '
                  'the tiling product St = S @ T on the tensor cores '
                  '(mma.sync m16n8k8 TF32, S in three TF32 pieces: exact '
                  'against T\'s 0/1; the pieces of S\'s column 24 in one k8 '
                  'step), St in the accumulators, the sum over m in '
                  'registers, x by 16-byte cp.async under the previous '
                  'tile\'s mma, out as whole 32-byte sectors',
    'bench_tile_b': 'redesigned for Hopper: csrc/bench_tile.cu::'
                    'tile_b_kernel, a persistent grid of warps (48 an SM) '
                    'walking the rows, the next row\'s x (evict-first) and s '
                    'loads in flight under a row\'s passes; each pass still '
                    'writes the whole tiled row to shared memory (a 16-byte '
                    'and a 4-byte store a lane) and reads its 5 columns back, '
                    'conflict-free, into one of two staging rows a warp '
                    'alternating by pass (one __syncwarp a pass)',
    'bench_tile_c': 'redesigned for Hopper: csrc/bench_tile.cu::'
                    'tile_c_kernel, a half-warp a row (each lane on two '
                    'channels, so it forms each s (1 + r) once for two '
                    'columns) on a persistent grid of row pairs, 8 warps an '
                    'SM at 184 registers, the next pair\'s x and s loads in '
                    'flight under a pair\'s passes; each lane reads its 50 '
                    'entries of T from device memory into registers once (no '
                    'block barrier before the first x loads) and every pass '
                    'forms its tiled row as (s (1 + r)) @ T',
}

MD_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
             rebuild_every=20, seed=0)


# (phase, its start on the host clock): the seconds of each phase
_PHASES = []


def phase(name):
    _PHASES.append((name, time.perf_counter()))
    print(f'== {name}', flush=True)


def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
    t_ops = flops / peak * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), 'operations' if t_ops >= t_mem else 'bytes'


def check_close(what, got, ref):
    """max abs error of got against ref, held to REL_TOL * max|ref|."""
    err = float((got - ref).abs().max())
    lim = REL_TOL * float(ref.abs().max())
    if not (err <= lim and math.isfinite(err)):
        raise AssertionError(f'{what}: |err| {err:.3e} > {lim:.3e}')
    return err, lim


def check_ef(what, n, e_a, f_a, e_b, f_b):
    d_f = float((f_a - f_b).abs().max())
    d_e = abs(float(e_a) - float(e_b)) / n
    print(f'{what}: E {float(e_a):.6f} vs {float(e_b):.6f} eV; |dE|/N '
          f'{d_e:.3e} eV/atom (<= {E_TOL_PER_ATOM}); max|dF| {d_f:.3e} eV/A '
          f'(<= {F_TOL})', flush=True)
    if not (d_f <= F_TOL and d_e <= E_TOL_PER_ATOM):
        raise AssertionError(f'{what}: paths disagree')
    import torch
    if not (torch.isfinite(f_a).all() and torch.isfinite(f_b).all()):
        raise AssertionError(f'{what}: non-finite forces')
    return {'dE_per_atom': d_e, 'max_dF': d_f, 'energy': float(e_a),
            'energy_other': float(e_b)}


def micro_benchmarks(report, dev, cuda_ms, show, pieces_sass):
    """Phase 15: the six micro-benchmark tools at their default sizes, run
    through their entry points with every launch counter at 0 before them;
    then each kernel against its plain version on the tool's own inputs
    (bench_pieces: ``full`` against kernel 1 and ``-agg`` against the
    edge-row kernel 1 at REL_TOL and at those kernels' SASS digests, from
    pieces_sass, phase 14's (opcode counts, digests) of the build; each
    variant timed beside the kernel it is or stubs), the plain and the
    library times, the bounds, and the static FFMA counts of bench_layout's
    and bench_tile's kernels. Returns the kernels' entries."""
    import torch
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import (bench_cg, bench_cgmxu,
                                              bench_dot, bench_layout,
                                              bench_pieces, bench_tile,
                                              sass_compare)
    t0 = time.perf_counter()
    dot_rows = {}

    def dot_check(shape, dtype, C, Z, out):
        """bench_dot's first launch of each shape and type against the
        plain version (fp32: 1e-4 max|plain|; bf16: the fp32 product of
        the rounded inputs, 1e-5 K max|plain|); the outputs are not kept."""
        ref = bench_dot.plain(dtype, C, Z)
        err = float((out - ref).abs().max())
        lim = (REL_TOL if dtype == 'fp32' else 1e-5 * shape[0]) * float(
            ref.abs().max())
        if not (err <= lim and math.isfinite(err)):
            raise AssertionError(f'bench_dot {shape} {dtype}: |err| '
                                 f'{err:.3e} > {lim:.3e}')
        plain_ms = cuda_ms(lambda: bench_dot.plain(dtype, C, Z), reps=2,
                           batches=1, warm=1)
        dot_rows[(shape, dtype)] = {'err': err, 'lim': lim,
                                    'plain_ms': plain_ms}

    cuda_build.reset_launch_counts()
    pieces = bench_pieces.run()
    cgmxu = {i1: bench_cgmxu.run(i1) for i1 in (1, 2)}
    dots = bench_dot.run(reps=10, check=dot_check)
    cgs = bench_cg.run()
    lay = bench_layout.run()
    tile = bench_tile.run()
    torch.cuda.synchronize()
    launches = dict(cuda_build.launch_counts)
    other = {k: v for k, v in launches.items()
             if v and k not in cuda_build.BENCH_KERNELS}
    if other:
        raise AssertionError(f'the micro-benchmarks launched {other}')
    run_s = time.perf_counter() - t0
    kernels, rows = [], []

    def entry(name, source, line, errs, ms, plain_ms, cost, library_ms,
              peak=PEAK_FP32_FLOPS):
        """cost: [(flops, bytes)] of the launches ms sums over."""
        b_ms = sum(bound(f, b, peak)[0] for f, b in cost)
        t_ops = sum(f for f, _ in cost) / peak
        t_mem = sum(b for _, b in cost) / PEAK_BYTES
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'sevennet_exp_tpu_torch/csrc/{source}',
            **({'status': REDESIGNED[name]} if name in REDESIGNED else {}),
            'replaces': f'tools/{line}',
            'launches': launches[name], 'max_abs_err': max(errs),
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
            'bound_by': 'operations' if t_ops >= t_mem else 'bytes',
            'library_ms': library_ms})
        show(kernels[-1])

    # bench_pieces: one launch of each variant on E = 32,768 rows. full is
    # kernel 1 and -agg the edge-row kernel 1 (their SASS, their outputs on
    # the same inputs); the other four stub one piece of kernel 1 and keep
    # its launch (no local memory, its blocks an SM)
    conv, ins = pieces['conv'], pieces['inputs']
    E = ins[0].shape[0]
    counts, digests = pieces_sass
    by_variant = {bench_pieces.variant_of(k): (counts[k], digests[k])
                  for k in counts}
    if set(by_variant) != set(bench_pieces.VARIANTS):
        raise AssertionError(f'bench_pieces build: {sorted(counts)}')
    production = {'full': (('dense', 'fwd'), conv),
                  '-agg': (('edge', 'fwd'), bench_pieces.edge_conv(conv))}
    same = {}
    for v, (key, other) in production.items():
        ref = other.kernel_forward(*ins)
        torch.cuda.synchronize()
        err = check_close(f'bench_pieces {v} vs {key[0]} kernel 1',
                          pieces['out'][v], ref)[0]
        same[v] = bool(torch.equal(pieces['out'][v], ref))
        print(f'bench_pieces {v} vs the {key[0]} kernel 1: |err| {err:.3e}, '
              f'bit-identical {same[v]}; SASS digest {by_variant[v][1]} (the '
              f'{key[0]} forward: {PARENT_GEOM_SASS[key]})', flush=True)
        if by_variant[v][1] != PARENT_GEOM_SASS[key]:
            raise AssertionError(f'bench_pieces {v} is not the {key[0]} '
                                 'kernel 1')
        del ref
    # the stubbed four at kernel 1's blocks an SM (its shared bytes), -agg
    # at the edge forward's two
    res = {v: bench_pieces.resources(conv, v, E, dev)
           for v in bench_pieces.VARIANTS}
    for v in bench_pieces.VARIANTS:
        c, r = by_variant[v][0], res[v]
        bad = {op: c[op] for op in (*sass_compare.TENSOR_CORE_OPS,
                                    *sass_compare.LOCAL_OPS) if c[op]}
        print(f'bench_pieces {v}: {r.registers} registers, {r.local_bytes} '
              f'local bytes, {r.blocks_per_sm} blocks an SM at {r.smem} '
              f'shared bytes; SASS {by_variant[v][1]} {c}', flush=True)
        want = 2 if v == '-agg' else res['full'].blocks_per_sm
        if bad or r.local_bytes or r.blocks_per_sm < want:
            raise AssertionError(f'bench_pieces {v}: {r}, opcodes {bad}')
    prod = bench_pieces.production_ms(pieces)
    for v in bench_pieces.VARIANTS:
        ref = bench_pieces.plain_variant(conv, v, *ins)
        err, lim = check_close(f'bench_pieces {v}', pieces['out'][v], ref)
        plain_ms = cuda_ms(lambda: bench_pieces.plain_variant(conv, v, *ins),
                           reps=1, batches=1, warm=1)
        cost = bench_pieces.variant_cost(conv, ins[3], v)
        rows.append({'tool': 'bench_pieces', 'variant': v,
                     'ms': pieces['ms'][v], 'piece_ns_per_row':
                     pieces['piece_ns'].get(v), 'err': err, 'lim': lim,
                     'plain_ms': plain_ms, 'flops': cost[0],
                     'bytes': cost[1], 'sass': by_variant[v][1],
                     'bit_identical': same.get(v), **res[v]._asdict(),
                     **prod[v]})
        entry(bench_pieces.COUNTER[v], 'fused_conv_geom.cu',
              'bench_pieces.py:232', [err], pieces['ms'][v], plain_ms,
              [cost], None)
    del pieces, conv, ins
    # static opcode counts of each kernel's SASS (its loops fully unrolled):
    # the repeated passes of bench_layout and bench_tile and the dense
    # products of the dots and outer instances must all be issued, the fp32
    # dot kernels must use no tensor-core opcode and the bf16 ones must,
    # the redesigned kernels nothing in local memory; the kernels beside
    # them keep the SASS they had before (PARENT_MICRO_SASS)
    builds = sass_compare.count_and_digests(
        ('bench_cgmxu', 'bench_dot', 'bench_cg', 'bench_layout',
         'bench_tile'), texts=True)
    sass = {name: counts for name, (counts, _, _) in builds.items()}
    for name, stems in MICRO_SASS_STEMS.items():
        got = sorted(v for k, v in builds[name][1].items()
                     if any(stem in k for stem in stems))
        print(f'{name} {stems}: SASS digests {got} (before: '
              f'{sorted(PARENT_MICRO_SASS[name])})', flush=True)
        if got != sorted(PARENT_MICRO_SASS[name]):
            raise AssertionError(f'{name} {stems}: SASS moved')
    report['micro_sass_digests'] = {name: d for name, (_, d, _) in
                                    builds.items()}

    def sass_of(name, stem, want):
        """The kernel's static opcode counts; its FFMAs must cover every
        multiply-add of its outputs (want)."""
        (counts,) = [v for k, v in sass[name].items() if stem in k]
        print(f'{stem}: SASS {counts} (want >= {want} FFMA)', flush=True)
        if counts['FFMA'] < want:
            raise AssertionError(f'{stem}: {counts["FFMA"]} FFMA in its '
                                 f'SASS, fewer than {want}')
        return counts
    # dots: d3tot K FFMA per column a thread owns, in each instance
    dots_sass = {f'{K}x{d3}': sass_of(
        'bench_cgmxu', f'cgmxu_dots_kernelILi{K}ELi{d3}E',
        d3 * K * bench_cgmxu.DOTS_EDGES)
        for K, d3 in bench_cgmxu.DOTS_SHAPES}
    # outer: every multiply-add of the dense d3tot x d1 f product per
    # column a thread owns, nothing in local memory
    outer_sass = {}
    for d1, f, d3 in bench_cgmxu.OUTER_SHAPES:
        c = outer_sass[f'{d1}x{f}x{d3}'] = sass_of(
            'bench_cgmxu', f'cgmxu_outer_kernelILi{d1}ELi{f}ELi{d3}E',
            d1 * f * d3 * bench_cgmxu.DOTS_EDGES)
        if any(c[op] for op in sass_compare.LOCAL_OPS):
            raise AssertionError(f'outer {d1}x{f}x{d3}: local memory {c}')
    # st: every multiply-add of its dense tables and products per column a
    # thread owns (the first of each sum an FMUL), nothing in local memory
    st_sass = {}
    for (d1, f, d3), ins in bench_cgmxu.ST_CLASSES.items():
        want = bench_cgmxu.DOTS_EDGES * sum(
            d3k * d1 * (d2 + 1) for _, d2, d3k in ins)
        (c,) = [v for k, v in sass['bench_cgmxu'].items()
                if f'cgmxu_st_kernelILi{d1}ELi{f}ELi{d3}E' in k]
        st_sass[f'{d1}x{f}x{d3}'] = c
        print(f'st {d1}x{f}x{d3}: SASS {c} (want FFMA + FMUL >= {want})',
              flush=True)
        if c['FFMA'] + c['FMUL'] < want or any(c[op] for op in
                                               sass_compare.LOCAL_OPS):
            raise AssertionError(f'st {d1}x{f}x{d3}: {c}')
    # c: the tiling product as HMMA.1688.F32.TF32 (three k8 steps a piece
    # and column 24's step, five m a step), nothing in local memory
    (cg_c_name,) = [k for k in sass['bench_cg'] if 'cg_c_kernel' in k]
    cg_c_sass = dict(sass['bench_cg'][cg_c_name])
    cg_c_sass['HMMA.1688.F32.TF32'] = builds['bench_cg'][2][
        cg_c_name].count('HMMA.1688.F32.TF32')
    print(f'bench_cg c: SASS {cg_c_sass}', flush=True)
    if (cg_c_sass['HMMA.1688.F32.TF32'] < 50 or any(
            cg_c_sass[op] for op in sass_compare.LOCAL_OPS)):
        raise AssertionError(f'bench_cg c: {cg_c_sass}')
    # bf16 dot: mma.sync (HMMA) in every instance, nothing in local memory
    bf16_sass = {k: v for k, v in sass['bench_dot'].items()
                 if 'dot_bf16_' in k}
    for k, v in bf16_sass.items():
        if not v['HMMA'] or any(v[op] for op in sass_compare.LOCAL_OPS):
            raise AssertionError(f'bench_dot bf16 kernel {k}: {v}')
    if len(bf16_sass) != len(bench_dot.BF16_KS) * 2:
        raise AssertionError(f'bench_dot: {len(bf16_sass)} bf16 instances')
    print(f'bench_dot bf16: {len(bf16_sass)} kernels, HMMA '
          f'{sorted(v["HMMA"] for v in bf16_sass.values())}, no LDL/STL',
          flush=True)
    # fp32 dot: FFMA on the CUDA cores, no tensor-core opcode
    dot_sass = {k: v for k, v in sass['bench_dot'].items()
                if 'dot_fp32_' in k}
    for k, v in dot_sass.items():
        tc = {op: v[op] for op in sass_compare.TENSOR_CORE_OPS if v[op]}
        if tc or not v['FFMA']:
            raise AssertionError(f'bench_dot fp32 kernel {k}: tensor-core '
                                 f'opcodes {tc}, {v["FFMA"]} FFMA')
    print(f'bench_dot fp32: {len(dot_sass)} kernels, no tensor-core opcode; '
          f'FFMA {sorted(v["FFMA"] for v in dot_sass.values())}', flush=True)
    # bench_cgmxu: one launch of each mode at i1 = 1 and at i1 = 2
    for mode in bench_cgmxu.MODES:
        errs, ms, plain_ms, cost, lib_ms = [], 0.0, 0.0, [], 0.0
        for i1, res in cgmxu.items():
            cls, ins = res['cls'], res['inputs']
            ref = bench_cgmxu.plain(cls, mode, *ins)
            err, lim = check_close(f'bench_cgmxu {i1} {mode}',
                                   res['out'][mode], ref)
            lib_row = {}
            if mode != 'dots':
                # one einsum of C, x, sh and the weight gathered per row
                # (outside the timed window)
                wg = bench_cgmxu.gathered_weight(cls, ins[2])
                lib_row['library_err'] = check_close(
                    f'bench_cgmxu {i1} einsum', bench_cgmxu.library(
                        cls, ins[0], ins[1], wg), ref)[0]
                lib_row['library_ms'] = cuda_ms(
                    lambda: bench_cgmxu.library(cls, ins[0], ins[1], wg),
                    reps=5)
                lib_ms += lib_row['library_ms']
                del wg
            del ref
            p_ms = cuda_ms(lambda: bench_cgmxu.plain(cls, mode, *ins),
                           reps=2, batches=1, warm=1)
            E = ins[0].shape[1]
            c = bench_cgmxu.cost(cls, mode, E)
            row = {'tool': 'bench_cgmxu', 'i1': i1, 'mode': mode,
                   'ms': res['ms'][mode], 'ns_per_row':
                   res['ms'][mode] / E * 1e6, 'err': err, 'lim': lim,
                   'oracle_err': res['oracle_err'].get(mode),
                   'plain_ms': p_ms, 'flops': c[0], 'bytes': c[1],
                   'formulation_flops':
                   bench_cgmxu.formulation_flops(cls, mode, E),
                   'bound_ms': bound(*c)[0], **lib_row}
            if mode == 'dots':
                C = torch.as_tensor(cls.C, device=dev)
                Z = bench_cgmxu.outer_z(cls, ins[0], ins[1]).contiguous()
                row['library_ms'] = cuda_ms(lambda: torch.matmul(C, Z),
                                            reps=5)
                lib_ms += row['library_ms']
                del Z
                K = cls.d1 * cls.f
                row.update(share_of_bound=row['bound_ms'] / row['ms'],
                           vs_library=row['ms'] / row['library_ms'],
                           sass=dots_sass[f'{K}x{cls.d3tot}'])
                print(f'bench_cgmxu dots i1={i1}: {row["ms"]:.4f} ms, '
                      f'bound {row["bound_ms"]:.4f} ms '
                      f'({row["share_of_bound"]:.1%}), torch.matmul '
                      f'{row["library_ms"]:.4f} ms (x{row["vs_library"]:.2f})',
                      flush=True)
            if mode in ('outer', 'st'):
                key = f'{cls.d1}x{cls.f}x{cls.d3tot}'
                row.update(share_of_bound=row['bound_ms'] / row['ms'],
                           sass=(outer_sass if mode == 'outer'
                                 else st_sass)[key])
                print(f'bench_cgmxu {mode} i1={i1}: {row["ms"]:.4f} ms, '
                      f'bound {row["bound_ms"]:.4f} ms '
                      f'({row["share_of_bound"]:.1%})', flush=True)
            if mode == 'st':
                # a ragged E (a multiple of 32, not of 128), outside the
                # counted run
                rag = bench_cgmxu.make_inputs(cls, 32 * 37, dev, seed=i1)
                row['ragged_err'], _ = check_close(
                    f'bench_cgmxu {i1} st, E = {32 * 37}',
                    bench_cgmxu.forward(cls, 'st', *rag),
                    bench_cgmxu.plain(cls, 'st', *rag))
                del rag
            rows.append(row)
            errs.append(err)
            ms += res['ms'][mode]
            plain_ms += p_ms
            cost.append(c)
        entry(bench_cgmxu.COUNTER[mode], 'bench_cgmxu.cu',
              'bench_cgmxu.py:166', errs, ms, plain_ms, cost, lib_ms)
    del cgmxu
    # bench_dot: one launch of each of the ten shapes per type
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for dtype in bench_dot.DTYPES:
        peak = bench_dot.cost(*bench_dot.SHAPES[0], dtype)[2]
        cost = [bench_dot.cost(*shape, dtype)[:2] for shape in dots]
        for shape in dots:
            ms = dots[shape][dtype]
            b_ms, by = bound(*bench_dot.cost(*shape, dtype)[:2], peak)
            lib = dots[shape]['cublas_fp32'] if dtype == 'fp32' else None
            p = bench_dot.plan(*shape, bench_dot.G, n_sm, dtype)
            rows.append({'tool': 'bench_dot', 'shape': list(shape),
                         'dtype': dtype, 'ms': ms,
                         'cublas_fp32_ms': dots[shape]['cublas_fp32'],
                         'cublas_bf16_ms': dots[shape]['cublas_bf16'],
                         **dot_rows[(shape, dtype)],
                         'bound_ms': b_ms, 'bound_by': by,
                         'share_of_bound': b_ms / ms,
                         'vs_library': ms / lib if lib else None,
                         'vs_fp32': ms / dots[shape]['fp32'],
                         'plan': p})
            print(f'bench_dot {shape} {dtype}: {ms:.4f} ms, bound '
                  f'{b_ms:.4f} ms by {by} ({b_ms / ms:.1%})'
                  + (f', torch.bmm {lib:.4f} ms (x{ms / lib:.2f}), '
                     f'{p["cls"]} tm={p["tm"]} bn={p["bn"]} kc={p["kc"]}'
                     if lib else
                     f', fp32 x{ms / dots[shape]["fp32"]:.2f}, cuBLAS on '
                     f'bf16 inputs {dots[shape]["cublas_bf16"]:.4f} ms, '
                     f'ks={p["ks"]} strips={p["strips"]} bn={p["bn"]} '
                     f'kc={p["kc"]}'), flush=True)
        entry(bench_dot.COUNTER[dtype], 'bench_dot.cu', 'bench_dot.py:46',
              [dot_rows[(s, dtype)]['err'] for s in dots],
              sum(dots[s][dtype] for s in dots),
              sum(dot_rows[(s, dtype)]['plain_ms'] for s in dots), cost,
              sum(dots[s]['cublas_fp32'] for s in dots)
              if dtype == 'fp32' else None, peak)
    # bench_cg: one launch of each formulation on E = 32,768 rows; the
    # library time is one einsum of the instruction on the same x and y
    x, y = cgs['inputs']
    c = bench_cg.cost(x.shape[0])
    lib_err, _ = check_close('bench_cg einsum', bench_cg.library(x, y),
                             bench_cg.plain(bench_cg.VARIANTS[0], x, y))
    lib_ms = cuda_ms(lambda: bench_cg.library(x, y), reps=5)
    print(f'bench_cg einsum: {lib_ms:.4f} ms (|err| vs plain a '
          f'{lib_err:.3e})', flush=True)
    for v in bench_cg.VARIANTS:
        ref = bench_cg.plain(v, x, y)
        err, lim = check_close(f'bench_cg {v}', cgs['out'][v], ref)
        p_ms = cuda_ms(lambda: bench_cg.plain(v, x, y), reps=2, batches=1,
                       warm=1)
        rows.append({'tool': 'bench_cg', 'variant': v, 'ms': cgs['ms'][v],
                     'err': err, 'lim': lim, 'cross_err':
                     cgs['cross_err'].get(v), 'plain_ms': p_ms,
                     'library_ms': lib_ms, 'flops': c[0], 'bytes': c[1],
                     'formulation_flops':
                     bench_cg.formulation_flops(v, x.shape[0]),
                     'bound_ms': bound(*c)[0]})
        if v == 'c:full-width':
            # a ragged E (the last 16-row tile part full), outside the
            # counted run, against plain c and within 1e-4 of a
            xr, yr = bench_cg.make_inputs(1003, dev, seed=3)
            got = bench_cg.forward(v, xr, yr)
            rows[-1]['ragged_err'], _ = check_close(
                f'bench_cg {v}, E = 1003', got, bench_cg.plain(v, xr, yr))
            rows[-1]['ragged_vs_a'] = float(
                (got - bench_cg.plain(bench_cg.VARIANTS[0], xr, yr))
                .abs().max())
            if not rows[-1]['ragged_vs_a'] < bench_cg.CROSS_TOL:
                raise AssertionError(f'bench_cg c vs a at E = 1003: '
                                     f'{rows[-1]["ragged_vs_a"]:.3e}')
            rows[-1].update(sass=cg_c_sass,
                            share_of_bound=rows[-1]['bound_ms'] / cgs['ms'][v])
            print(f'bench_cg c: {cgs["ms"][v]:.4f} ms, bound '
                  f'{rows[-1]["bound_ms"]:.4f} ms '
                  f'({rows[-1]["share_of_bound"]:.1%}); ragged E = 1003 '
                  f'|err| {rows[-1]["ragged_err"]:.3e}, vs a '
                  f'{rows[-1]["ragged_vs_a"]:.3e}', flush=True)
            del xr, yr, got
        entry(bench_cg.COUNTER[v], 'bench_cg.cu', 'bench_cg.py:99', [err],
              cgs['ms'][v], p_ms, [c], lib_ms)
    del cgs, x, y
    # bench_layout: one launch of each layout on the tool's (32768, 512)
    # inputs; the library time is one einsum pass on the same inputs
    c = bench_layout.cost()
    cross, _ = check_close('bench_layout transpose vs rowmajor',
                           lay['out']['transpose'], lay['out']['rowmajor'])
    for v in bench_layout.VARIANTS:
        ins = lay['inputs'][v]
        ref = bench_layout.plain(v, *ins)
        err, lim = check_close(f'bench_layout {v}', lay['out'][v], ref)
        check_close(f'bench_layout {v} einsum x R',
                    bench_layout.R * bench_layout.library(v, *ins), ref)
        del ref
        p_ms = cuda_ms(lambda: bench_layout.plain(v, *ins), reps=2,
                       batches=1, warm=1)
        l_ms = cuda_ms(lambda: bench_layout.library(v, *ins), reps=5)
        counts = sass_of('bench_layout', f'layout_{v}_kernel',
                         bench_layout.R * bench_layout.NSLICE)
        if any(counts[op] for op in sass_compare.LOCAL_OPS):
            raise AssertionError(f'bench_layout {v}: local memory {counts}')
        rows.append({'tool': 'bench_layout', 'variant': v,
                     'ms': lay['ms'][v], 'err': err, 'lim': lim,
                     'cross_err': cross if v == 'transpose' else None,
                     'plain_ms': p_ms, 'library_ms': l_ms, 'flops': c[0],
                     'bytes': c[1], 'bound_ms': bound(*c)[0],
                     'gmac_per_s': bench_layout.macs() / lay['ms'][v] / 1e6,
                     'sass': counts})
        entry(bench_layout.COUNTER[v], 'bench_layout.cu', 'bench_layout.py:67',
              [err], lay['ms'][v], p_ms, [c], l_ms)
    del lay, ins
    # bench_tile: one launch of each variant on E = 32,768 rows, timed over
    # the tool's rotating input copies, as are the plain and library calls
    x, s = tile['inputs']
    copies = tile['copies']
    c = bench_tile.cost(x.shape[0])
    l_ms = cuda_ms(bench_tile.rotate(bench_tile.library, copies), reps=5)
    passes = sum(1.0 + r for r in range(bench_tile.REPS))   # sum of (1 + r)
    check_close('bench_tile einsum x passes',
                passes * bench_tile.library(x, s),
                bench_tile.plain(bench_tile.VARIANTS[0], x, s))
    for v in bench_tile.VARIANTS:
        ref = bench_tile.plain(v, x, s)
        err, lim = check_close(f'bench_tile {v}', tile['out'][v], ref)
        cross = float((tile['out'][v] - tile['out'][bench_tile.VARIANTS[0]])
                      .abs().max())
        if not cross < bench_tile.CROSS_TOL:
            raise AssertionError(f'bench_tile {v} vs d: {cross:.3e}')
        p_ms = cuda_ms(bench_tile.rotate(
            lambda xi, si: bench_tile.plain(v, xi, si), copies), reps=2,
            batches=1, warm=1)
        # the first product of each sum is an FMUL, the other four FFMAs: 4
        # a pass in the group sum, and in c 20 more for its tiling product
        per_pass = (bench_tile.D1 - 1) * (
            bench_tile.D1 + 1 if v == 'c:mxu-tile' else 1)
        counts = sass_of('bench_tile', f'tile_{v[0]}_kernel',
                         bench_tile.REPS * per_pass)
        row = {'tool': 'bench_tile', 'variant': v, 'ms': tile['ms'][v],
               'err': err, 'lim': lim, 'cross_err': cross,
               'plain_ms': p_ms, 'library_ms': l_ms, 'flops': c[0],
               'bytes': c[1], 'formulation_flops':
               bench_tile.formulation_flops(v, x.shape[0]),
               'bound_ms': bound(*c)[0], 'copies': len(copies),
               'sass': counts}
        if v in ('b:bcast+cat', 'c:mxu-tile'):
            row.update(tile_redesigned(v, counts, builds['bench_tile'][2]))
            row['share_of_bound'] = row['bound_ms'] / row['ms']
            print(f'bench_tile {v}: {row["ms"]:.4f} ms, bound '
                  f'{row["bound_ms"]:.4f} ms ({row["share_of_bound"]:.1%}), '
                  f'floor of its formulation {row["floor_ms"]:.4f} ms '
                  f'({row["floor_of"]})', flush=True)
        rows.append(row)
        entry(bench_tile.COUNTER[v], 'bench_tile.cu', 'bench_tile.py:93',
              [err], tile['ms'][v], p_ms, [c], l_ms)
    del tile, copies
    report['micro'] = {'run_s': run_s, 'rows': rows,
                       'phase_s': time.perf_counter() - t0,
                       'launches': {k: launches[k]
                                    for k in cuda_build.BENCH_KERNELS}}
    print(f'micro-benchmarks: tools {run_s:.1f} s, phase '
          f'{report["micro"]["phase_s"]:.1f} s', flush=True)
    return kernels


def tile_redesigned(v, counts, texts):
    """bench_tile's b or c beyond phase 15's common checks, outside the
    counted run: no local memory; b's SASS stages every pass's whole tiled
    row in shared memory and reads its 5 columns back (>= 160 bytes stored
    and loaded a lane and row, in any width); b and c against their plain
    versions and within CROSS_TOL of d on ragged E (fewer rows than the
    persistent grid's warps, and rows not a multiple of its warps), c also
    with T altered (it reads T, it does not assume it). Returns the
    row's additions."""
    import torch
    from sevennet_exp_tpu_torch.tools import bench_tile, sass_compare
    from sevennet_exp_tpu_torch.tools.bench_tile import D1, REPS, W
    name = f'tile_{v[0]}_kernel'
    if any(counts[op] for op in sass_compare.LOCAL_OPS):
        raise AssertionError(f'bench_tile {v}: local memory {counts}')
    add = {}
    if v == 'b:bcast+cat':
        (text,) = [t for k, t in texts.items() if name in k]
        shared = add['shared_bytes'] = sass_compare.shared_bytes(text)
        want = REPS * W * 4 // 32           # = REPS * D1 * 4 read back
        print(f'{name}: shared bytes a lane and row {shared} (want >= '
              f'{want} each way)', flush=True)
        if shared['STS'] < want or shared['LDS'] < REPS * D1 * 4:
            raise AssertionError(f'{name}: {shared}')
        add.update(floor_ms=bench_tile.b_shared_floor_ms(32768),
                   floor_of='its shared-memory traffic at 128 bytes a clock '
                            'an SM, 1.98 GHz')
    else:
        add.update(floor_ms=bench_tile.formulation_bound_ms(v, 32768),
                   floor_of='its fp32 arithmetic')
    ragged = add['ragged'] = {}
    for E in (1, 7, 100, 1003, 32768 + 5):
        x, s = bench_tile.make_inputs(E, 'cuda', seed=E)
        got = bench_tile.forward(v, x, s)
        err, _ = check_close(f'bench_tile {v}, E = {E}', got,
                             bench_tile.plain(v, x, s))
        cross = float((got - bench_tile.plain(bench_tile.VARIANTS[0], x, s))
                      .abs().max())
        if not cross < bench_tile.CROSS_TOL:
            raise AssertionError(f'bench_tile {v} vs d at E = {E}: '
                                 f'{cross:.3e}')
        ragged[E] = {'err': err, 'vs_d': cross}
        if v == 'c:mxu-tile':
            T = torch.as_tensor(bench_tile.ones_block(), device=x.device)
            T[1, 5] = -3.0
            got2 = bench_tile.forward(v, x, s, T)
            ragged[E]['err_T'], _ = check_close(
                f'bench_tile c, T altered, E = {E}', got2,
                bench_tile.plain(v, x, s, T))
            if not float((got2 - got).abs().max()) > 1e-3:
                raise AssertionError('bench_tile c ignores T')
    print(f'bench_tile {v} ragged: {ragged}', flush=True)
    return add


def timed_nvt(engine, warm_steps, n_steps):
    """A warm-up of warm_steps, then n_steps timed on the host clock with
    the launch counters reset just before them; the MD state must stay
    finite."""
    import numpy as np
    import torch
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    t0 = time.perf_counter()
    warm = engine.run(warm_steps)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    calls = [0]
    which = '_efs_fn' if engine.npt else '_ef_fn'
    ef0 = getattr(engine, which)

    def counted(*args):
        calls[0] += 1
        return ef0(*args)

    setattr(engine, which, counted)
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = engine.run(n_steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fc.launch_counts)
    setattr(engine, which, ef0)
    state = engine.state
    if not all(bool(torch.isfinite(t).all())
               for t in (state.pos, state.vel, state.forces,
                         state.energy) + ((state.cell,) if engine.npt
                                          else ())):
        raise AssertionError('NaN/inf in the MD state')
    out = {'atoms': engine.n, 'steps': n_steps, 'warmup_s': warm_s,
           'wall_s': wall, 'ms_per_step': wall / n_steps * 1e3,
           'ns_per_day': n_steps / wall * 2.0 * 1e-6 * 86400.0,
           'final_temperature_K': float(metrics['temperature'][-1]),
           'mean_temperature_K': float(metrics['temperature'].mean()),
           'temperature_K': metrics['temperature'].tolist(),
           'volume': metrics.get('volume', np.zeros(0)).tolist(),
           'force_calls': calls[0], 'launches': launches,
           'deg_cap': engine.deg_cap,
           'rebuild_every': engine.rebuild_every,
           # steps of each accepted chunk, i.e. the cadence it ran at
           # (a stale chunk re-runs: force calls - steps = re-run steps)
           'cadence_warmup': warm['steps'].astype(int).tolist(),
           'cadence': metrics['steps'].astype(int).tolist(),
           'chunk_rows': engine.conv_chunk_rows,
           'energy': metrics['energy'].tolist()}
    print(f'{n_steps} steps in {wall:.3f} s: {out["ms_per_step"]:.3f} '
          f'ms/step, {out["ns_per_day"]:.4f} ns/day, final T '
          f'{out["final_temperature_K"]:.1f} K, force calls {calls[0]} '
          f'for {n_steps} steps, launches {launches}', flush=True)
    print(f'cadence (steps per chunk): warm-up {out["cadence_warmup"]}, '
          f'timed {out["cadence"]}; rebuild_every now '
          f'{engine.rebuild_every}', flush=True)
    return out

def check_launches(nvt, per_call):
    """Every force call of a timed run launched per_call[k] of kernel k."""
    for k, v in nvt['launches'].items():
        want = per_call.get(k, 0) * nvt['force_calls']
        if v != want or (per_call.get(k) and v == 0):
            raise AssertionError(
                f'{k}: {v} launches for {nvt["force_calls"]} force '
                f'calls (want {per_call.get(k, 0)} per call)')


def _tiny_config(**over):
    """A small model config with its species given (no dataset
    statistics needed)."""
    from sevennet_exp_tpu_torch.util import chemical_species_preprocess
    config = {
        'cutoff': 4.0, 'channel': 4,
        'radial_basis': {'radial_basis_name': 'bessel'},
        'cutoff_function': {'cutoff_function_name': 'poly_cut'},
        'lmax': 2, 'is_parity': True, 'num_convolution_layer': 2,
        'weight_nn_hidden_neurons': [64, 64], 'act_radial': 'silu',
        'conv_denominator': 30.0, 'self_connection_type': 'linear',
        'shift': -10.0, 'scale': 10.0,
    }
    config.update(chemical_species_preprocess(['Na', 'Cl']))
    config.update(over)
    return config


def conv_routes_on_card(report, dev):
    """Fault C.1 on the card: a tiny model the kernels refuse (hidden
    [32, 32]) routes every conv to the plain chain and launches no conv
    kernel, E/F equal to the CPU (phase 3's limits); a layer with a
    1x1o+1x0e filter is refused (its SH block is not at l2^2) and its
    plain chain on the card equals the CPU's (REL_TOL); a tiny ssp
    model routes to the kernels, whose shifted-softplus build
    (``fused_conv_geom_ssp``: the dense, edge and geom pairs) and the
    terms pair's ssp branch match their plain versions within REL_TOL
    (phase 2's limit), the geom pair's pad rows exact zeros."""
    import copy
    import numpy as np
    import torch
    from sevennet_exp_tpu_torch import _keys as KEY
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.model.build import (
        build_e3_equivariant_model)
    from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
    from sevennet_exp_tpu_torch.model.model import flatten
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)

    def random_model(config, seed):
        model = build_e3_equivariant_model(config)
        params, _ = model.init(torch.Generator().manual_seed(seed))
        model.load_state(flatten(params))
        return model

    at = build_nacl(64, rattle=0.1, seed=2)
    s = 3.4 / 5.63
    at = Atoms(at.atomic_numbers, at.pos * s, at.cell * s, at.pbc)
    out = {}
    refused = random_model(_tiny_config(weight_nn_hidden_neurons=[32, 32]),
                           3)
    routes = refused.conv_routes(0)
    print(f'hidden [32, 32]: routes {routes}', flush=True)
    if any(r['route'] != 'plain' for r in routes):
        raise AssertionError('a refused conv routes to the kernel')
    ref = SevenNetCalculator(copy.deepcopy(refused),
                             device='cpu').calculate(at)
    fc.reset_launch_counts()
    got = SevenNetCalculator(refused, device=dev).calculate(at)
    if any(fc.launch_counts.values()):
        raise AssertionError(f'refused model launched {fc.launch_counts}')
    out['refused_hidden'] = check_ef('refused model, card vs CPU', 64,
                                     got['energy'], torch.tensor(
                                         got['forces']), ref['energy'],
                                     torch.tensor(ref['forces']))

    x, sh = Irreps('4x0e+4x1o'), Irreps('1x1o+1x0e')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 1, 'full'))
    layer = IrrepsConvolution(
        tp, FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu'),
        LinearSpec(tp.irreps_out, x), 10.0)
    why = layer.kernel_refusal(0)
    print(f'1x1o+1x0e filter: refused: {why}', flush=True)
    if why is None or 'l2^2' not in why:
        raise AssertionError('the 1x1o+1x0e filter layer is not refused')
    params, _ = layer.init(torch.Generator().manual_seed(5))
    for group, vals in ((layer.weight_nn_p, params['weight_nn']),
                        (layer.si2_p, params['si2'])):
        for k, v in vals.items():
            getattr(group, k).copy_(v)
    rng = np.random.default_rng(5)
    n, e = 64, 2048
    data = {KEY.NODE_FEATURE: rng.normal(size=(n, x.dim)),
            KEY.EDGE_IDX: rng.integers(0, n, size=(2, e)),
            KEY.EDGE_ATTR: rng.normal(size=(e, sh.dim)),
            KEY.EDGE_EMBEDDING: rng.normal(size=(e, 8)),
            KEY.EDGE_MASK: (rng.uniform(size=e) > 0.2).astype(float)}
    ys = {}
    for d in ('cpu', dev):
        layer.to(d)
        batch = {k: torch.tensor(v, device=d,
                                 dtype=torch.long if k == KEY.EDGE_IDX
                                 else torch.float32)
                 for k, v in data.items()}
        fc.reset_launch_counts()
        ys[str(d)] = layer(batch)[KEY.NODE_FEATURE].cpu()
        if any(fc.launch_counts.values()):
            raise AssertionError('the refused filter layer launched')
    out['refused_filter_err'] = check_close(
        'refused filter layer, card vs CPU', ys[str(dev)], ys['cpu'])[0]

    ssp = random_model(_tiny_config(act_radial='ssp'), 4).to(dev)
    routes = ssp.conv_routes(0)
    if any(r['route'] != 'kernel' for r in routes):
        raise AssertionError(f'ssp model routes {routes}')
    errs = []
    rows = 16 * 37

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)

    for name, cl in ssp.layers.items():
        if not isinstance(cl, IrrepsConvolution):
            continue
        mlp_ws, si2_ws = cl._weights()
        ms = torch.tensor(rng.uniform(0.01, 0.05, size=(rows, 1)),
                          dtype=torch.float32, device=dev)
        pad = torch.tensor(rng.uniform(size=rows) < 0.2, device=dev)
        ms[pad] = 0
        for dd, mode in ((0, 'cmshared'), (16, 'cmshared'), (0, 'terms'),
                         (16, 'terms')):
            conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, dd,
                                cg_mode=mode)
            xg, shr, emb, g = (t(rows, conv.d1), t(rows, conv.f),
                               t(rows, conv.nb),
                               t(rows // conv.group, conv.d_out))
            args = (xg, shr, emb, ms, mlp_ws, si2_ws)
            what = f'{name} ssp {mode} D={dd}'
            errs.append(check_close(f'{what} fwd', conv.kernel_forward(*args),
                                    conv.plain_forward(*args))[0])
            for a, b in zip(conv.kernel_backward(g, *args),
                            conv.plain_backward(g, *args)):
                errs.append(check_close(f'{what} bwd', a, b)[0])
        # the geom pair: edge vectors up to just past the cutoff, pad rows
        # (ms = 0, the unit vector) exact zeros in dxg and dvec
        conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 16, geom=cl.geom)
        rc = conv.geom.cutoff
        u = rng.normal(size=(rows, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        vec = u * rng.uniform(0.3 * rc, 1.02 * rc, size=(rows, 1))
        vec[pad.cpu().numpy()] = [1.0, 0.0, 0.0]
        vec = torch.tensor(vec, dtype=torch.float32, device=dev)
        coeffs = torch.arange(1, conv.nb + 1, dtype=torch.float32,
                              device=dev) * (math.pi / rc)
        xg, g = t(rows, conv.d1), t(rows // 16, conv.d_out)
        args = (xg, vec, ms, coeffs, mlp_ws, si2_ws)
        errs.append(check_close(f'{name} ssp geom fwd',
                                conv.kernel_geom_forward(*args),
                                conv.plain_geom_forward(*args))[0])
        for a, b in zip(conv.kernel_geom_backward(g, *args),
                        conv.plain_geom_backward(g, *args)):
            errs.append(check_close(f'{name} ssp geom bwd', a, b)[0])
            if a[pad].abs().max() != 0:
                raise AssertionError(f'{name} ssp geom bwd: pad rows not '
                                     'zero')
    out['ssp_max_err'] = max(errs)
    print(f'ssp kernels vs plain: max abs err {max(errs):.3e}', flush=True)
    report['conv_routes'] = out


def training(report, dev, card):
    """Phase 16: train_v2 on trained_nacl/input.yaml (7net-0 width, the
    repo's NaCl data, batch 8, one epoch: 47 train steps, 6 valid batches)
    in a temporary working dir. Holds: the first step's loss (1e-5
    relative) and every gradient leaf (1e-4 of the leaf's max|g|) on the
    card against the CPU, from the same parameters and first batch; the
    mean loss of the last 10 steps below that of the first 10; no conv
    kernel launched; checkpoint_last reloads in the calculator on the card
    (plain chain: E/F equal to the trainer model's within 1e-5; kernels:
    within phase 3's limits)."""
    import copy
    import csv
    import tempfile
    import numpy as np
    import torch
    from sevennet_exp_tpu_torch import _keys as KEY
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.dataset import datasets_from_config
    from sevennet_exp_tpu_torch.data.extxyz import read_extxyz
    from sevennet_exp_tpu_torch.data.graph import (
        Atoms, atoms_to_graph, collate_graphs)
    from sevennet_exp_tpu_torch.logger import Logger
    from sevennet_exp_tpu_torch.model.build import (
        build_e3_equivariant_model)
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.parse_input import read_config_yaml
    from sevennet_exp_tpu_torch.scripts.train import (
        loader_from_config, train_v2)
    from sevennet_exp_tpu_torch.train.trainer import Trainer

    out = {}
    data_dir = os.path.join(HERE, 'nacl_classical_data')
    config = read_config_yaml(os.path.join(HERE, 'trained_nacl',
                                           'input.yaml'))
    config[KEY.LOAD_TRAINSET] = [os.path.join(data_dir, 'train.extxyz')]
    config[KEY.LOAD_VALIDSET] = [os.path.join(data_dir, 'valid.extxyz')]
    config[KEY.EPOCH] = 1
    with tempfile.TemporaryDirectory() as work:
        # the first step on both devices, same parameters and batch
        cfg0 = copy.deepcopy(config)
        t0 = time.perf_counter()
        sets = datasets_from_config(cfg0, work)
        out['dataset_s'] = time.perf_counter() - t0
        batch = next(iter(loader_from_config(cfg0, sets['trainset'],
                                             is_train=True)))
        model = build_e3_equivariant_model(cfg0)
        params, mask = model.init(torch.Generator().manual_seed(
            cfg0[KEY.RANDOM_SEED]))
        first = {}
        for d in ('cpu', dev):
            tr = Trainer(copy.deepcopy(model), params, mask, cfg0, device=d)
            t0 = time.perf_counter()
            first[str(d)] = tr.loss_and_grads(tr.batch_to_device(batch))
            if d != 'cpu':
                torch.cuda.synchronize()
            out[f'first_step_{"cpu" if d == "cpu" else "card"}_s'] = (
                time.perf_counter() - t0)
            del tr
        (l_c, g_c), (l_g, g_g) = first['cpu'], first[str(dev)]
        d_loss = abs(float(l_g) - float(l_c)) / abs(float(l_c))
        worst = max(float((g_g[k].cpu() - g_c[k]).abs().max())
                    / max(float(g_c[k].abs().max()), 1e-30) for k in g_c)
        print(f'first step: loss card {float(l_g):.8f} cpu {float(l_c):.8f}'
              f' (rel {d_loss:.2e} <= 1e-5); worst gradient leaf '
              f'{worst:.2e} of its max|g| (<= 1e-4), {len(g_c)} leaves; '
              f'{batch[KEY.NUM_ATOMS].sum()} atoms, '
              f'{int(batch[KEY.EDGE_MASK].sum())} edges', flush=True)
        if not (d_loss <= 1e-5 and worst <= 1e-4):
            raise AssertionError('first step: card and CPU disagree')
        out.update(first_loss=float(l_g), first_loss_rel_err=d_loss,
                   first_grad_worst=worst)
        first = g_c = g_g = None

        # the epoch through train_v2, every train step timed
        losses, step_ms = [], []
        orig = Trainer.train_step

        def timed(self, b):
            torch.cuda.synchronize()
            t = time.perf_counter()
            stats = orig(self, b)
            losses.append(float(stats['TotalLoss'][0]))
            step_ms.append((time.perf_counter() - t) * 1e3)
            return stats

        Trainer.train_step = timed
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        try:
            t0 = time.perf_counter()
            trainer = train_v2(copy.deepcopy(config), work, device=dev)
            torch.cuda.synchronize()
            out['train_v2_s'] = time.perf_counter() - t0
        finally:
            Trainer.train_step = orig
        launched = {k: v for k, v in fc.launch_counts.items()
                    if k.startswith('fused_conv') and v}
        out['peak_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        out['steps'] = len(losses)
        out['ms_per_step'] = float(np.mean(step_ms[1:]))
        out['first_step_ms'] = step_ms[0]
        first10, last10 = np.mean(losses[:10]), np.mean(losses[-10:])
        out.update(loss_first10=float(first10), loss_last10=float(last10))
        with open(os.path.join(work, 'lc.csv')) as fh:
            row = list(csv.DictReader(fh))[-1]
        out['lc'] = {k: float(v) for k, v in row.items()}
        print(f'{card}: {len(losses)} train steps, {out["ms_per_step"]:.1f} '
              f'ms a step after the first ({step_ms[0]:.1f} ms), peak '
              f'{out["peak_gib"]:.2f} GiB; mean loss of the first 10 steps '
              f'{first10:.6f}, of the last 10 {last10:.6f}', flush=True)
        print('epoch 1: ' + ', '.join(f'{k} {v:.6g}' for k, v in
                                      out['lc'].items()), flush=True)
        if len(losses) != 47:
            raise AssertionError(f'{len(losses)} train steps, want 47')
        if not last10 < first10:
            raise AssertionError('the loss did not fall')
        if launched:
            raise AssertionError(f'training launched conv kernels: '
                                 f'{launched}')

        # the last checkpoint in the calculator on the card
        frame = read_extxyz(config[KEY.LOAD_VALIDSET][0], 0)[0]
        g = atoms_to_graph(frame, trainer.model.cutoff)
        b = trainer.batch_to_device(collate_graphs([g]))
        with torch.no_grad():
            ref = trainer.model.apply(b)
        e_ref, f_ref = ref[KEY.PRED_TOTAL_ENERGY][0], ref[KEY.PRED_FORCE][:64]
        path = os.path.join(work, 'checkpoint_last.pth.sevennet')
        at = Atoms(frame.atomic_numbers, frame.pos, frame.cell, frame.pbc)
        res = SevenNetCalculator(path, device=dev,
                                 use_kernels=False).calculate(at)
        d_f = float(np.abs(res['forces'] - f_ref.cpu().numpy()).max())
        d_e = abs(res['energy'] - float(e_ref))
        print(f'checkpoint_last in the calculator (plain chain): |dE| '
              f'{d_e:.2e} eV, max|dF| {d_f:.2e} eV/A (<= 1e-5)', flush=True)
        if not (d_f <= 1e-5 and d_e <= 1e-5 * 64):
            raise AssertionError('the checkpoint does not reload')
        fc.reset_launch_counts()
        calc = SevenNetCalculator(path, device=dev)
        res_k = calc.calculate(at)
        routes = calc.model.conv_routes(0)
        if fc.launch_counts['fused_conv_edge_fwd'] != len(routes):
            raise AssertionError(f'the calculator did not run the kernels: '
                                 f'{routes}')
        out['reload'] = {'plain_dE': d_e, 'plain_max_dF': d_f,
                         'kernels': check_ef(
                             'checkpoint_last, kernels vs plain', 64,
                             res_k['energy'], torch.tensor(res_k['forces']),
                             res['energy'], torch.tensor(res['forces']))}
        # where a step's time goes: steps on the epoch's first batch (after
        # the checkpoint check: they move the parameters), three untraced,
        # then three under torch.profiler; the idle share is of the
        # untraced steps on that batch
        from torch.profiler import ProfilerActivity, profile
        b0 = trainer.batch_to_device(batch)
        trainer.train_step(b0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.train_step(b0)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / 3 * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                trainer.train_step(b0)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
        ev = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
        dev_ms = sum(e.self_device_time_total for e in ev) / 3e3
        out['trace'] = {
            'traced_ms_per_step': wall, 'untraced_ms_per_step': untraced,
            'device_kernel_ms_per_step': dev_ms,
            'device_idle_share': 1.0 - dev_ms / untraced,
            'launches_per_step': sum(e.count for e in ev) / 3,
            'top_kernels': [{'name': e.key[:90],
                             'ms_per_step': e.self_device_time_total / 3e3,
                             'calls_per_step': e.count / 3}
                            for e in ev[:8]]}
        print(f'first batch: untraced step {untraced:.1f} ms, traced '
              f'{wall:.1f} ms, device kernels {dev_ms:.1f} ms a step '
              f'({out["trace"]["launches_per_step"]:.0f} launches): device '
              f'idle {out["trace"]["device_idle_share"]:.1%} of the '
              f'untraced step', flush=True)
        for k in out['trace']['top_kernels']:
            print(f"  {k['ms_per_step']:8.2f} ms/step "
                  f"{k['calls_per_step']:6.0f} calls  {k['name']}",
                  flush=True)
        Logger().file.close()
        Logger().file = None
    report['training'] = out


# the modal flags of the JAX package's presets/multi_modal.yaml (the port
# carries no presets yet: ROADMAP A.6)
MULTI_MODAL_FLAGS = {
    'use_modality': True, 'use_modal_node_embedding': False,
    'use_modal_self_inter_intro': True, 'use_modal_self_inter_outro': True,
    'use_modal_output_block': True, 'use_modal_wise_shift': True,
    'use_modal_wise_scale': False}
# the three model forms of phase 17 d, each at 7net-0 width (trained_nacl's
# config) with weights from a seed
VARIANTS = {
    'multi_cutoff': {'multi_cutoff': [5.0, 5.0, 4.5, 4.5, 4.0]},
    'modal': dict(MULTI_MODAL_FLAGS, _modal_map={'pbe': 0, 'scan': 1},
                  _number_of_modalities=2),
    'fcn_readout': {'readout_as_fcn': True},
}


def variant_model(name, seed=7):
    """trained_nacl's config in VARIANTS[name]'s form, weights drawn from
    ``torch.Generator(seed)`` (CPU)."""
    import torch
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
    from sevennet_exp_tpu_torch.model.model import flatten
    config = dict(SevenNetCheckpoint(CHECKPOINT).config, **VARIANTS[name])
    model = build_e3_equivariant_model(config)
    params, _ = model.init(torch.Generator().manual_seed(seed))
    model.load_state(flatten(params))
    return model


def _efs_close(what, n, a, b):
    """Calculator results a against b: E per atom, forces, stress."""
    import numpy as np
    d = {'dE_per_atom': abs(a['energy'] - b['energy']) / n,
         'max_dF': float(np.abs(a['forces'] - b['forces']).max()),
         'max_dS': float(np.abs(a['stress'] - b['stress']).max())}
    print(f'{what}: E {a["energy"]:.6f} vs {b["energy"]:.6f} eV; |dE|/N '
          f'{d["dE_per_atom"]:.3e} (<= {E_TOL_PER_ATOM}), max|dF| '
          f'{d["max_dF"]:.3e} (<= {F_TOL}), max|dS| {d["max_dS"]:.3e} '
          f'(<= {S_TOL})', flush=True)
    if not (d['dE_per_atom'] <= E_TOL_PER_ATOM and d['max_dF'] <= F_TOL
            and d['max_dS'] <= S_TOL
            and all(np.isfinite(a[k]).all() for k in ('forces', 'stress'))):
        raise AssertionError(f'{what}: results disagree')
    return dict(d, energy=a['energy'], energy_other=b['energy'])


def d3_and_variants(report, dev, model, atoms_1k):
    """Phase 17: the D3 overlay in the calculator and the MD engine, and the
    model's other forms, at full width on the card (see the docstring)."""
    import copy
    import numpy as np
    import torch
    from sevennet_exp_tpu_torch.calculator import (
        D3Calculator, SevenNetCalculator, SevenNetD3Calculator)
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import d3 as d3mod
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    out = report['d3_variants'] = {}
    n = len(atoms_1k)
    edge = {'fused_conv_edge_fwd': 5, 'fused_conv_edge_bwd': 5}
    dense = {'fused_conv_fwd': 5, 'fused_conv_bwd': 5}

    def launched(want, what, calls=1):
        got = {k: v for k, v in fc.launch_counts.items() if v}
        if got != {k: v * calls for k, v in want.items()}:
            raise AssertionError(f'{what} launched {got}, want {want} x '
                                 f'{calls}')
        return got

    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    # -- a: SevenNetD3Calculator on the 1k NaCl --------------------------
    print('-- 17a SevenNetD3Calculator (damp_bj, pbe, rthr 9000, cn_thr '
          '1600) on the 1k NaCl', flush=True)
    calc = SevenNetD3Calculator(model)
    d3 = calc.d3
    if (calc.device.type != 'cuda' or d3.device.type != 'cuda'
            or (d3.damping.kind, d3.rthr, d3.cn_thr) != ('bj', 9000.0,
                                                         1600.0)):
        raise AssertionError('SevenNetD3Calculator: not the card or not '
                             'the default D3')
    calc.calculate(atoms_1k)                      # capacities, tables
    fc.reset_launch_counts()
    res = calc.calculate(atoms_1k)
    launched(edge, 'a SevenNetD3Calculator call')
    plain = SevenNetD3Calculator(model, use_kernels=False).calculate(
        atoms_1k)
    fc.reset_launch_counts()
    alone = SevenNetCalculator(model).calculate(atoms_1k)
    disp_calc = D3Calculator()
    disp = disp_calc.calculate(atoms_1k)
    launched(edge, 'SevenNetCalculator + D3Calculator')
    summed = {k: alone[k] + disp[k] for k in ('energy', 'forces', 'stress')}
    a = out['a'] = {
        'kernels_vs_plain': _efs_close('kernels vs use_kernels=False', n,
                                       res, plain),
        'vs_sum': _efs_close('SevenNetD3Calculator vs SevenNetCalculator + '
                             'D3Calculator', n, res, summed),
        'd3_energy': disp['energy'], 'launches': dict(edge)}
    if not disp['energy'] < 0:
        raise AssertionError('D3 energy of the 1k NaCl is not attractive')
    a['call_ms'] = host_ms(lambda: calc.calculate(atoms_1k), 5)
    a['model_call_ms'] = host_ms(
        lambda: SevenNetCalculator.calculate_single(calc, atoms_1k), 5)
    a['d3_call_ms'] = host_ms(lambda: disp_calc.calculate(atoms_1k), 5)
    print(f'SevenNetD3Calculator {a["call_ms"]:.2f} ms a call (host clock, '
          f'after the first), of which the model {a["model_call_ms"]:.2f} '
          f'ms; D3Calculator alone {a["d3_call_ms"]:.2f} ms; D3 energy '
          f'{disp["energy"]:.6f} eV', flush=True)
    calc = disp_calc = None

    # -- b: 1k NVT with d3 on the dense grid -----------------------------
    print('-- 17b 1k NVT with d3= on the dense grid, and without', flush=True)
    md = MolecularDynamics(model, atoms_1k, device=dev,
                           d3=d3mod.D3Dispersion(), **MD_KW)
    md.prime()
    b = out['b'] = {'engine_vs_calculator': check_ef(
        'engine E/F with d3 vs SevenNetD3Calculator', n, md.state.energy,
        md.state.forces, torch.tensor(res['energy']),
        torch.as_tensor(res['forces'], device=dev))}
    b['with_d3'] = timed_nvt(md, 20, 40)
    check_launches(b['with_d3'], dense)
    md = MolecularDynamics(model, atoms_1k, device=dev, **MD_KW)
    b['without_d3'] = timed_nvt(md, 20, 40)
    check_launches(b['without_d3'], dense)
    print(f'1k NVT: {b["with_d3"]["ms_per_step"]:.3f} ms/step with D3, '
          f'{b["without_d3"]["ms_per_step"]:.3f} without', flush=True)
    md = None
    torch.cuda.empty_cache()

    # -- c: one 97k chunked force call with d3 ---------------------------
    print(f'-- 17c one {N_LARGE}-atom chunked force call with d3=',
          flush=True)
    big = MolecularDynamics(model, build_nacl(N_LARGE), device=dev,
                            d3=d3mod.D3Dispersion(), **MD_KW)
    rows, chunk_rows = big.e_cap_model, big.conv_chunk_rows
    chunks = -(-rows // chunk_rows)
    if not (chunk_rows and big._geom_packed_ok()):
        raise AssertionError('97k engine with d3: not the chunked '
                             'geometry-fused path')
    widths = np.diag(np.asarray(big.cell.cpu(), np.float64))
    r_vdw = float(np.sqrt(9000.0)) * d3mod.AU_TO_ANG
    nl = big._grid()
    pos = big.state.pos
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    e, f = big._ef_fn(pos, nl)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launched({'fused_conv_geom_fwd': 5 * chunks,
              'fused_conv_geom_bwd': 5 * chunks}, '97k force call with d3')
    # the model alone, then the tiled D3 alone, by autograd
    d3_state, big._d3 = big._d3, None
    e_m, f_m = big._ef_fn(pos, nl)
    big._d3 = d3_state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        e_d = big._d3_energy(p)
        (g_d,) = torch.autograd.grad(e_d, p)
    e_d = e_d.detach()
    torch.cuda.synchronize()
    d3_ms = (time.perf_counter() - t0) * 1e3
    c = out['c'] = check_ef('97k with d3 vs the model alone + the tiled D3',
                            big.n, e, f, e_m + e_d, f_m - g_d)
    c.update(force_call_ms=call_ms, d3_tiled_ms=d3_ms,
             peak_memory_bytes=peak, chunks=chunks, chunk_rows=chunk_rows,
             cell_widths=widths.tolist(), mic_width=2 * r_vdw,
             d3_energy=float(e_d))
    print(f'97k force call with d3 {call_ms:.1f} ms (host clock), the tiled '
          f'D3 alone (energy and forces) {d3_ms:.1f} ms, peak memory '
          f'{peak / 2 ** 30:.2f} GiB; cell widths {widths.round(2).tolist()} '
          f'A >= 2 r_vdw = {2 * r_vdw:.2f} A; D3 energy {float(e_d):.4f} eV',
          flush=True)
    big = nl = pos = e = f = e_m = f_m = p = g_d = None
    torch.cuda.empty_cache()

    # -- d: the model's other forms at 7net-0 width ----------------------
    print('-- 17d the variant models at 7net-0 width (weights from a seed)',
          flush=True)
    small = build_nacl(216, rattle=0.05, seed=3)
    out['d'] = {}
    for name in VARIANTS:
        m_cpu = variant_model(name)
        m = copy.deepcopy(m_cpu).to(dev)
        modals = sorted(m.modal_map) or [None]
        routes = m.conv_routes(0)
        grid_routes = m.conv_routes(32)
        plain = [r for r in routes if r['route'] == 'plain']
        if name == 'modal':
            # the modal split: every convolution has no si2, as in JAX
            ok = len(plain) == 5 and all('si2' in r['refusal']
                                         for r in plain)
            want = {}
        else:
            ok = not plain and all(r['route'] == 'kernel'
                                   for r in grid_routes)
            want = edge
        if not ok:
            raise AssertionError(f'{name}: conv routes {routes}')
        row = out['d'][name] = {
            'routes': [(r['layer'], r['route'], r['refusal']) for r in routes]}
        for modal in modals:
            tag = name + (f' ({modal})' if modal else '')
            calc = SevenNetCalculator(m, modal=modal)
            calc.calculate(atoms_1k)
            fc.reset_launch_counts()
            res = calc.calculate(atoms_1k)
            launched(want, f'{tag} calculator call')
            ref = SevenNetCalculator(m, modal=modal,
                                     use_kernels=False).calculate(atoms_1k)
            row[f'{modal}_kernels_vs_plain'] = _efs_close(
                f'{tag}, 1k calculator: kernels vs use_kernels=False', n,
                res, ref)
            row[f'{modal}_call_ms'] = host_ms(
                lambda: calc.calculate(atoms_1k), 3)
            card = calc.calculate(small)
            cpu = SevenNetCalculator(m_cpu, device='cpu',
                                     modal=modal).calculate(small)
            row[f'{modal}_card_vs_cpu'] = _efs_close(
                f'{tag}, 216 atoms: card vs CPU', len(small), card, cpu)
        if name == 'multi_cutoff':
            # the dense grid of the MD engine: kernels 1-2, never the geom
            # pair (a multi-cutoff model is not geometry-fused)
            md = MolecularDynamics(m, atoms_1k, device=dev, **MD_KW)
            nl = md._grid()
            fc.reset_launch_counts()
            e_k, f_k = md._ef_fn(md.state.pos, nl)
            launched(dense, 'multi-cutoff 1k engine force call')
            md_p = MolecularDynamics(m, atoms_1k, device=dev,
                                     use_kernels=False, **MD_KW)
            e_p, f_p = md_p._ef_fn(md.state.pos, nl)
            row['engine_1k'] = check_ef(
                'multi-cutoff 1k engine: kernels 1-2 vs plain', n, e_k, f_k,
                e_p, f_p)
            md = md_p = nl = None
        print(f'{name}: conv routes ' + ', '.join(
            f'{layer} {route}' for layer, route, _ in row['routes'])
            + f'; {row[f"{modals[0]}_call_ms"]:.2f} ms a 1k calculator call',
            flush=True)
        m = m_cpu = calc = None
        torch.cuda.empty_cache()


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'sevennet_exp_tpu_torch')):
        print('chip_smoke: sevennet_exp_tpu_torch/ not found beside the '
              'script', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    out_dir = os.path.join(HERE, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    t_script = time.perf_counter()

    # -- phase 1 -------------------------------------------------------
    phase('1 card, precision, build')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops import fused_tp as ftp
    from sevennet_exp_tpu_torch.tools.timing import cuda_ms
    t0 = time.perf_counter()
    libs = cuda_build.build_all(verbose=True)
    report['build_s'] = time.perf_counter() - t0
    print(f'built {[os.path.relpath(lib, HERE) for lib in libs]} in '
          f'{report["build_s"]:.1f} s', flush=True)
    dev = torch.device('cuda')
    report['card'] = card
    report['device'] = torch.cuda.get_device_name(0)
    FC = fc.FusedConv
    ROUTES = ('forward', 'backward', 'geom_forward', 'geom_backward',
              'extw_forward', 'extw_backward')
    dispatch = {name: getattr(FC, name) for name in ROUTES}

    @contextlib.contextmanager
    def patched(**methods):
        """Swap FusedConv's dispatch methods, then put them back."""
        for name, fn in methods.items():
            setattr(FC, name, fn)
        try:
            yield
        finally:
            for name in methods:
                setattr(FC, name, dispatch[name])

    def plain_path():
        return patched(forward=FC.plain_forward, backward=FC.plain_backward,
                       geom_forward=FC.plain_geom_forward,
                       geom_backward=FC.plain_geom_backward,
                       extw_forward=FC.plain_extw_forward,
                       extw_backward=FC.plain_extw_backward)

    @contextlib.contextmanager
    def recorded(keep=lambda i: True):
        """Time every fused conv call of a force call with a pair of CUDA
        events, and record the inputs and the cotangent of the forward
        calls i for which keep(i) holds (i = layer * chunks + chunk).
        Yields (records, timings): a record is {'conv', 'call', 'kind',
        'args', 'g'} with kind '' | 'geom' | 'extw'; timings map a route to
        [(event, event, conv, ms)], ms being the mask scale (for 'extw' the
        weights, whose all-zero rows are the pads)."""
        records, timings = {}, {name: [] for name in ROUTES}

        def wrap(name):
            fn = getattr(FC, name)
            kind, is_bwd = name.rpartition('_')[0], 'backward' in name
            ms_at = (2 if kind else 3) + is_bwd

            def wrapped(self, *args):
                idx = len(timings[name])
                if is_bwd:
                    # the backward visits the layers in reverse, each
                    # layer's chunks in order
                    per_layer = len(timings[name.replace('back', 'for')]) // 5
                    idx = (4 - idx // per_layer) * per_layer + idx % per_layer
                    if idx in records:
                        records[idx]['g'] = args[0].detach()
                elif keep(idx):
                    records[idx] = {
                        'conv': self, 'call': idx, 'kind': kind,
                        'args': tuple(a.detach() if torch.is_tensor(a) else a
                                      for a in args)}
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(self, *args)
                b.record()
                timings[name].append((a, b, self, args[ms_at]))
                return out
            return wrapped

        with patched(**{name: wrap(name) for name in ROUTES}):
            yield records, timings

    def timed_ms(pairs):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b, _, _ in pairs)

    def launch_cost(pairs, which, **kind):
        flops = nbytes = 0.0
        for _, _, conv, ms in pairs:
            cost = fc.conv_cost(conv, ms, **kind)
            byt = fc.conv_bytes(conv, ms, **kind)
            flops += cost[0 if which == 'fwd' else 1]
            nbytes += byt[0 if which == 'fwd' else 1]
        return flops, nbytes

    def compare_kernels(rec, reps_plain=5, against=None):
        """One recorded launch: kernel against plain version, forward and
        backward, with median times and the bound. against: a second
        FusedConv of the same contract whose kernels are held to the same
        limit and timed beside."""
        conv, args, g, kind = rec['conv'], rec['args'], rec['g'], rec['kind']
        geom = kind == 'geom'
        if geom:
            kf, kb = conv.kernel_geom_forward, conv.kernel_geom_backward
            pf, pb = conv.plain_geom_forward, conv.plain_geom_backward
            names, ms = ('dxg', 'dvec'), args[2]
        elif kind == 'extw':
            kf, kb = conv.kernel_extw_forward, conv.kernel_extw_backward
            pf, pb = conv.plain_extw_forward, conv.plain_extw_backward
            names, ms = ('dxg', 'dsh', 'dweff'), args[2]
        else:
            kf, kb = conv.kernel_forward, conv.kernel_backward
            pf, pb = conv.plain_forward, conv.plain_backward
            names, ms = ('dxg', 'dsh', 'demb'), args[3]
        cost_kind = {'geom': {'geom': True},
                     'extw': {'ext_w': True}}.get(kind, {})
        row = {'rows': args[0].shape[0], 'd1': conv.d1, 'd_out': conv.d_out,
               'kind': kind}
        y_k, y_p = kf(*args), pf(*args)
        d_k, d_p = kb(g, *args), pb(g, *args)
        torch.cuda.synchronize()
        row['fwd_err'], row['fwd_lim'] = check_close('fwd', y_k, y_p)
        for name, a, b in zip(names, d_k, d_p):
            row[f'{name}_err'], row[f'{name}_lim'] = check_close(name, a, b)
        if against is not None:
            y_o = against.kernel_forward(*args)
            d_o = against.kernel_backward(g, *args)
            lim = REL_TOL * float(y_p.abs().max())
            row['fwd_vs_other'] = float((y_k - y_o).abs().max())
            if not row['fwd_vs_other'] <= lim:
                raise AssertionError(f'fwd: the two kernel pairs differ by '
                                     f'{row["fwd_vs_other"]:.3e} > {lim:.3e}')
            for name, a, b, ref in zip(names, d_k, d_o, d_p):
                err, lim = float((a - b).abs().max()), \
                    REL_TOL * float(ref.abs().max())
                row[f'{name}_vs_other'] = err
                if not err <= lim:
                    raise AssertionError(f'{name}: the two kernel pairs '
                                         f'differ by {err:.3e} > {lim:.3e}')
            del y_o, d_o
            row['other_fwd_ms'] = cuda_ms(
                lambda: against.kernel_forward(*args))
            row['other_bwd_ms'] = cuda_ms(
                lambda: against.kernel_backward(g, *args))
        pad = (ms == 0).all(dim=1)
        if any(float(d[pad].abs().max()) != 0.0 for d in d_k):
            raise AssertionError(
                f'pad rows of {"/".join(names)} are not zero')
        if not kind and conv.agg_d == 0 and float(y_k[pad].abs().max()):
            raise AssertionError('pad rows of the edge rows are not zero')
        row['pad_rows'] = int(pad.sum())
        if kind != 'geom':
            # kernels 1-4 (either form) and 7-8 sum in a fixed order: a
            # second launch, same bits
            again = (kf(*args), *kb(g, *args))
            if not all(torch.equal(a, b) for a, b in zip(again,
                                                          (y_k, *d_k))):
                raise AssertionError(f'{kind or conv.cg_mode} kernels: two '
                                     'launches differ')
            row['bit_identical'] = True
            del again
        del y_k, y_p, d_k, d_p
        row['fwd_ms'] = cuda_ms(lambda: kf(*args))
        row['bwd_ms'] = cuda_ms(lambda: kb(g, *args))
        row['fwd_plain_ms'] = cuda_ms(lambda: pf(*args), reps=reps_plain)
        row['bwd_plain_ms'] = cuda_ms(lambda: pb(g, *args), reps=reps_plain)
        fwd_flops, bwd_flops, real = fc.conv_cost(conv, ms, **cost_kind)
        fwd_bytes, bwd_bytes = fc.conv_bytes(conv, ms, **cost_kind)
        row.update(real_rows=real, fwd_flops=fwd_flops, bwd_flops=bwd_flops,
                   fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes)
        for k in ('fwd', 'bwd'):
            row[f'{k}_bound_ms'], row[f'{k}_bound_by'] = bound(
                row[f'{k}_flops'], row[f'{k}_bytes'])
        return row

    def show(row):
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in row.items()}), flush=True)

    model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
    atoms_1k = build_nacl(1000)
    md = MolecularDynamics(model, atoms_1k, device=dev, **MD_KW)
    md_geom = MolecularDynamics(model, atoms_1k, device=dev, geom_dense=True,
                                **MD_KW)
    n = md.n
    print(f'{n} atoms, deg_cap {md.deg_cap}, grid rows {md.e_cap_model}, '
          f'e_cap {md.e_cap}, cell list {md.use_cell_list}', flush=True)
    assert md.conv_chunk_rows == 0, 'the 1k path must not chunk'
    # kernels 1-2 as launched at each layer: registers, local memory, blocks
    # an SM at the layer's shared bytes
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    report['dense_resources'] = []
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        conv = FC(cl.tp, cl.weight_nn, cl.si2, md.deg_cap)
        dims = fcg.layer_dims(conv, md.deg_cap)
        for k, want in (('fwd', 3), ('bwd', 2)):
            r = fcg.kernel_resources(dims, conv.f, k == 'bwd', geom=False)
            print(f'kernel {1 if k == "fwd" else 2}, layer {li}: '
                  f'{r.registers} registers, {r.local_bytes} local bytes, '
                  f'{r.blocks_per_sm} blocks an SM at {r.smem} shared bytes',
                  flush=True)
            if r.local_bytes or r.blocks_per_sm < want:
                raise AssertionError(f'kernel {k} layer {li}: {r}')
            report['dense_resources'].append(dict(layer=li, kernel=k,
                                                  **r._asdict()))
    # the edge pair (the calculator's agg_d = 0) as launched at each layer
    report['edge_resources'] = []
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        conv = FC(cl.tp, cl.weight_nn, cl.si2, 0)
        dims = fcg.layer_dims(conv, 0)
        for k in ('fwd', 'bwd'):
            r = fcg.kernel_resources(dims, conv.f, k == 'bwd', edge=True)
            print(f'edge-row kernel {1 if k == "fwd" else 2}, layer {li}: '
                  f'{r.registers} registers, {r.local_bytes} local bytes, '
                  f'{r.blocks_per_sm} blocks an SM at {r.smem} shared bytes',
                  flush=True)
            if r.local_bytes or r.blocks_per_sm < 2:
                raise AssertionError(f'edge kernel {k} layer {li}: {r}')
            report['edge_resources'].append(dict(layer=li, kernel=k,
                                                 **r._asdict()))

    # the redesigned terms pair (both forms) and external-weight pair as
    # launched at each layer: at most 128 registers, no local memory, at
    # least two blocks an SM
    report['bwd_resources'], report['fwd_resources'] = [], []
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        for kind, dd, way in (('terms', md.deg_cap, 'bwd'),
                              ('terms', 0, 'bwd'),
                              ('extw', md.deg_cap, 'bwd'),
                              ('terms', md.deg_cap, 'fwd'),
                              ('terms', 0, 'fwd'),
                              ('extw', md.deg_cap, 'fwd')):
            if kind == 'terms':
                conv = FC(cl.tp, cl.weight_nn, cl.si2, dd, cg_mode='terms')
                tk = conv._terms
                regs, local, per_sm = (tk.fwd_resources(dd) if way == 'fwd'
                                       else tk.bwd_resources(dd))
                smem = 4 * (tk.fwd_plan(dd) if way == 'fwd'
                            else tk.bwd_plan(dd)).words
            else:
                conv = FC(cl.tp, cl.weight_nn, cl.si2, dd, ext_w=True)
                regs, local, per_sm, smem = conv.extw_resources(
                    dev, fwd=way == 'fwd')
            name = 'forward' if way == 'fwd' else 'backward'
            print(f'{kind} {name} (agg_d {dd}), layer {li}: {regs} '
                  f'registers, {local} local bytes, {per_sm} blocks an SM at '
                  f'{smem} shared bytes', flush=True)
            if local or per_sm < 2 or regs > 128:
                raise AssertionError(f'{kind} {name} agg_d {dd} layer {li}:'
                                     f' {regs}, {local}, {per_sm}')
            report[f'{way}_resources'].append(dict(
                layer=li, kernel=kind, agg_d=dd, registers=regs,
                local_bytes=local, blocks_per_sm=per_sm, smem=smem))

    nl = md._grid()
    with recorded() as (records, _):
        e_k, f_k = md._ef_fn(md.state.pos, nl)
    with recorded(keep=lambda i: i in (0, 1, 4)) as (records_g, _):
        e_g, f_g = md_geom._ef_fn(md.state.pos, nl)
    torch.cuda.synchronize()
    records, records_g = list(records.values()), list(records_g.values())
    assert len(records) == 5 and not any(r['kind'] for r in records)
    assert len(records_g) == 3 and all(r['kind'] == 'geom'
                                       for r in records_g)

    # -- phase 2 -------------------------------------------------------
    phase('2 kernels vs plain versions (1k inputs)')
    layers = []
    for li, r in enumerate(records):
        row = dict(layer=li, **compare_kernels(r))
        show(row)
        layers.append(row)
    report['layers'] = layers
    geom_layers = []
    for r in records_g:
        row = dict(layer=r['call'], **compare_kernels(r))
        show(row)
        geom_layers.append(row)
    report['geom_layers_1k'] = geom_layers
    records = records_g = None

    # -- phase 3 -------------------------------------------------------
    phase('3 1k energy and forces')
    with plain_path():
        e_p, f_p = md._ef_fn(md.state.pos, nl)
    report['ef'] = check_ef('kernel path vs plain path', n, e_k, f_k, e_p,
                            f_p)
    report['ef_geom_dense'] = check_ef(
        'geometry-fused branch vs default branch', n, e_g, f_g, e_k, f_k)

    def force_call_ms(engine, reps=10):
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._ef_fn(md.state.pos, nl)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    for engine in (md, md_geom):       # warm
        force_call_ms(engine, 3)
    turns = [force_call_ms(e) for e in (md, md_geom, md_geom, md)]
    report['force_call_ms_1k'] = {
        'default': [turns[0], turns[3]], 'geom_dense': [turns[1], turns[2]]}
    print(f'1k force call, host clock, in turns: default {turns[0]:.3f} / '
          f'{turns[3]:.3f} ms, geometry-fused {turns[1]:.3f} / '
          f'{turns[2]:.3f} ms', flush=True)

    report['ef_chunked_1k'] = {}
    for fused in (True, False):
        md_chunk = MolecularDynamics(model, atoms_1k, device=dev,
                                     conv_chunk_atoms=96, geom_fused=fused,
                                     **MD_KW)
        assert md_chunk.n % 96 and md_chunk.conv_chunk_rows == 96 * md.deg_cap
        fc.reset_launch_counts()
        e_c, f_c = md_chunk._ef_fn(md.state.pos, nl)
        want = dict.fromkeys(fc.launch_counts, 0)
        pair = 'fused_conv_geom' if fused else 'fused_conv'
        want[f'{pair}_fwd'] = want[f'{pair}_bwd'] = 5 * -(-n // 96)
        if fc.launch_counts != want:
            raise AssertionError('chunked 1k force call launched '
                                 f'{fc.launch_counts}, want {want}')
        report['ef_chunked_1k'][pair] = check_ef(
            f'chunks of 96 atoms (remainder 40), {pair} kernels, vs whole '
            'array', n, e_c, f_c, e_k, f_k)
    md_geom = md_chunk = None

    # -- phase 4 -------------------------------------------------------
    phase('4 1k NVT 300 K, dt 2 fs, rebuild every 20')

    report['nvt'] = timed_nvt(md, 40, 200)
    check_launches(report['nvt'], {'fused_conv_fwd': 5, 'fused_conv_bwd': 5})
    md = nl = None
    torch.cuda.empty_cache()

    # -- phase 5 -------------------------------------------------------
    phase(f'5 {N_LARGE} atoms: chunked convolutions, geom kernels')
    t0 = time.perf_counter()
    atoms_big = build_nacl(N_LARGE)
    t_atoms = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = MolecularDynamics(model, atoms_big, device=dev, **MD_KW)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    assert big.n == N_LARGE
    rows, chunk_rows = big.e_cap_model, big.conv_chunk_rows
    if not (chunk_rows > 0 and big._geom_packed_ok()):
        raise AssertionError('the 97k engine did not choose the chunked '
                             'geometry-fused path')
    chunks = -(-rows // chunk_rows)
    t0 = time.perf_counter()
    nl = big._grid()
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    nl2 = big._compact_nl(big._verlet, big.state.pos)
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    nl2 = None
    print(f'{big.n} atoms, deg_cap {big.deg_cap}, grid rows {rows}, chunk '
          f'rows {chunk_rows} ({chunks} chunks, remainder '
          f'{rows % chunk_rows} rows), e_cap {big.e_cap}, cell_cap '
          f'{big.cell_cap}; structure {t_atoms:.2f} s, engine start-up '
          f'{t_engine:.2f} s, first grid (Verlet build + compaction) '
          f'{t_grid:.2f} s, compaction alone {t_compact * 1e3:.1f} ms',
          flush=True)
    pos = big.state.pos
    big._ef_fn(pos, nl)                          # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one full chunk of a mid layer: layer 1, chunk 0
    with recorded(keep=lambda i: i == chunks) as (records, timings):
        t0 = time.perf_counter()
        e_k, f_k = big._ef_fn(pos, nl)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert [len(timings[k]) for k in ROUTES] == [0, 0, 5 * chunks,
                                                 5 * chunks, 0, 0]
    geom_ms = {'fwd': timed_ms(timings['geom_forward']),
               'bwd': timed_ms(timings['geom_backward'])}
    geom_cost = {'fwd': launch_cost(timings['geom_forward'], 'fwd',
                                    geom=True),
                 'bwd': launch_cost(timings['geom_backward'], 'bwd',
                                    geom=True)}
    print(f'97k force call {call_s * 1e3:.1f} ms on the host clock; geom '
          f'kernels {geom_ms["fwd"]:.1f} ms forward + {geom_ms["bwd"]:.1f} '
          f'ms backward in {5 * chunks} launches each; peak memory '
          f'{peak / 2 ** 30:.2f} GiB', flush=True)
    # per layer group: ms a launch and its share of the bound (forward
    # calls run layer by layer, the backward's in reverse)
    geom_by_layer = {}
    for k, route in (('fwd', 'geom_forward'), ('bwd', 'geom_backward')):
        pairs = timings[route]
        for group, layers_in in (('0', (0,)), ('1-3', (1, 2, 3)),
                                 ('4', (4,))):
            sel = [p for i, p in enumerate(pairs)
                   if (i // chunks if k == 'fwd' else 4 - i // chunks)
                   in layers_in]
            g_ms = timed_ms(sel) / len(sel)
            b_ms, b_by = bound(*launch_cost(sel, k, geom=True))
            b_ms /= len(sel)
            geom_by_layer[f'{k} layer {group}'] = {
                'ms_per_launch': g_ms, 'bound_ms_per_launch': b_ms,
                'bound_by': b_by, 'share_of_bound': b_ms / g_ms}
            print(f'geom {k}, layer {group}: {g_ms:.3f} ms a launch, bound '
                  f'{b_ms:.3f} ms ({b_by}), {100 * b_ms / g_ms:.1f} % of '
                  'the bound', flush=True)
    (rec,) = records.values()
    assert rec['args'][0].shape[0] == chunk_rows
    row = dict(layer=1, chunk=0, **compare_kernels(rec, reps_plain=3))
    show(row)
    report['geom_chunk_97k'] = row
    records = rec = timings = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_path(), recorded(keep=lambda i: False) as (_, timings):
        e_p, f_p = big._ef_fn(pos, nl)
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated()
    print(f'plain path: peak memory {peak_plain / 2 ** 30:.2f} GiB',
          flush=True)
    plain_ms = {'fwd': timed_ms(timings['geom_forward']),
                'bwd': timed_ms(timings['geom_backward'])}
    timings = None
    report['ef_97k'] = check_ef('97k chunked kernel path vs chunked plain '
                                'path', big.n, e_k, f_k, e_p, f_p)
    report['large'] = {
        'atoms': big.n, 'deg_cap': big.deg_cap, 'grid_rows': rows,
        'chunk_rows': chunk_rows, 'chunks_per_layer': chunks,
        'structure_s': t_atoms, 'engine_startup_s': t_engine,
        'first_grid_s': t_grid, 'compaction_ms': t_compact * 1e3,
        'force_call_ms': call_s * 1e3, 'geom_kernel_ms': geom_ms,
        'geom_kernel_by_layer': geom_by_layer,
        'geom_plain_ms': plain_ms, 'peak_memory_bytes': peak,
        'peak_memory_plain_bytes': peak_plain}
    e_p = f_p = None
    torch.cuda.empty_cache()

    # -- phase 5b ------------------------------------------------------
    phase(f'5b fault C.4: the chunked plain chain (use_kernels=False), 1k '
          f'and {N_LARGE} atoms')
    report['c4'] = c4 = {}
    md1 = MolecularDynamics(model, atoms_1k, device=dev, **MD_KW)
    nl1 = md1._grid()
    e1, f1 = md1._ef_fn(md1.state.pos, nl1)
    md1p = MolecularDynamics(model, atoms_1k, device=dev, use_kernels=False,
                             conv_chunk_atoms=96, **MD_KW)
    assert md1p.n % 96 and md1p.conv_chunk_rows == 96 * md1.deg_cap
    fc.reset_launch_counts()
    e1p, f1p = md1p._ef_fn(md1.state.pos, nl1)
    torch.cuda.synchronize()
    if any(fc.launch_counts.values()):
        raise AssertionError(f'the chunked plain chain launched '
                             f'{fc.launch_counts}')
    c4['1k'] = check_ef('1k, chunks of 96 atoms on the plain chain '
                        '(use_kernels=False), vs the kernel path', n, e1p,
                        f1p, e1, f1)
    md1 = md1p = nl1 = e1 = f1 = e1p = f1p = None
    t0 = time.perf_counter()
    big_p = MolecularDynamics(model, atoms_big, device=dev,
                              use_kernels=False, **MD_KW)
    torch.cuda.synchronize()
    t_engine_p = time.perf_counter() - t0
    assert (big_p.deg_cap, big_p.conv_chunk_rows) == (big.deg_cap,
                                                      chunk_rows)
    fc.reset_launch_counts()
    calls_ms = []
    for _ in range(2):         # the first call warms the allocator
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        e_pl, f_pl = big_p._ef_fn(pos, nl)
        torch.cuda.synchronize()
        calls_ms.append((time.perf_counter() - t0) * 1e3)
    peak_pl = torch.cuda.max_memory_allocated()
    if any(fc.launch_counts.values()):
        raise AssertionError(f'the 97k plain chain launched '
                             f'{fc.launch_counts}')
    c4['97k'] = check_ef(f'{N_LARGE} atoms, {chunks} chunks of '
                         f'{chunk_rows} rows on the plain chain '
                         '(use_kernels=False), vs the kernel path', big.n,
                         e_pl, f_pl, e_k, f_k)
    c4['97k'].update(engine_startup_s=t_engine_p, force_call_ms=calls_ms,
                     peak_memory_bytes=peak_pl, chunk_rows=chunk_rows,
                     chunks=chunks)
    print(f'97k plain chain (use_kernels=False): force call '
          f'{calls_ms[1]:.1f} ms on the host clock (first {calls_ms[0]:.1f}'
          f' ms), peak memory {peak_pl / 2 ** 30:.2f} GiB (the kernel path: '
          f'{peak / 2 ** 30:.2f} GiB), engine start-up {t_engine_p:.2f} s',
          flush=True)
    big_p = e_pl = f_pl = e_k = f_k = None
    torch.cuda.empty_cache()

    # -- phase 6 -------------------------------------------------------
    phase('6 97k NVT 300 K, dt 2 fs, rebuild every 20')
    torch.cuda.reset_peak_memory_stats()
    report['nvt_97k'] = timed_nvt(big, 10, 10)
    report['nvt_97k']['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
    report['nvt_97k']['chunks_per_layer'] = chunks
    print(f'chunk rows {chunk_rows}, {chunks} chunks per layer, peak memory '
          f'{report["nvt_97k"]["peak_memory_bytes"] / 2 ** 30:.2f} GiB',
          flush=True)
    check_launches(report['nvt_97k'], {'fused_conv_geom_fwd': 5 * chunks,
                                       'fused_conv_geom_bwd': 5 * chunks})

    big = nl = None
    torch.cuda.empty_cache()

    # -- phase 7 -------------------------------------------------------
    phase('7 external-weight kernels vs plain versions (1k inputs, '
          'half_mlp)')
    md = MolecularDynamics(model, atoms_1k, device=dev, **MD_KW)
    md_half = MolecularDynamics(model, atoms_1k, device=dev, half_mlp=True,
                                **MD_KW)
    nl, nl_h = md._grid(), md_half._grid()
    if nl_h.half is None or nl.half is not None:
        raise AssertionError('half list: on only with half_mlp')
    pos = md.state.pos
    e_k, f_k = md._ef_fn(pos, nl)
    with recorded() as (records, _):
        e_h, f_h = md_half._ef_fn(pos, nl_h)
    torch.cuda.synchronize()
    records = list(records.values())
    assert len(records) == 5 and all(r['kind'] == 'extw' for r in records)
    extw_layers = []
    for li, r in enumerate(records):
        row = dict(layer=li, **compare_kernels(r))
        show(row)
        extw_layers.append(row)
    report['extw_layers'] = extw_layers
    records = None

    # -- phase 8 -------------------------------------------------------
    phase('8 1k with half_mlp: energy, forces, force-call time, NVT')
    report['ef_half_mlp'] = check_ef('half_mlp path vs default kernel path',
                                     n, e_h, f_h, e_k, f_k)

    def half_call_ms(engine, grid, reps=10):
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._ef_fn(pos, grid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def call_peak(engine, grid):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine._ef_fn(pos, grid)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    pairs = ((md, nl), (md_half, nl_h))
    for engine, grid in pairs:       # warm
        half_call_ms(engine, grid, 3)
    turns = [half_call_ms(*pairs[i]) for i in (0, 1, 1, 0)]
    peaks = [call_peak(*pr) for pr in pairs]
    with recorded(keep=lambda i: False) as (_, timings):
        md._ef_fn(pos, nl)
        md_half._ef_fn(pos, nl_h)
    kernel_ms = {k: timed_ms(timings[k]) for k in ROUTES}
    timings = None
    report['force_call_half_mlp_1k'] = {
        'default_ms': [turns[0], turns[3]],
        'half_mlp_ms': [turns[1], turns[2]],
        'default_peak_bytes': peaks[0], 'half_mlp_peak_bytes': peaks[1],
        'default_kernel_ms': kernel_ms['forward'] + kernel_ms['backward'],
        'half_mlp_kernel_ms': (kernel_ms['extw_forward']
                               + kernel_ms['extw_backward'])}
    print(f'1k force call, host clock, in turns: default {turns[0]:.3f} / '
          f'{turns[3]:.3f} ms, half_mlp {turns[1]:.3f} / {turns[2]:.3f} ms; '
          f'peak memory {peaks[0] / 2 ** 30:.3f} / {peaks[1] / 2 ** 30:.3f} '
          f'GiB; conv kernels of one call {kernel_ms["forward"]:.3f} + '
          f'{kernel_ms["backward"]:.3f} ms against '
          f'{kernel_ms["extw_forward"]:.3f} + '
          f'{kernel_ms["extw_backward"]:.3f} ms', flush=True)
    # the same warm-up and the first 100 steps of phase 4, from the same
    # velocities: the two trajectories part only by fp32 rounding, so after
    # the same chunks they are at the same temperature (within 10 K; the
    # thermostat swings by ~150 K meanwhile)
    report['nvt_half_mlp'] = timed_nvt(md_half, 40, 100)
    check_launches(report['nvt_half_mlp'], {'fused_conv_extw_fwd': 5,
                                            'fused_conv_extw_bwd': 5})
    t_half = report['nvt_half_mlp']['temperature_K']
    t_def = report['nvt']['temperature_K'][:len(t_half)]
    if len(t_def) != len(t_half):
        raise AssertionError('the half_mlp run took other chunks than the '
                             'default run')
    d_t = abs(t_half[-1] - t_def[-1])
    print(f'temperature after {len(t_half)} chunks with half_mlp and by '
          f'default differ by {d_t:.3f} K', flush=True)
    if not d_t <= 10.0:
        raise AssertionError('the half_mlp trajectory left the default one')
    md = md_half = nl = nl_h = e_h = f_h = None
    torch.cuda.empty_cache()

    # -- phase 9 -------------------------------------------------------
    phase('9 calculator: energy, forces, stress')
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.graph import Atoms
    strain = np.eye(3) + np.array([[0.02, 0.01, 0.008], [0.01, -0.01, 0.015],
                                   [0.008, 0.015, 0.0]])
    sheared = Atoms(atoms_1k.atomic_numbers, atoms_1k.pos @ strain,
                    atoms_1k.cell @ strain, atoms_1k.pbc)
    calc = SevenNetCalculator(model)          # device: the default, 'cuda'
    if calc.device.type != 'cuda':
        raise AssertionError('the calculator did not default to the card')
    report['calculator'] = {}
    edge_layers, edge_launches = [], dict.fromkeys(fc.launch_counts, 0)
    for name, at in (('nacl_1k', atoms_1k), ('sheared_2pct', sheared)):
        calc.calculate(at)         # first call: tables, capacities
        fc.reset_launch_counts()
        with recorded(keep=lambda i: name == 'nacl_1k') as (records,
                                                            timings):
            res = calc.calculate(at)
        launches = dict(fc.launch_counts)
        for li, r in enumerate(records.values()):
            assert r['conv'].agg_d == 0 and not r['kind']
            row = dict(layer=li, **compare_kernels(r))
            show(row)
            edge_layers.append(row)
        records = None
        edge_ms = (timed_ms(timings['forward']),
                   timed_ms(timings['backward']))
        edge_cost = (bound(*launch_cost(timings['forward'], 'fwd')),
                     bound(*launch_cost(timings['backward'], 'bwd')))
        timings = None
        want = dict.fromkeys(fc.launch_counts, 0)
        want['fused_conv_edge_fwd'] = want['fused_conv_edge_bwd'] = 5
        if launches != want:
            raise AssertionError(f'calculator call launched {launches}, '
                                 f'want {want}')
        again = calc.calculate(at)
        with plain_path():
            ref = calc.calculate(at)
        d = {'dE_per_atom': abs(res['energy'] - ref['energy']) / len(at),
             'max_dF': float(np.abs(res['forces'] - ref['forces']).max()),
             'max_dS': float(np.abs(res['stress'] - ref['stress']).max()),
             'rerun_dE': abs(res['energy'] - again['energy']),
             'rerun_max_dF': float(np.abs(res['forces']
                                          - again['forces']).max()),
             'rerun_max_dS': float(np.abs(res['stress']
                                          - again['stress']).max())}
        ok = (d['dE_per_atom'] <= E_TOL_PER_ATOM and d['max_dF'] <= F_TOL
              and d['max_dS'] <= S_TOL
              and all(np.isfinite(res[k]).all()
                      for k in ('forces', 'stress', 'energies'))
              and res['forces'].shape == (len(at), 3)
              and res['stress'].shape == (6,))
        print(f'{name}: E {res["energy"]:.6f} eV, stress '
              f'{np.array2string(res["stress"], precision=6)} eV/A^3; kernel '
              f'vs plain |dE|/N {d["dE_per_atom"]:.3e} (<= {E_TOL_PER_ATOM}), '
              f'max|dF| {d["max_dF"]:.3e} (<= {F_TOL}), max|dS| '
              f'{d["max_dS"]:.3e} (<= {S_TOL}); two kernel runs differ by '
              f'|dE| {d["rerun_dE"]:.3e} eV, max|dF| {d["rerun_max_dF"]:.3e} '
              f'eV/A, max|dS| {d["rerun_max_dS"]:.3e} eV/A^3', flush=True)
        if not ok:
            raise AssertionError(f'calculator on {name}: paths disagree')
        reps = 5
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(reps):
            calc.calculate(at)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / reps * 1e3
        for k, v in fc.launch_counts.items():
            edge_launches[k] += v
            if v != reps * want[k]:
                raise AssertionError(f'{k}: {v} launches in {reps} '
                                     'calculator calls')
        t0 = time.perf_counter()
        for _ in range(reps):
            batch = calc._batch(at)
        torch.cuda.synchronize()
        graph_ms = (time.perf_counter() - t0) / reps * 1e3
        print(f'{name}: {call_ms:.2f} ms per call after the first, of which '
              f'{graph_ms:.2f} ms host graph build and upload; edge rows '
              f'{batch["edge_mask"].shape[0]} ({int(batch["edge_mask"].sum())}'
              f' edges); edge-row kernels: '
              f'{edge_ms[0]:.3f} + {edge_ms[1]:.3f} ms per call (bound '
              f'{edge_cost[0][0]:.3f} + {edge_cost[1][0]:.3f} ms)',
              flush=True)
        report['calculator'][name] = dict(
            d, energy=res['energy'], stress=res['stress'].tolist(),
            call_ms=call_ms, graph_ms=graph_ms, launches=launches,
            edge_rows=int(batch['edge_mask'].shape[0]),
            edges=int(batch['edge_mask'].sum()),
            edge_row_fwd_ms=edge_ms[0], edge_row_bwd_ms=edge_ms[1],
            edge_row_fwd_bound_ms=edge_cost[0][0],
            edge_row_bwd_bound_ms=edge_cost[1][0])
    report['edge_layers'] = edge_layers
    calc = batch = None

    # -- phase 10 ------------------------------------------------------
    phase('10 terms kernels vs plain versions and vs kernels 1-2')
    NPT_KW = dict(MD_KW, ensemble='npt', pressure_gpa=1.0, pdamp_fs=0.02)
    md_c = MolecularDynamics(model, atoms_1k, device=dev, **NPT_KW)
    md_t = MolecularDynamics(model, atoms_1k, device=dev, cg_mode='terms',
                             **NPT_KW)
    nl = md_c._grid()
    pos, cell = md_c.state.pos, md_c.state.cell
    fc.reset_launch_counts()
    with recorded() as (records, _):
        efs_t = md_t._efs_fn(pos, nl, cell)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_terms_fwd'] = want['fused_conv_terms_bwd'] = 5
    if fc.launch_counts != want:
        raise AssertionError(f'terms force call launched {fc.launch_counts}')
    torch.cuda.synchronize()
    records = list(records.values())
    assert len(records) == 5 and all(
        r['conv'].cg_mode == 'terms' and r['conv'].agg_d == md_c.deg_cap
        for r in records)

    def default_twin(conv):
        return FC(conv.tp, conv.mlp, conv.si2, conv.agg_d)

    terms_layers = []
    for li, r in enumerate(records):
        row = dict(layer=li, **compare_kernels(
            r, against=default_twin(r['conv'])))
        show(row)
        terms_layers.append(row)
    report['terms_layers'] = terms_layers
    # the bare tensor product's inputs (phase 13): each layer's xg and sh and
    # the weights the radial MLP gives on them
    tp_inputs = []
    for r in records:
        conv, (xg, sh, emb, ms, mlp_ws, _) = r['conv'], r['args']
        w = conv.mlp.apply({f'w{i}': v for i, v in enumerate(mlp_ws)},
                           emb) * ms
        tp_inputs.append((conv.tp, xg, sh, w.contiguous()))
    calc_t = SevenNetCalculator(model, cg_mode='terms')
    calc_t.calculate(atoms_1k)
    with recorded() as (records, _):
        res_t = calc_t.calculate(atoms_1k)
    terms_edge_layers = []
    for li, r in enumerate(records.values()):
        assert r['conv'].agg_d == 0 and r['conv'].cg_mode == 'terms'
        row = dict(layer=li, **compare_kernels(
            r, against=default_twin(r['conv'])))
        show(row)
        terms_edge_layers.append(row)
    report['terms_edge_layers'] = terms_edge_layers
    records = r = None

    # -- phase 11 ------------------------------------------------------
    phase('11 1k energy, forces, stress: terms vs cmshared vs plain; engine '
          'vs calculator')

    def check_efs(what, a, b):
        out = check_ef(what, n, a[0], a[1], b[0], b[1])
        out['max_dS'] = float((a[2] - b[2]).abs().max())
        print(f'{what}: max|dS| {out["max_dS"]:.3e} eV/A^3 (<= {S_TOL})',
              flush=True)
        if not (out['max_dS'] <= S_TOL and torch.isfinite(a[2]).all()):
            raise AssertionError(f'{what}: stresses disagree')
        return out

    efs_c = md_c._efs_fn(pos, nl, cell)
    with plain_path():
        efs_p = md_c._efs_fn(pos, nl, cell)
    report['efs_terms_vs_cmshared'] = check_efs('terms vs cmshared', efs_t,
                                                efs_c)
    report['efs_terms_vs_plain'] = check_efs('terms vs plain path', efs_t,
                                             efs_p)
    report['efs_cmshared_vs_plain'] = check_efs('cmshared vs plain path',
                                                efs_c, efs_p)
    # model Voigt (xx,yy,zz,xy,yz,zx) -> ASE (xx,yy,zz,yz,xz,xy), sign flipped
    s_engine = -efs_t[2].cpu().numpy()[[0, 1, 2, 4, 5, 3]]
    res_c = SevenNetCalculator(model).calculate(atoms_1k)
    for name, res in (('terms', res_t), ('cmshared', res_c)):
        d_s = float(np.abs(s_engine - res['stress']).max())
        d_f = float(np.abs(efs_t[1].cpu().numpy() - res['forces']).max())
        d_e = abs(float(efs_t[0]) - res['energy']) / n
        print(f'engine (dense grid, terms) vs calculator (edge list, {name}):'
              f' |dE|/N {d_e:.3e} eV/atom, max|dF| {d_f:.3e} eV/A, max|dS| '
              f'{d_s:.3e} eV/A^3 (<= {S_TOL}); stress '
              f'{np.array2string(s_engine, precision=6)}', flush=True)
        if not (d_s <= S_TOL and d_f <= F_TOL and d_e <= E_TOL_PER_ATOM):
            raise AssertionError('engine and calculator disagree')
        report[f'engine_vs_calculator_{name}'] = {
            'dE_per_atom': d_e, 'max_dF': d_f, 'max_dS': d_s}
    calc_t = res_t = res_c = None

    # -- phase 12 ------------------------------------------------------
    phase('12 1k NPT with the terms kernels; npt_aniso and langevin')
    v0 = float(torch.abs(torch.linalg.det(md_t.state.cell)))
    report['npt_terms'] = timed_nvt(md_t, 40, 50)
    check_launches(report['npt_terms'], {'fused_conv_terms_fwd': 5,
                                         'fused_conv_terms_bwd': 5})
    v1 = report['npt_terms']['volume'][-1]
    print(f'volume {v0:.3f} -> {v1:.3f} A^3 ({(v1 / v0 - 1) * 100:.4f} %), '
          f'mean T {report["npt_terms"]["mean_temperature_K"]:.1f} K',
          flush=True)
    if not v1 < v0:
        raise AssertionError('1 GPa did not compress the cell')
    for name, kw in (('npt_aniso', dict(NPT_KW, ensemble='npt_aniso')),
                     ('langevin', dict(MD_KW, ensemble='langevin',
                                       friction_per_fs=0.01))):
        engine = MolecularDynamics(model, atoms_1k, device=dev, **kw)
        out = timed_nvt(engine, 40, 100)
        check_launches(out, {'fused_conv_fwd': 5, 'fused_conv_bwd': 5})
        # the same thermostat as phase 4 rings the same way: for comparison
        print(f'{name}: mean T {out["mean_temperature_K"]:.1f} K, per chunk '
              f'{[round(t, 1) for t in out["temperature_K"]]}; NVT (phase 4) '
              f'{[round(t, 1) for t in report["nvt"]["temperature_K"][:5]]}',
              flush=True)
        if not 150.0 <= out['mean_temperature_K'] <= 450.0:
            raise AssertionError(f'{name}: mean temperature '
                                 f'{out["mean_temperature_K"]:.1f} K')
        if engine.npt:
            c = engine.state.cell
            c0 = torch.as_tensor(atoms_1k.cell, dtype=c.dtype, device=dev)
            asym = float((c - c.T).abs().max())
            moved = float((c - c0).abs().max())
            print(f'{name}: cell moved by {moved:.3e} A, asymmetry '
                  f'{asym:.3e} A', flush=True)
            if not (asym <= 1e-5 and moved > 1e-5 and out['volume'][-1] < v0):
                raise AssertionError(f'{name}: the cell was not '
                                     'symmetrically strained')
            out.update(cell_moved=moved, cell_asymmetry=asym)
        report[name] = out
    md_c = md_t = engine = nl = None

    # -- phase 13 ------------------------------------------------------
    phase('13 bare tensor product: make_fused_tp vs plain')
    gs = [torch.randn(xg.shape[0], ftp.make_fused_tp(spec).d3, device=dev,
                      generator=torch.Generator(dev).manual_seed(li))
          for li, (spec, xg, _, _) in enumerate(tp_inputs)]
    # the op's path: forward and backward through autograd, on all five specs
    fc.reset_launch_counts()
    driven = []
    for (spec, xg, sh, w), g in zip(tp_inputs, gs):
        ins = [t.detach().clone().requires_grad_(True) for t in (xg, sh, w)]
        out = ftp.make_fused_tp(spec)(*ins)
        driven.append((out.detach(), torch.autograd.grad(out, ins, g)))
    torch.cuda.synchronize()
    tp_launches = dict(fc.launch_counts)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_tp_fwd'] = want['fused_tp_bwd'] = len(tp_inputs)
    if tp_launches != want:
        raise AssertionError(f'fused_tp path launched {tp_launches}')
    tp_layers = []
    for li, ((spec, xg, sh, w), g, (out, grads)) in enumerate(
            zip(tp_inputs, gs, driven)):
        op = ftp.make_fused_tp(spec)
        row = {'layer': li, 'rows': xg.shape[0], 'd1': op.d1,
               'w_numel': op.w_numel, 'd3': op.d3}
        y_p = op.plain_forward(xg, sh, w)
        d_p = op.plain_backward(g, xg, sh, w)
        y_k = op.kernel_forward(xg, sh, w)
        d_k = op.kernel_backward(g, xg, sh, w)
        torch.cuda.synchronize()
        if not (torch.equal(y_k, out) and all(
                torch.equal(a, b) for a, b in zip(d_k, grads))):
            raise AssertionError('fused_tp: autograd path != direct launch')
        row['fwd_err'], row['fwd_lim'] = check_close('tp fwd', y_k, y_p)
        for name, a, b in zip(('dxg', 'dsh', 'dw'), d_k, d_p):
            row[f'{name}_err'], row[f'{name}_lim'] = check_close(name, a, b)
        del y_p, d_p, y_k, d_k
        row['fwd_ms'] = cuda_ms(lambda: op.kernel_forward(xg, sh, w))
        row['bwd_ms'] = cuda_ms(lambda: op.kernel_backward(g, xg, sh, w))
        row['fwd_plain_ms'] = cuda_ms(lambda: op.plain_forward(xg, sh, w),
                                      reps=5)
        row['bwd_plain_ms'] = cuda_ms(
            lambda: op.plain_backward(g, xg, sh, w), reps=5)
        row['fwd_flops'], row['bwd_flops'] = ftp.tp_cost(spec, xg.shape[0])
        row['fwd_bytes'], row['bwd_bytes'] = ftp.tp_bytes(spec, xg.shape[0])
        for k in ('fwd', 'bwd'):
            row[f'{k}_bound_ms'], row[f'{k}_bound_by'] = bound(
                row[f'{k}_flops'], row[f'{k}_bytes'])
        show(row)
        tp_layers.append(row)
    report['tp_layers'] = tp_layers
    tp_inputs = gs = driven = None

    # -- phase 14 ------------------------------------------------------
    phase('14 kernels')
    # rows 5-6, kernels 1-2 and their edge-row form (csrc/fused_conv_geom.cu,
    # the template's geom, dense and edge instances): fp32 on the CUDA
    # cores, nothing in local memory
    from sevennet_exp_tpu_torch.tools import sass_compare
    builds = sass_compare.count_and_digests(
        ('fused_conv_geom', 'fused_conv_geom_ssp', 'fused_conv_geom_extw',
         'fused_conv_terms', 'bench_pieces', 'fused_tp'))
    pieces_sass = builds.pop('bench_pieces')
    # the bare TP: the forward (row 9) at its SASS, the redesigned
    # backward's 32 instances (16-byte and 4-byte copies) with nothing in
    # local memory
    counts, digests = builds.pop('fused_tp')
    got = sorted(v for k, v in digests.items() if 'fused_tp_fwd' in k)
    bwd = {k: v for k, v in counts.items() if 'fused_tp_bwd_kernel' in k}
    print(f'fused_tp forward SASS {got} (before: {sorted(TP_FWD_SASS)}); '
          f'{len(bwd)} backward instances', flush=True)
    if got != sorted(TP_FWD_SASS):
        raise AssertionError('fused_tp forward SASS moved')
    for k, v in bwd.items():
        bad = {op: v[op] for op in (*sass_compare.TENSOR_CORE_OPS,
                                    *sass_compare.LOCAL_OPS) if v[op]}
        if bad or not v['FFMA'] or len(bwd) != 32:
            raise AssertionError(f'fused_tp {k}: {len(bwd)} instances, '
                                 f'opcodes {bad}, {v["FFMA"]} FFMA')
    report['fused_tp_sass'] = counts
    # the redesigned pairs: the external-weight pair (the backward at 4, 9,
    # 16 SH, the forward), the terms pair's two forms each way; the
    # external-weight backward at the SASS of its redesign
    for lib in ('fused_conv_geom_extw', 'fused_conv_terms'):
        counts, digests = builds.pop(lib)
        if len(counts) != 4:
            raise AssertionError(f'{lib}: {len(counts)} kernel instances, '
                                 'want 4')
        if lib == 'fused_conv_terms' and \
                sorted(digests.values()) != sorted(TERMS_SASS):
            raise AssertionError(f'terms pair SASS moved: {digests}')
        if lib == 'fused_conv_geom_extw':
            got = {k: v for k, v in digests.items() if 'bwd' in k}
            print(f'external-weight backward against its redesign\'s SASS: '
                  f'{got}', flush=True)
            if sorted(got.values()) != sorted(EXTW_BWD_SASS):
                raise AssertionError(f'external-weight backward SASS moved: '
                                     f'{got}')
        for k, v in counts.items():
            bad = {op: v[op] for op in (*sass_compare.TENSOR_CORE_OPS,
                                        *sass_compare.LOCAL_OPS) if v[op]}
            print(f'{lib} {k}: SASS {v}', flush=True)
            if bad or not v['FFMA']:
                raise AssertionError(f'{lib} {k}: tensor-core or local-memory'
                                     f' opcodes {bad}, {v["FFMA"]} FFMA')
        report[f'{lib}_sass'] = counts
    geom_sass = {}
    for lib, (counts, _) in builds.items():
        got = {k: v for k, v in counts.items() if sass_compare.geom_label(k)}
        if len(got) != 12:
            raise AssertionError(f'{lib}: {len(got)} kernel instances, want '
                                 '3 pairs x (fwd, bwd at 4, 9, 16 SH)')
        geom_sass.update({f'{lib} {k}': v for k, v in got.items()})
    # the silu / tanh instances keep their code
    moved = {}
    for k, v in builds['fused_conv_geom'][1].items():
        key = (sass_compare.geom_pair(k), sass_compare.geom_label(k))
        if key in PARENT_GEOM_SASS and v != PARENT_GEOM_SASS[key]:
            moved[key] = v
    print(f'silu / tanh instances against the parent\'s SASS: '
          f'{"identical" if not moved else moved}', flush=True)
    if moved:
        raise AssertionError(f'SASS moved: {moved}')
    report['geom_sass_moved'] = len(moved)
    for k, v in geom_sass.items():
        bad = {op: v[op] for op in (*sass_compare.TENSOR_CORE_OPS,
                                    *sass_compare.LOCAL_OPS) if v[op]}
        name = k.split()[1]
        print(f'{sass_compare.geom_pair(name)} '
              f'{sass_compare.geom_label(name)} {k}: SASS {v}', flush=True)
        if bad or not v['FFMA']:
            raise AssertionError(f'{k}: tensor-core or local-memory opcodes '
                                 f'{bad}, {v["FFMA"]} FFMA')
    report['geom_sass'] = geom_sass

    def total(key, rows=None):
        return sum(r[key] for r in (layers if rows is None else rows))

    kernels = []
    for name, k, line in (('fused_conv_fwd', 'fwd', 792),
                          ('fused_conv_bwd', 'bwd', 886)):
        errs = ([r['fwd_err'] for r in layers] if k == 'fwd' else
                [r[f'{d}_err'] for r in layers
                 for d in ('dxg', 'dsh', 'demb')])
        b_ms, b_by = bound(total(f'{k}_flops'), total(f'{k}_bytes'))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_conv_geom.cu',
            'status': 'redesigned for Hopper on the geometry-fused pair\'s '
                      'template: csrc/fused_conv_geom.cu',
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['nvt']['launches'][name],
            'max_abs_err': max(errs),
            # per 1k force call: the five conv layers' launches
            'ms': total(f'{k}_ms'), 'plain_ms': total(f'{k}_plain_ms'),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    geom_rows = geom_layers + [report['geom_chunk_97k']]
    for name, k, line in (('fused_conv_geom_fwd', 'fwd', 956),
                          ('fused_conv_geom_bwd', 'bwd', 970)):
        errs = ([r['fwd_err'] for r in geom_rows] if k == 'fwd' else
                [r[f'{d}_err'] for r in geom_rows for d in ('dxg', 'dvec')])
        b_ms, b_by = bound(*geom_cost[k])
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_conv_geom.cu',
            'status': 'redesigned for Hopper: csrc/fused_conv_geom.cu',
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['nvt_97k']['launches'][name],
            'max_abs_err': max(errs),
            # per 97k force call: 5 layers x chunks launches, each timed
            'ms': geom_ms[k], 'plain_ms': plain_ms[k],
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    for name, k, line, grads in (
            ('fused_conv_extw_fwd', 'fwd', 918, ()),
            ('fused_conv_extw_bwd', 'bwd', 926, ('dxg', 'dsh', 'dweff'))):
        errs = [r[f'{d}_err'] for r in extw_layers for d in grads or ('fwd',)]
        b_ms, b_by = bound(total(f'{k}_flops', extw_layers),
                           total(f'{k}_bytes', extw_layers))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_conv_geom.cu',
            'status': 'redesigned for Hopper: csrc/fused_conv_geom.cu '
                      '(fused_conv_geom_extw), ' + (
                          'the dense forward\'s CG, the live weight runs '
                          'by 16-byte loads' if k == 'fwd' else
                          'the dense backward\'s class pass, weights '
                          'streamed as whole rows'),
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['nvt_half_mlp']['launches'][name],
            'max_abs_err': max(errs),
            # per 1k force call with half_mlp: the five layers' launches
            'ms': total(f'{k}_ms', extw_layers),
            'plain_ms': total(f'{k}_plain_ms', extw_layers),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    for name, k, line, grads in (
            ('fused_conv_edge_fwd', 'fwd', 792, ()),
            ('fused_conv_edge_bwd', 'bwd', 886, ('dxg', 'dsh', 'demb'))):
        errs = [r[f'{d}_err'] for r in edge_layers for d in grads or ('fwd',)]
        b_ms, b_by = bound(total(f'{k}_flops', edge_layers),
                           total(f'{k}_bytes', edge_layers))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_conv_geom.cu',
            'status': 'redesigned for Hopper on the dense pair\'s passes, '
                      'si2 group by group, a product over the row tile: '
                      'csrc/fused_conv_geom.cu',
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            # the timed calculator calls of phase 9, both structures
            'launches': edge_launches[name],
            'max_abs_err': max(errs),
            # per calculator call at 1,000 atoms: the five layers' launches
            'ms': total(f'{k}_ms', edge_layers),
            'plain_ms': total(f'{k}_plain_ms', edge_layers),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    for name, k, line, grads in (
            ('fused_conv_terms_fwd', 'fwd', 547, ()),
            ('fused_conv_terms_bwd', 'bwd', 589, ('dxg', 'dsh', 'demb'))):
        both = terms_layers + terms_edge_layers
        errs = [r[f'{d}_err'] for r in both for d in grads or ('fwd',)]
        b_ms, b_by = bound(total(f'{k}_flops', terms_layers),
                           total(f'{k}_bytes', terms_layers))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_conv_terms.cu',
            'status': 'redesigned for Hopper: the CG folded with the ' + (
                'SH per row, si2 at agg_d = 0 a product over the tile'
                if k == 'fwd' else 'message cotangent') + ', register-'
                'blocked MLP products, 16-row tiles, a persistent grid',
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['npt_terms']['launches'][name],
            'max_abs_err': max(errs),
            # per 1k force call on the grid: the five layers' launches
            'ms': total(f'{k}_ms', terms_layers),
            'plain_ms': total(f'{k}_plain_ms', terms_layers),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    for name, k, line, grads in (
            ('fused_tp_fwd', 'fwd', 114, ()),
            ('fused_tp_bwd', 'bwd', 136, ('dxg', 'dsh', 'dw'))):
        errs = [r[f'{d}_err'] for r in tp_layers for d in grads or ('fwd',)]
        b_ms, b_by = bound(total(f'{k}_flops', tp_layers),
                           total(f'{k}_bytes', tp_layers))
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'sevennet_exp_tpu_torch/csrc/fused_tp.cu',
            **({'status': 'redesigned for Hopper: fused_tp_bwd_kernel<NSH, '
                          'LM>, steps of (x entry, 64 channels, '
                          'instruction), the CG compiled in per (l1, l2, '
                          'l3), the next two steps\' operands in a 3-stage '
                          'cp.async ring a warp as 16-byte runs (single '
                          'channels where multiplicities or pointers forbid '
                          'runs), dx and dsh in registers, a persistent '
                          'grid; specs outside its instances run the first '
                          'form, fused_tp_bwd_table_kernel'}
               if k == 'bwd' else {}),
            'replaces': f'sevennet_exp_tpu/ops/pallas_tp.py:{line}',
            'launches': tp_launches[name],
            'max_abs_err': max(errs),
            # the five layers' specs at the 1k grid's 32,000 rows
            'ms': total(f'{k}_ms', tp_layers),
            'plain_ms': total(f'{k}_plain_ms', tp_layers),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })

    # -- phase 15 ------------------------------------------------------
    phase('15 micro-benchmarks: bench_pieces, bench_cgmxu (i1 = 1, 2), '
          'bench_dot, bench_cg, bench_layout, bench_tile')
    kernels += micro_benchmarks(report, dev, cuda_ms, show, pieces_sass)
    if len(kernels) != 33 or any(not kr['launches'] > 0 for kr in kernels):
        raise AssertionError('a kernel of the path was never launched')
    report['kernels'] = kernels

    # -- phase 16 ------------------------------------------------------
    phase('16 fault C.1 on the card; training at 7net-0 width')
    t0 = time.perf_counter()
    conv_routes_on_card(report, dev)
    report['conv_routes']['seconds'] = time.perf_counter() - t0
    training(report, dev, card)

    # -- phase 17 ------------------------------------------------------
    phase('17 D3 in the calculator and the MD engine (1k, 1k NVT, 97k); '
          'the multi-cutoff, modal and FCN-readout models')
    d3_and_variants(report, dev, model, atoms_1k)
    report['script_s'] = time.perf_counter() - t_script
    ends = [t for _, t in _PHASES[1:]] + [time.perf_counter()]
    report['phase_s'] = {name: end - t for (name, t), end
                         in zip(_PHASES, ends)}
    print('seconds by phase: ' + ', '.join(
        f'{name.split()[0]} {v:.1f}' for name, v in report['phase_s'].items())
        + f'; nvcc {report["build_s"]:.1f} of phase 1, C.1 checks '
        f'{report["conv_routes"]["seconds"]:.1f}, CPU first step '
        f'{report["training"]["first_step_cpu_s"]:.1f} and train_v2 '
        f'{report["training"]["train_v2_s"]:.1f} of phase 16', flush=True)
    print(f'whole script {report["script_s"]:.1f} s', flush=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
