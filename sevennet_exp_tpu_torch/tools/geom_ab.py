"""Same-call A/B of the geometry-fused conv pair (``fused_conv_geom_fwd`` /
``fused_conv_geom_bwd``), with ``--dense`` of the dense-grid pair (kernels
1-2, ``fused_conv_fwd`` / ``fused_conv_bwd``), with ``--edge`` of the edge
pair (kernels 1-2 at ``agg_d = 0``, ``fused_conv_edge_fwd`` /
``fused_conv_edge_bwd``), against another build of the same C entries.

    python -m sevennet_exp_tpu_torch.tools.geom_ab OTHER.cu [STEPS] [OUT.json] [--dense | --edge]

OTHER.cu is any source that exports the two entries with the port's ABI,
for example an earlier tree's ``csrc/fused_conv.cu`` (both pairs lived
there before their redesigns) unpacked with ``git archive``, its headers
beside it. It is compiled with the port's nvcc flags; then, on one card,
the two builds run in turns (other, this, this, other). The geometry-fused
pair:

  - each kernel at a 97k chunk's shape (16,384 atoms x 32 rows, 6 pad rows
    an atom, random inputs from seed 0) on checkpoint layers 0, 1 and 4: ms
    a launch (``timing.cuda_ms``), and the two builds' outputs against each
    other (relative to max|other|);
  - the 97,336-atom engine's force call: the geom kernels' ms (a pair of
    CUDA events around every launch), host-clock ms and peak device memory;
  - 97k NVT (300 K, 2 fs, rebuild every 20): ms/step over STEPS (default 10)
    steps after a 5-step warm-up.

The dense-grid pair (``--dense``):

  - each kernel on the 1k grid's shape (1,000 atoms x 32 rows, 6 pad rows
    an atom, sh and emb of random edge vectors, seed 0) on the checkpoint's
    five layers, and the two builds' outputs against each other;
  - the wave tail: layer 1's kernels at WAVE_ATOMS atoms, whole rounds of
    the persistent blocks (396 forward, 264 backward on an H100) around
    1,000 atoms;
  - the whole-array force call at 1,000 and at 8,000 atoms (256,000 grid
    rows): the dense kernels' ms, host-clock ms and peak device memory;
  - 1k NVT: ms/step over STEPS (default 100) steps after a 5-step warm-up.

The edge pair (``--edge``; OTHER.cu for example an earlier tree's
``csrc/fused_conv.cu``, where the pair lived before its redesign):

  - each kernel on the 1k calculator's rows (31,232, the last 5,232 pads as
    the calculator pads its list, sh and emb of random edge vectors, seed 0)
    on the checkpoint's five layers, and the two builds' outputs against
    each other;
  - the calculator call at 1,000 and at 8,000 atoms: the edge kernels' ms
    (a pair of CUDA events around every launch), host-clock ms and peak
    device memory.

Prints one line per measurement and the means of each side; writes them to
OUT.json when given. Needs a card (exits 2 without one).
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import fused_conv as fc
from .timing import card, cuda_ms, require_card

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
CHECKPOINT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
N_LARGE = 97336
CHUNK_ATOMS, D, PADS = 16384, 32, 6
DENSE_ATOMS = (1000, 8000)       # the dense pair's force calls
EDGE_ROWS, EDGE_EDGES = 31232, 26000   # the 1k calculator's padded list
# forward rounds 2, 2.67, 3 and backward rounds 3, 4, 4.5 of 132 SMs x 3
# (forward) and x 2 (backward) blocks; 1,000 atoms are 2.53 and 3.79
WAVE_ATOMS = (792, 1056, 1188)
MD_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
             rebuild_every=20, seed=0)


def build_other(src: str, out_dir: str, pair: str = 'geom') -> ctypes.CDLL:
    so = os.path.join(out_dir, 'libgeom_other.so')
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, '-o', so,
                    src], check=True, capture_output=True, text=True)
    bind = {'geom': fc.bind_geom, 'dense': fc.bind_dense,
            'edge': fc.bind_edge}[pair]
    return bind(ctypes.CDLL(so))


def chunk_inputs(conv, dev, seed=0, atoms=CHUNK_ATOMS, geom=None):
    """One chunk of the 97k leg's shape (or ``atoms`` atoms): edge vectors
    within the cutoff of ``geom`` (default the conv's), the last PADS rows
    of every atom pads (ms = 0, unit vector)."""
    rng = np.random.default_rng(seed)
    rows = atoms * D
    rc = (geom or conv.geom).cutoff
    u = rng.normal(size=(rows, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = u * rng.uniform(0.5 * rc, 0.99 * rc, size=(rows, 1))
    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = (np.arange(rows) % D) >= D - PADS
    ms[pad] = 0.0
    vec[pad] = [1.0, 0.0, 0.0]

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    coeffs = np.arange(1, conv.nb + 1) * np.pi / rc
    return (t(rng.normal(size=(rows, conv.d1))), t(vec), t(ms), t(coeffs),
            t(rng.normal(size=(atoms, conv.d_out))))


def dense_inputs(conv, geom, dev, atoms, seed=0):
    """The dense pair's (xg, sh, emb, ms, g): ``chunk_inputs`` at ``atoms``
    atoms, sh and emb the rows' geometry (``fused_conv.geom_rows``)."""
    xg, vec, ms, coeffs, g = chunk_inputs(conv, dev, seed, atoms, geom)
    emb, sh = fc.geom_rows(vec, coeffs, geom)
    return xg, sh.contiguous(), emb.contiguous(), ms, g


def edge_inputs(conv, geom, dev, seed=0):
    """The edge pair's (xg, sh, emb, ms, g) on the 1k calculator's rows:
    EDGE_ROWS rows of which the first EDGE_EDGES are edges (random vectors
    within the cutoff) and the rest pads (ms = 0, unit vector)."""
    rng = np.random.default_rng(seed)
    rc = geom.cutoff
    u = rng.normal(size=(EDGE_ROWS, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = u * rng.uniform(0.5 * rc, 0.99 * rc, size=(EDGE_ROWS, 1))
    ms = rng.uniform(0.01, 0.05, size=(EDGE_ROWS, 1))
    ms[EDGE_EDGES:] = 0.0
    vec[EDGE_EDGES:] = [1.0, 0.0, 0.0]

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    coeffs = t(np.arange(1, conv.nb + 1) * np.pi / rc)
    emb, sh = fc.geom_rows(t(vec), coeffs, geom)
    return (t(rng.normal(size=(EDGE_ROWS, conv.d1))), sh.contiguous(),
            emb.contiguous(), t(ms), t(rng.normal(size=(EDGE_ROWS,
                                                        conv.d_out))))


def timed_calculator_call(calc, atoms):
    """(edge kernel ms, host-clock ms, peak bytes) of one calculator call
    after the first."""
    pairs = []
    FC = fc.FusedConv
    kf, kb = FC.kernel_forward, FC.kernel_backward

    def wrap(fn):
        def wrapped(self, *args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(self, *args)
            b.record()
            pairs.append((a, b))
            return out
        return wrapped

    calc.calculate(atoms)
    FC.kernel_forward, FC.kernel_backward = wrap(kf), wrap(kb)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        calc.calculate(atoms)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        FC.kernel_forward, FC.kernel_backward = kf, kb
    return (sum(a.elapsed_time(b) for a, b in pairs), host,
            torch.cuda.max_memory_allocated())


def run_edge(other_src: str):
    """The edge pair's A/B (see the module docstring)."""
    from ..calculator import SevenNetCalculator
    from ..checkpoint import SevenNetCheckpoint
    from ..data.graph import build_nacl
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'other': os.path.abspath(other_src),
           'pair': 'edge', 'turns': []}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {'other': build_other(other_src, tmp, 'edge'),
                'this': fc._geom_lib()}
        geom_lib = fc._geom_lib
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            convs = {}
            for layer in range(5):
                cl = model.layers[f'{layer}_convolution']
                conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
                convs[layer] = (conv, cl._weights(),
                                edge_inputs(conv, cl.geom, dev))
            # one calculator a size: its padded capacities only grow
            systems = {n: (SevenNetCalculator(model, device=dev),
                           build_nacl(n)) for n in DENSE_ATOMS}
            for side in ('other', 'this', 'this', 'other'):
                fc._geom_lib = lambda lib=libs[side]: lib
                turn = {'side': side}
                for layer, (conv, (mlp_ws, si2_ws), ins) in convs.items():
                    xg, sh, emb, ms, g = ins
                    turn[f'layer{layer}_fwd_ms'] = cuda_ms(
                        lambda: conv.kernel_forward(xg, sh, emb, ms, mlp_ws,
                                                    si2_ws))
                    turn[f'layer{layer}_bwd_ms'] = cuda_ms(
                        lambda: conv.kernel_backward(g, xg, sh, emb, ms,
                                                     mlp_ws, si2_ws))
                for n, (calc, atoms) in systems.items():
                    (turn[f'calculator_{n}_kernel_ms'],
                     turn[f'calculator_{n}_host_ms'],
                     turn[f'calculator_{n}_peak_bytes']) = \
                        timed_calculator_call(calc, atoms)
                _show(turn)
                res['turns'].append(turn)
            for layer, (conv, (mlp_ws, si2_ws), ins) in convs.items():
                xg, sh, emb, ms, g = ins
                outs = {}
                for side in ('other', 'this'):
                    fc._geom_lib = lambda lib=libs[side]: lib
                    outs[side] = (
                        conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws),
                        *conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                              si2_ws))
                res[f'layer{layer}_rel_diff'] = [
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(outs['this'], outs['other'])]
                print(f'layer {layer}: out / dxg / dsh / demb of the two '
                      f'builds differ by {res[f"layer{layer}_rel_diff"]} of '
                      'max|other|', flush=True)
        finally:
            fc._geom_lib = geom_lib
    return _means(res)


def timed_force_call(md, pos, nl, dense=False):
    """(conv kernel ms, host-clock ms, peak bytes) of one force call: the
    geom pair's launches, or with ``dense`` the dense pair's."""
    pairs = []
    FC = fc.FusedConv
    names = (('kernel_forward', 'kernel_backward') if dense
             else ('kernel_geom_forward', 'kernel_geom_backward'))
    kf, kb = (getattr(FC, n) for n in names)

    def wrap(fn):
        def wrapped(self, *args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(self, *args)
            b.record()
            pairs.append((a, b))
            return out
        return wrapped

    setattr(FC, names[0], wrap(kf))
    setattr(FC, names[1], wrap(kb))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        md._ef_fn(pos, nl)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(FC, names[0], kf)
        setattr(FC, names[1], kb)
    return (sum(a.elapsed_time(b) for a, b in pairs), host,
            torch.cuda.max_memory_allocated())


def _means(res):
    for side in ('other', 'this'):
        turns = [t for t in res['turns'] if t['side'] == side]
        res[f'{side}_mean'] = {k: statistics.mean(t[k] for t in turns)
                               for k in turns[0] if k != 'side'}
        print(side, json.dumps({k: round(v, 3)
                                for k, v in res[f'{side}_mean'].items()}),
              flush=True)
    return res


def _show(turn):
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in turn.items()}), flush=True)


def run_dense(other_src: str, steps: int = 100):
    """The dense pair's A/B (see the module docstring)."""
    from ..checkpoint import SevenNetCheckpoint
    from ..data.graph import build_nacl
    from ..md.engine import MolecularDynamics
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'other': os.path.abspath(other_src),
           'pair': 'dense', 'turns': []}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {'other': build_other(other_src, tmp, 'dense'),
                'this': fc._geom_lib()}
        geom_lib = fc._geom_lib
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            convs = {}
            for layer in range(5):
                cl = model.layers[f'{layer}_convolution']
                conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, D)
                convs[layer] = (conv, cl._weights(),
                                dense_inputs(conv, cl.geom, dev, 1000))
            wave = {n: dense_inputs(convs[1][0],
                                    model.layers['1_convolution'].geom, dev,
                                    n) for n in WAVE_ATOMS}
            mds = {}
            for n in DENSE_ATOMS:
                md = MolecularDynamics(model, build_nacl(n), device=dev,
                                       **MD_KW)
                if md.conv_chunk_rows or md.deg_cap != D:
                    raise RuntimeError(f'{n} atoms: not the whole-array '
                                       f'grid of {D} rows an atom')
                mds[n] = (md, md._grid())
            for side in ('other', 'this', 'this', 'other'):
                fc._geom_lib = lambda lib=libs[side]: lib
                turn = {'side': side}
                for layer, (conv, (mlp_ws, si2_ws), ins) in convs.items():
                    xg, sh, emb, ms, g = ins
                    turn[f'layer{layer}_fwd_ms'] = cuda_ms(
                        lambda: conv.kernel_forward(xg, sh, emb, ms, mlp_ws,
                                                    si2_ws))
                    turn[f'layer{layer}_bwd_ms'] = cuda_ms(
                        lambda: conv.kernel_backward(g, xg, sh, emb, ms,
                                                     mlp_ws, si2_ws))
                conv, (mlp_ws, si2_ws), _ = convs[1]
                for n, ins in wave.items():
                    xg, sh, emb, ms, g = ins
                    turn[f'wave_{n}_fwd_ms'] = cuda_ms(
                        lambda: conv.kernel_forward(xg, sh, emb, ms, mlp_ws,
                                                    si2_ws))
                    turn[f'wave_{n}_bwd_ms'] = cuda_ms(
                        lambda: conv.kernel_backward(g, xg, sh, emb, ms,
                                                     mlp_ws, si2_ws))
                for n, (md, nl) in mds.items():
                    timed_force_call(md, md.state.pos, nl, dense=True)
                    (turn[f'force_call_{n}_kernel_ms'],
                     turn[f'force_call_{n}_host_ms'],
                     turn[f'force_call_{n}_peak_bytes']) = timed_force_call(
                        md, md.state.pos, nl, dense=True)
                md = mds[1000][0]
                md.run(5)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                md.run(steps)
                torch.cuda.synchronize()
                turn['nvt_1k_ms_per_step'] = (time.perf_counter() - t0) \
                    / steps * 1e3
                _show(turn)
                res['turns'].append(turn)
            for layer, (conv, (mlp_ws, si2_ws), ins) in convs.items():
                xg, sh, emb, ms, g = ins
                outs = {}
                for side in ('other', 'this'):
                    fc._geom_lib = lambda lib=libs[side]: lib
                    outs[side] = (
                        conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws),
                        *conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                              si2_ws))
                res[f'layer{layer}_rel_diff'] = [
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(outs['this'], outs['other'])]
                print(f'layer {layer}: out / dxg / dsh / demb of the two '
                      f'builds differ by {res[f"layer{layer}_rel_diff"]} of '
                      'max|other|', flush=True)
        finally:
            fc._geom_lib = geom_lib
    return _means(res)


def run(other_src: str, steps: int = 10):
    from ..checkpoint import SevenNetCheckpoint
    from ..data.graph import build_nacl
    from ..md.engine import MolecularDynamics
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'other': os.path.abspath(other_src), 'turns': []}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {'other': build_other(other_src, tmp), 'this': fc._geom_lib()}
        geom_lib = fc._geom_lib
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            convs = {}
            for layer in (0, 1, 4):
                cl = model.layers[f'{layer}_convolution']
                conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, D,
                                    geom=cl.geom)
                convs[layer] = (conv, cl._weights())
            md = MolecularDynamics(model, build_nacl(N_LARGE), device=dev,
                                   **MD_KW)
            nl = md._grid()
            for side in ('other', 'this', 'this', 'other'):
                fc._geom_lib = lambda lib=libs[side]: lib
                turn = {'side': side}
                for layer, (conv, (mlp_ws, si2_ws)) in convs.items():
                    xg, vec, ms, coeffs, g = chunk_inputs(conv, dev)
                    turn[f'layer{layer}_fwd_ms'] = cuda_ms(
                        lambda: conv.kernel_geom_forward(
                            xg, vec, ms, coeffs, mlp_ws, si2_ws),
                        reps=5, warm=1)
                    turn[f'layer{layer}_bwd_ms'] = cuda_ms(
                        lambda: conv.kernel_geom_backward(
                            g, xg, vec, ms, coeffs, mlp_ws, si2_ws),
                        reps=5, warm=1)
                    del xg, vec, ms, coeffs, g
                torch.cuda.empty_cache()
                timed_force_call(md, md.state.pos, nl)          # warm
                (turn['force_call_geom_ms'], turn['force_call_host_ms'],
                 turn['force_call_peak_bytes']) = timed_force_call(
                    md, md.state.pos, nl)
                md.run(5)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                md.run(steps)
                torch.cuda.synchronize()
                turn['nvt_ms_per_step'] = (time.perf_counter() - t0) \
                    / steps * 1e3
                _show(turn)
                res['turns'].append(turn)
            # the two builds' outputs on one chunk of each layer
            for layer, (conv, (mlp_ws, si2_ws)) in convs.items():
                args = chunk_inputs(conv, dev, seed=1)
                outs = {}
                for side in ('other', 'this'):
                    fc._geom_lib = lambda lib=libs[side]: lib
                    outs[side] = (conv.kernel_geom_forward(
                        *args[:4], mlp_ws, si2_ws),
                        *conv.kernel_geom_backward(args[4], *args[:4],
                                                   mlp_ws, si2_ws))
                res[f'layer{layer}_rel_diff'] = [
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(outs['this'], outs['other'])]
                print(f'layer {layer}: out / dxg / dvec of the two builds '
                      f'differ by {res[f"layer{layer}_rel_diff"]} of '
                      'max|other|', flush=True)
                del outs, args
        finally:
            fc._geom_lib = geom_lib
    return _means(res)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dense, edge = '--dense' in argv, '--edge' in argv
    argv = [a for a in argv if a not in ('--dense', '--edge')]
    if not argv or (dense and edge):
        print(next(ln.strip() for ln in __doc__.splitlines()
                   if 'python -m' in ln), file=sys.stderr)
        return 2
    if not require_card('geom_ab'):
        return 2
    if edge:
        res = run_edge(argv[0])
    elif dense:
        res = run_dense(argv[0], int(argv[1]) if len(argv) > 1 else 100)
    else:
        res = run(argv[0], int(argv[1]) if len(argv) > 1 else 10)
    if len(argv) > 2:
        os.makedirs(os.path.dirname(os.path.abspath(argv[2])), exist_ok=True)
        with open(argv[2], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
