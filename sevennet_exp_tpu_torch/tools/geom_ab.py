"""Same-call A/B of the geometry-fused conv pair (``fused_conv_geom_fwd`` /
``fused_conv_geom_bwd``) against another build of the same C entries.

    python -m sevennet_exp_tpu_torch.tools.geom_ab OTHER.cu [STEPS] [OUT.json]

OTHER.cu is any source that exports the two entries with the port's ABI,
for example an earlier tree's ``csrc/fused_conv.cu`` (the pair lived there
before its redesign) unpacked with ``git archive``, its headers beside it.
It is compiled with the port's nvcc flags; then, on one card, the two builds
run in turns (other, this, this, other):

  - each kernel at a 97k chunk's shape (16,384 atoms x 32 rows, 6 pad rows
    an atom, random inputs from seed 0) on checkpoint layers 0, 1 and 4: ms
    a launch (``timing.cuda_ms``), and the two builds' outputs against each
    other (relative to max|other|);
  - the 97,336-atom engine's force call: the geom kernels' ms (a pair of
    CUDA events around every launch), host-clock ms and peak device memory;
  - 97k NVT (300 K, 2 fs, rebuild every 20): ms/step over STEPS (default 10)
    steps after a 5-step warm-up.

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
MD_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
             rebuild_every=20, seed=0)


def build_other(src: str, out_dir: str) -> ctypes.CDLL:
    so = os.path.join(out_dir, 'libgeom_other.so')
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, '-o', so,
                    src], check=True, capture_output=True, text=True)
    return fc.bind_geom(ctypes.CDLL(so))


def chunk_inputs(conv, dev, seed=0):
    """One chunk of the 97k leg's shape: edge vectors within the cutoff,
    the last PADS rows of every atom pads (ms = 0, unit vector)."""
    rng = np.random.default_rng(seed)
    rows = CHUNK_ATOMS * D
    rc = conv.geom.cutoff
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
            t(rng.normal(size=(CHUNK_ATOMS, conv.d_out))))


def timed_force_call(md, pos, nl):
    """(geom kernel ms, host-clock ms, peak bytes) of one force call."""
    pairs = []
    FC = fc.FusedConv
    kf, kb = FC.kernel_geom_forward, FC.kernel_geom_backward

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

    FC.kernel_geom_forward, FC.kernel_geom_backward = wrap(kf), wrap(kb)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        md._ef_fn(pos, nl)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        FC.kernel_geom_forward, FC.kernel_geom_backward = kf, kb
    return (sum(a.elapsed_time(b) for a, b in pairs), host,
            torch.cuda.max_memory_allocated())


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
                print(json.dumps({k: (round(v, 4) if isinstance(v, float)
                                      else v) for k, v in turn.items()}),
                      flush=True)
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
    for side in ('other', 'this'):
        turns = [t for t in res['turns'] if t['side'] == side]
        res[f'{side}_mean'] = {k: statistics.mean(t[k] for t in turns)
                               for k in turns[0] if k != 'side'}
        print(side, json.dumps({k: round(v, 3)
                                for k, v in res[f'{side}_mean'].items()}),
              flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    if not require_card('geom_ab'):
        return 2
    res = run(argv[0], int(argv[1]) if len(argv) > 1 else 10)
    if len(argv) > 2:
        os.makedirs(os.path.dirname(os.path.abspath(argv[2])), exist_ok=True)
        with open(argv[2], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
