"""Force-call time and peak memory of the whole-array path with and without
``half_mlp``, over system sizes, on the card.

    python -m sevennet_exp_tpu_torch.tools.half_mlp_sizes

Builds the chip_smoke.py system (trained_nacl checkpoint, NaCl rocksalt)
at 1,000, 4,096, 8,000 and 13,824 atoms -- all below the engine's switch
to chunked convolutions, which do not consult the half list -- and times
one energy-and-forces call of the default path (kernels ``fused_conv_fwd``
/ ``fused_conv_bwd``) and of the ``half_mlp`` path (radial MLP on the half
list by ``torch.matmul``, kernels ``fused_conv_extw_fwd`` /
``fused_conv_extw_bwd``) on the same grid, in turns (default, half, half,
default), on the host clock around a synchronise, with the conv kernels'
own time by CUDA events and the peak memory of one call of each. At
1,000 atoms the host's launches bound the call; from a few thousand atoms
on the device does. Prints one JSON line per size and writes
chiprun_out/half_mlp_sizes.json.
"""

import json
import os
import sys
import time

import torch

from .timing import card as timing_card
from .timing import require_card

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
SIZES = (1000, 4096, 8000, 13824)


def main():
    if not require_card('half_mlp_sizes'):
        return 2
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc

    card = timing_card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    model, _ = SevenNetCheckpoint(CKPT).build_model(device=dev)
    fc.build()

    def call_ms(engine, grid, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._ef_fn(engine.state.pos, grid)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def kernel_ms(engine, grid):
        """Summed time of the fused conv launches of one call."""
        spans = []
        routes = ('forward', 'backward', 'extw_forward', 'extw_backward')
        orig = {r: getattr(fc.FusedConv, r) for r in routes}

        def timed(fn):
            def wrapped(self, *args):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(self, *args)
                b.record()
                spans.append((a, b))
                return out
            return wrapped

        for r in routes:
            setattr(fc.FusedConv, r, timed(orig[r]))
        try:
            engine._ef_fn(engine.state.pos, grid)
        finally:
            for r in routes:
                setattr(fc.FusedConv, r, orig[r])
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans)

    def peak_bytes(engine, grid):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine._ef_fn(engine.state.pos, grid)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated()

    rows = []
    for n_target in SIZES:
        atoms = build_nacl(n_target)
        pairs = []
        for half in (False, True):
            md = MolecularDynamics(model, atoms, device=dev, half_mlp=half,
                                   rebuild_every=20)
            assert md.conv_chunk_rows == 0, 'sizes must stay whole-array'
            pairs.append((md, md._grid()))
        assert pairs[1][1].half is not None and pairs[0][1].half is None
        (e0, f0), (e1, f1) = (md._ef_fn(md.state.pos, g) for md, g in pairs)
        reps = 10 if n_target <= 4096 else 4
        for pr in pairs:
            call_ms(*pr, 2)
        turns = [call_ms(*pairs[i], reps) for i in (0, 1, 1, 0)]
        row = {
            'atoms': pairs[0][0].n, 'grid_rows': pairs[0][0].e_cap_model,
            'default_ms': [turns[0], turns[3]],
            'half_mlp_ms': [turns[1], turns[2]],
            'default_kernel_ms': kernel_ms(*pairs[0]),
            'half_mlp_kernel_ms': kernel_ms(*pairs[1]),
            'default_peak_bytes': peak_bytes(*pairs[0]),
            'half_mlp_peak_bytes': peak_bytes(*pairs[1]),
            'dE_per_atom': abs(float(e0) - float(e1)) / pairs[0][0].n,
            'max_dF': float((f0 - f1).abs().max()),
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        del pairs, md
        torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'half_mlp_sizes.json'), 'w') as fh:
        json.dump({'card': card, 'rows': rows}, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
