"""Profile the NVT step on the card with torch.profiler.

    python -m sevennet_exp_tpu_torch.tools.profile_md [atoms] [half_mlp]

Builds the chip_smoke.py system (trained_nacl checkpoint, NaCl rocksalt
of ``atoms`` atoms, default 1,000; 97336 is the large leg, which runs the
chunked geometry-fused convolutions), 300 K, dt 2 fs, rebuild every 20
steps. The second word ``half_mlp`` traces the step with the radial MLP
on the half list and the external-weight kernels (whole-array path, so
at 1,000 atoms). Warms up, then traces a window of steps (20, or 5 above 20,000
atoms) with CPU and CUDA activities. Prints the wall time per step, the
summed device kernel time per step and the device's idle share
(1 - kernel time / wall), and the top kernels by device time; writes the
summary and the op table under chiprun_out/. The trace slows the host, so
the same number of steps is also timed untraced just before the window:
the kernels take the same time either way, and 1 - kernel time / untraced
wall is the idle share of the step users run.
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


def main():
    if not require_card('profile_md'):
        return 2
    atoms = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    variant = sys.argv[2] if len(sys.argv) > 2 else ''
    if variant not in ('', 'half_mlp'):
        print(f'profile_md: unknown variant {variant!r}', file=sys.stderr)
        return 2
    steps, warm = (5, 2) if atoms > 20000 else (20, 40)
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from torch.profiler import ProfilerActivity, profile

    card = timing_card()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    model, _ = SevenNetCheckpoint(CKPT).build_model(device=dev)
    md = MolecularDynamics(model, build_nacl(atoms), dt_fs=2.0,
                           temperature_K=300.0, ensemble='nvt',
                           rebuild_every=20, seed=0, device=dev,
                           half_mlp=variant == 'half_mlp')
    md.run(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    md.run(steps)
    torch.cuda.synchronize()
    untraced_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        md.run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    kernels = sorted(
        (e for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: -e.self_device_time_total)
    step_ms = wall / steps * 1e3
    dev_ms = dev_us / 1e3 / steps
    summary = {
        'card': card, 'atoms': md.n, 'variant': variant, 'steps': steps,
        'rebuild_every': md.rebuild_every,
        'chunk_rows': md.conv_chunk_rows, 'wall_ms_per_step': step_ms,
        'device_kernel_ms_per_step': dev_ms,
        'device_idle_share': 1.0 - dev_ms / step_ms,
        'untraced_ms_per_step': untraced_ms,
        'device_idle_share_untraced': 1.0 - dev_ms / untraced_ms,
        'launches_per_step': sum(e.count for e in kernels) / steps,
        'top_kernels': [
            {'name': e.key[:90], 'ms_per_step':
             e.self_device_time_total / 1e3 / steps,
             'calls_per_step': e.count / steps}
            for e in kernels[:25]],
    }
    print(json.dumps({k: v for k, v in summary.items()
                      if k != 'top_kernels'}), flush=True)
    for k in summary['top_kernels']:
        print(f"{k['ms_per_step']:9.3f} ms/step {k['calls_per_step']:7.1f} "
              f"calls/step  {k['name']}")
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    tag = f'{md.n}_{variant}' if variant else f'{md.n}'
    with open(os.path.join(out_dir, f'profile_md_{tag}.json'), 'w') as fh:
        json.dump(summary, fh, indent=1)
    table = os.path.join(out_dir, f'profile_md_table_{tag}.txt')
    with open(table, 'w') as fh:
        fh.write(events.table(sort_by='self_cpu_time_total', row_limit=60))
    return 0


if __name__ == '__main__':
    sys.exit(main())
