"""Same-call A/B of the 1k NVT step between two trees of the port.

    python -m sevennet_exp_tpu_torch.tools.nvt_ab TREE_A TREE_B [rounds] [steps]

TREE_A and TREE_B are roots of two checkouts (for example the parent
unpacked with ``git archive`` into ``_ab/parent``, and ``.``), each with
``sevennet_exp_tpu_torch/`` and ``trained_nacl/``. Runs the chip_smoke.py
1k NVT leg (trained_nacl, ``build_nacl(1000)``, 300 K, dt 2 fs, rebuild
every 20, seed 0; 40 warm-up steps, then ``steps`` timed, default 200) in
a fresh process per run, with each tree's own package, in the order
A B B A, ``rounds`` times (default 2). Builds each tree's
``fused_conv_geom`` library first, both at once. Prints one JSON line a
run (host-clock ms per timed step, force calls, launches of kernels 1-2)
and then the mean and median ms/step of each side. The host bounds this
leg, so the two sides differ only by host code or by the machine; the
alternating order spreads the machine's drift over both.
"""

import json
import os
import statistics
import subprocess
import sys

from .timing import card as timing_card
from .timing import require_card

BUILD = ("from sevennet_exp_tpu_torch.ops import cuda_build; "
         "cuda_build.build_all(['fused_conv_geom'])")

RUN = """
import json, sys, time
import torch
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
from sevennet_exp_tpu_torch.data.graph import build_nacl
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.ops import fused_conv as fc
torch.backends.cuda.matmul.allow_tf32 = False
steps = int(sys.argv[1])
dev = torch.device('cuda')
model, _ = SevenNetCheckpoint(
    'trained_nacl/checkpoint_best.pth.sevennet').build_model(device=dev)
md = MolecularDynamics(model, build_nacl(1000), dt_fs=2.0,
                       temperature_K=300.0, ensemble='nvt',
                       rebuild_every=20, seed=0, device=dev)
md.run(40)
torch.cuda.synchronize()
calls = [0]
ef0 = md._ef_fn
def counted(*args):
    calls[0] += 1
    return ef0(*args)
md._ef_fn = counted
fc.reset_launch_counts()
t0 = time.perf_counter()
md.run(steps)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
print(json.dumps({'ms_per_step': wall / steps * 1e3, 'force_calls': calls[0],
                  'launches': {k: v for k, v in fc.launch_counts.items()
                               if v}}))
"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__.strip().splitlines()[2].strip(), file=sys.stderr)
        return 2
    if not require_card('nvt_ab'):
        return 2
    trees = {'A': os.path.abspath(argv[0]), 'B': os.path.abspath(argv[1])}
    rounds = int(argv[2]) if len(argv) > 2 else 2
    steps = int(argv[3]) if len(argv) > 3 else 200
    print(timing_card(), flush=True)
    # `python -c` puts its working directory first on sys.path: each run
    # imports the package of the tree it runs in
    builds = [subprocess.Popen([sys.executable, '-c', BUILD], cwd=root)
              for root in trees.values()]
    if any(p.wait() for p in builds):
        print('nvt_ab: a build failed', file=sys.stderr)
        return 1
    times = {'A': [], 'B': []}
    for side in 'ABBA' * rounds:
        root = trees[side]
        out = subprocess.run([sys.executable, '-c', RUN, str(steps)],
                             cwd=root, capture_output=True, text=True)
        if out.returncode:
            print(out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        times[side].append(res['ms_per_step'])
        print(json.dumps({'side': side, 'tree': root, **res}), flush=True)
    for side, ms in times.items():
        print(json.dumps({'side': side, 'tree': trees[side], 'runs': len(ms),
                          'mean_ms_per_step': statistics.mean(ms),
                          'median_ms_per_step': statistics.median(ms)}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
