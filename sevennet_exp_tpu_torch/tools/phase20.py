"""Phase 20 of ``chip_smoke.py`` alone (deploy and native serving): deploy
trained_nacl at the phase's capacities (1,024 atoms, 32,768 edges), then
the artifact in Python, through ``libsevenn_exec``, its host and the
LAMMPS harness against the calculator on the 1k NaCl, with the deploy's
seconds and the artifact call's ms against the calculator's model call.

    python -m sevennet_exp_tpu_torch.tools.phase20 [OUT.json]

Run from the root of a checkout (it imports ``chip_smoke.py`` there). A
second run on the same machine finds Inductor's cache (under TMPDIR) and
Triton's (under HOME) warm, so two runs give the AOTInductor compile
without and with them. Needs a card (exits 2 without one).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

from .timing import require_card


def run() -> dict:
    import chip_smoke
    from .. import native_build
    from ..checkpoint import SevenNetCheckpoint
    from ..data.graph import build_nacl
    from ..ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    gxx = {'paths': native_build.build_all()}
    cuda_build.build_all(['fused_conv_geom'])
    gxx['s'] = time.perf_counter() - t0
    dev = torch.device('cuda')
    model, _ = SevenNetCheckpoint(chip_smoke.CHECKPOINT).build_model(
        device=dev)
    report = {}
    t0 = time.perf_counter()
    chip_smoke.deploy_and_serving(report, dev, model, build_nacl(1000), card,
                                  [], gxx)
    res = dict(report['deploy'], card=card, builds_s=gxx['s'],
               phase_s=time.perf_counter() - t0)
    print(f'phase 20: {res["phase_s"]:.1f} s (builds before it '
          f'{res["builds_s"]:.1f} s) [{card}]', flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('phase20'):
        return 2
    sys.path.insert(0, os.getcwd())
    res = run()
    if argv:
        with open(argv[0], 'w') as fh:
            json.dump(res, fh, indent=1, default=str)
    return 0


if __name__ == '__main__':
    sys.exit(main())
