"""Readings that a cell's limits are set from: for each seed, the numbers
that ``run.py`` compares, read on the program and -- on the first
``--control`` seeds -- on the control, the reference computed with TF32
matmuls (the nearest precision below the configuration's float32) in the
program's place. One process, one line of JSON a seed; needs the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds 3 --control 3 [--fault train_half_batch]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--seconds', type=float, default=3.0)
    ap.add_argument('--control', type=int, default=3)
    ap.add_argument('--fault', default=None,
                    help='read the program with this fault of '
                         'harness/faults.py planted')
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)

    import contextlib

    from portbench.harness import faults, manifest, md, traffic, train
    if not torch.cuda.is_available():
        print('calibrate needs a CUDA device', file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload, manifest.load_manifest(ROOT))
    mix = traffic.load(cell['workload']['traffic'])
    for i, seed in enumerate(int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        dev = torch.device('cuda')
        plant = (faults.FAULTS[args.fault]() if args.fault
                 else contextlib.nullcontext())
        with plant:
            if mix['kind'] == 'train':
                got = train.calibrate(cell, mix, seed, dev, ROOT,
                                      control=i < args.control)
            else:
                got = md.calibrate(cell, mix, seed, args.seconds, dev, ROOT,
                                   control=i < args.control)
        print(json.dumps({'workload': args.workload, 'seed': seed,
                          'fault': args.fault,
                          'seconds': time.perf_counter() - t0, **got}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
