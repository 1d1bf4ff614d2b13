"""Console entry point of the port's training (reference sevenn/main/*).

Counterpart of ``sevennet_exp_tpu/main/cli.py::main_sevenn``:

  python -m sevennet_exp_tpu_torch.main.cli train input.yaml [-w DIR]

trains from input.yaml on the card (``--device cpu`` or ``device: cpu``
in the train section for the CPU). The JAX package's six other commands
are not in the port yet (ROADMAP A.6).
"""

from __future__ import annotations

import argparse
import os
import sys


def main_sevenn(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn', description='train a SevenNet potential (PyTorch)')
    p.add_argument('input_yaml', help='input.yaml (model/train/data)')
    p.add_argument('-w', '--working_dir', default=os.getcwd())
    p.add_argument('-s', '--screen', action='store_true',
                   help='also print the log to stdout')
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--device', default=None,
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from .. import _keys as KEY
    from ..logger import Logger
    from ..parse_input import read_config_yaml
    from ..scripts.train import train_v2

    Logger(screen=args.screen)
    config = read_config_yaml(args.input_yaml)
    if args.seed is not None:
        config[KEY.RANDOM_SEED] = args.seed
    os.makedirs(args.working_dir, exist_ok=True)
    train_v2(config, args.working_dir, device=args.device)


COMMANDS = {'train': main_sevenn}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f'usage: python -m sevennet_exp_tpu_torch.main.cli '
              f'{{{",".join(COMMANDS)}}} ...', file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    sys.exit(main())
