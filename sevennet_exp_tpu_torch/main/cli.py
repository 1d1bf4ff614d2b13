"""Console entry points of the port (reference sevenn/main/*).

Counterpart of ``sevennet_exp_tpu/main/cli.py``, with the same flags:

  python -m sevennet_exp_tpu_torch.main.cli train input.yaml [-w DIR]
  python -m sevennet_exp_tpu_torch.main.cli preset NAME
  python -m sevennet_exp_tpu_torch.main.cli graph_build SRC... CUTOFF
  python -m sevennet_exp_tpu_torch.main.cli inference CKPT TARGET...
  python -m sevennet_exp_tpu_torch.main.cli cp CKPT [--yaml | ...]

``train`` and ``inference`` run on the card (``--device cpu`` for the
CPU; for ``train`` also ``device: cpu`` in the train section). A
checkpoint argument is a path (native or reference ``.pth``) or a
pretrained keyword. ``train -d`` trains data parallel over the
processes of a launcher, one a device (``torchrun --nproc_per_node=N -m
sevennet_exp_tpu_torch.main.cli train input.yaml -d``; mpirun and srun
with MASTER_ADDR / MASTER_PORT set). ``get_model`` and ``patch_lammps``
(deploy) are not in the port yet.
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
    p.add_argument('-d', '--distributed', action='store_true',
                   help='data parallel over the processes of a launcher '
                        '(torchrun, mpirun, srun), one a device')
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
    if args.distributed:
        config[KEY.IS_DDP] = True
    os.makedirs(args.working_dir, exist_ok=True)
    train_v2(config, args.working_dir, device=args.device)


PRESETS = ('base', 'fine_tune', 'sevennet-0', 'sevennet-l3i5',
           'multi_modal')


def main_preset(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_preset', description='print a preset input yaml')
    p.add_argument('preset', choices=PRESETS)
    args = p.parse_args(argv)
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'presets', f'{args.preset}.yaml')
    with open(path) as f:
        print(f.read())


def main_graph_build(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_graph_build',
        description='preprocess structure files into sevenn_data/')
    p.add_argument('source', nargs='+')
    p.add_argument('cutoff', type=float)
    p.add_argument('-o', '--out', default=os.getcwd())
    p.add_argument('-n', '--name', default='graph')
    args = p.parse_args(argv)

    from ..data.dataset import SevenNetGraphDataset

    ds = SevenNetGraphDataset(
        cutoff=args.cutoff, root=args.out, files=args.source,
        processed_name=args.name, force_reload=True)
    print(f'{len(ds)} graphs -> {ds.processed_path}')
    for k, v in ds.statistics.items():
        if not k.startswith('_') and isinstance(v, dict) and 'mean' in v:
            print(f'{k}: mean {v["mean"]:.6f} std {v["std"]:.6f}')


def main_inference(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_inference',
        description='evaluate a checkpoint on structure files')
    p.add_argument('checkpoint')
    p.add_argument('target', nargs='+')
    p.add_argument('-o', '--output', default='sevenn_infer_result')
    p.add_argument('-b', '--batch', type=int, default=4)
    p.add_argument('-m', '--modal', default=None)
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from ..scripts.inference import inference

    inference(args.checkpoint, args.target, args.output,
              batch_size=args.batch, modal=args.modal, device=args.device)
    print(f'results written to {args.output}')


def main_cp(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_cp', description='checkpoint inspection tool')
    p.add_argument('checkpoint')
    p.add_argument('--yaml', action='store_true',
                   help='print reproduce yaml')
    p.add_argument('--continue-yaml', dest='cont', action='store_true',
                   help='print continue yaml')
    p.add_argument('--append-modal', nargs='+', metavar='NAME',
                   help='append modalities, save to -o (reference '
                        'sevenn_cp --append_modal)')
    p.add_argument('--get-single-modal', metavar='NAME',
                   help='collapse onto one modality, save to -o')
    p.add_argument('-o', '--output', default=None,
                   help='output checkpoint path for modal operations')
    args = p.parse_args(argv)

    import yaml as _yaml

    from ..checkpoint import SevenNetCheckpoint

    cp = SevenNetCheckpoint(args.checkpoint)
    if args.append_modal or args.get_single_modal:
        out = args.output or 'checkpoint_converted.pkl'
        if args.append_modal:
            cp.append_modal(args.append_modal, out)
            print(f'appended modal(s) {args.append_modal} -> {out}')
        else:
            cp.to_single_modal(args.get_single_modal, out)
            print(f'collapsed onto {args.get_single_modal!r} -> {out}')
        return
    if args.yaml or args.cont:
        print(_yaml.safe_dump(
            cp.yaml_dict('continue' if args.cont else 'reproduce'),
            default_flow_style=False))
        return
    cfg = cp.config
    print(f'checkpoint: {cp.checkpoint_path}')
    print(f'epoch: {cp.epoch}')
    for k in ('cutoff', 'channel', 'lmax', 'is_parity',
              'num_convolution_layer', 'irreps_manual',
              'self_connection_type', '_number_of_species', 'version'):
        if k in cfg:
            print(f'{k}: {cfg[k]}')


COMMANDS = {'train': main_sevenn, 'preset': main_preset,
            'graph_build': main_graph_build, 'inference': main_inference,
            'cp': main_cp}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f'usage: python -m sevennet_exp_tpu_torch.main.cli '
              f'{{{",".join(COMMANDS)}}} ...', file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    sys.exit(main())
