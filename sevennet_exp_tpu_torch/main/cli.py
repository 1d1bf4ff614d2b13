"""Console entry points of the port (reference sevenn/main/*).

Counterpart of ``sevennet_exp_tpu/main/cli.py``, with the same flags:

  python -m sevennet_exp_tpu_torch.main.cli train input.yaml [-w DIR]
  python -m sevennet_exp_tpu_torch.main.cli preset NAME
  python -m sevennet_exp_tpu_torch.main.cli graph_build SRC... CUTOFF
  python -m sevennet_exp_tpu_torch.main.cli inference CKPT TARGET...
  python -m sevennet_exp_tpu_torch.main.cli cp CKPT [--yaml | ...]
  python -m sevennet_exp_tpu_torch.main.cli get_model CKPT [-o DIR] [-p]
  python -m sevennet_exp_tpu_torch.main.cli patch_lammps [LAMMPS/src]

``train`` and ``inference`` run on the card (``--device cpu`` for the
CPU; for ``train`` also ``device: cpu`` in the train section). A
checkpoint argument is a path (native or reference ``.pth``) or a
pretrained keyword. ``train -d`` trains data parallel over the
processes of a launcher, one a device (``torchrun --nproc_per_node=N -m
sevennet_exp_tpu_torch.main.cli train input.yaml -d``; mpirun and srun
with MASTER_ADDR / MASTER_PORT set). ``get_model`` deploys a checkpoint
(``scripts/deploy.py``: an AOTInductor artifact at fixed capacities
``--n-node`` / ``--n-edge``, for the card unless ``--device cpu``;
``-p``: the parallel payload without a program); ``patch_lammps`` prints
the recipe of the LAMMPS pair style ``sevennet_torch`` and copies its
sources into a LAMMPS ``src/``.
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


def main_get_model(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_get_model',
        description='deploy a checkpoint as a serving artifact')
    p.add_argument('checkpoint')
    p.add_argument('-o', '--output', default=None)
    p.add_argument('-p', '--parallel', action='store_true')
    p.add_argument('--n-node', type=int, default=64,
                   help='node capacity of the exported program')
    p.add_argument('--n-edge', type=int, default=1024,
                   help='edge capacity of the exported program')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from ..scripts.deploy import deploy, deploy_parallel

    if args.parallel:
        out = deploy_parallel(args.checkpoint,
                              args.output or 'deployed_parallel',
                              device=args.device)
    else:
        out = deploy(args.checkpoint, args.output or 'deployed_serial',
                     n_node=args.n_node, n_edge=args.n_edge,
                     device=args.device)
    print(f'deployed to {out}')


PAIR_FILES = ('pair_sevennet_torch.cpp', 'pair_sevennet_torch.h')


def main_patch_lammps(argv=None):
    p = argparse.ArgumentParser(
        prog='sevenn_patch_lammps',
        description='stage the LAMMPS integration files (the pair style '
                    'sevennet_torch and libsevenn_exec)')
    p.add_argument('lammps_src', nargs='?', default=None,
                   help='LAMMPS src/ directory to copy the pair style '
                        'into (omit to print the recipe only)')
    args = p.parse_args(argv)

    from .. import native_build

    print(
        'To drive a deployed potential from LAMMPS (one process a rank, '
        'serial per rank):\n'
        '  1. python -m sevennet_exp_tpu_torch.main.cli get_model '
        '<checkpoint> -o deployed_serial --n-node N --n-edge E\n'
        '  2. libsevenn_exec.so: sevennet_exp_tpu_torch.native_build.'
        'exec_library() (g++ against the installed PyTorch)\n'
        '  3. python -m sevennet_exp_tpu_torch.main.cli patch_lammps '
        '<lammps>/src   (copies the pair style from '
        f'{native_build.PAIR_DIR})\n'
        '  4. rebuild LAMMPS with libsevenn_exec.so on its link line:\n'
        '       target_link_libraries(lammps PRIVATE '
        '${SEVENN_EXEC_DIR}/libsevenn_exec.so)\n'
        '     (legacy make: LIB += -L$(SEVENN_EXEC_DIR) -lsevenn_exec)\n'
        '  then: pair_style sevennet_torch deployed_serial; '
        'pair_coeff * * <element of each atom type>')
    if args.lammps_src:
        if not os.path.isdir(args.lammps_src):
            print(f'error: {args.lammps_src} is not a directory')
            return 1
        import shutil
        for fn in PAIR_FILES:
            dst = os.path.join(args.lammps_src, fn)
            if os.path.exists(dst):
                shutil.copy(dst, dst + '.bak')
                print(f'backed up existing {fn} -> {fn}.bak')
            shutil.copy(os.path.join(native_build.PAIR_DIR, fn), dst)
        print(f'copied {", ".join(PAIR_FILES)} to {args.lammps_src}')
    return 0


COMMANDS = {'train': main_sevenn, 'preset': main_preset,
            'graph_build': main_graph_build, 'inference': main_inference,
            'cp': main_cp, 'get_model': main_get_model,
            'patch_lammps': main_patch_lammps}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(f'usage: python -m sevennet_exp_tpu_torch.main.cli '
              f'{{{",".join(COMMANDS)}}} ...', file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == '__main__':
    sys.exit(main())
