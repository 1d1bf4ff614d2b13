"""The port's command line (``main/cli.py``) against the JAX package's:
``preset`` prints the same text for all five presets (the port's own
copies of the YAMLs); ``graph_build`` prints the same graph count and
statistics and writes a dataset either package reads; ``cp`` prints the
same summary and the same reproduce and continue YAMLs, for a native
checkpoint and a keyword; ``inference`` writes the four result files;
``python -m sevennet_exp_tpu_torch.main.cli`` dispatches the five
commands and names them when given none."""

import os
import subprocess
import sys

import pytest

from sevennet_exp_tpu.main import cli as jcli
from sevennet_exp_tpu_torch.data.dataset import SevenNetGraphDataset
from sevennet_exp_tpu_torch.main import cli as pcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALID = os.path.join(ROOT, 'nacl_classical_data', 'valid.extxyz')
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')


def _both(capsys, argv, name):
    getattr(pcli, name)(list(argv))
    mine = capsys.readouterr().out
    getattr(jcli, name)(list(argv))
    return mine, capsys.readouterr().out


@pytest.mark.parametrize('preset', list(pcli.PRESETS))
def test_preset_prints_the_jax_text(preset, capsys):
    mine, theirs = _both(capsys, [preset], 'main_preset')
    assert mine == theirs and len(mine) > 100
    with open(os.path.join(ROOT, 'sevennet_exp_tpu_torch', 'presets',
                           f'{preset}.yaml')) as fh:
        assert mine == fh.read() + '\n'


def test_graph_build_equals_jax(tmp_path, capsys):
    pcli.main_graph_build([VALID, '4.0', '-o', str(tmp_path / 'p'),
                           '-n', 'valid'])
    mine = capsys.readouterr().out
    jcli.main_graph_build([VALID, '4.0', '-o', str(tmp_path / 'j'),
                           '-n', 'valid'])
    theirs = capsys.readouterr().out
    assert mine.replace(str(tmp_path / 'p'), '') == \
        theirs.replace(str(tmp_path / 'j'), '')
    assert mine.startswith('41 graphs -> ')
    ds = SevenNetGraphDataset(4.0, root=str(tmp_path / 'p'),
                              processed_name='valid')
    assert len(ds) == 41


@pytest.mark.parametrize('flags', [[], ['--yaml'], ['--continue-yaml']])
@pytest.mark.parametrize('which', [CKPT, '7net-0-nacl-demo'])
def test_cp_equals_jax(which, flags, capsys):
    mine, theirs = _both(capsys, [which, *flags], 'main_cp')
    assert mine == theirs
    assert ('epoch: 227' in mine) if not flags else ('model:' in mine)


def test_inference_writes_the_four_files(tmp_path, capsys):
    from test_torch_inference import FILES, _setup
    ckpt, data = _setup(tmp_path)
    out = str(tmp_path / 'out')
    pcli.main_inference([ckpt, data, '-o', out, '-b', '2',
                         '--device', 'cpu'])
    assert f'results written to {out}' in capsys.readouterr().out
    for name in FILES:
        assert os.path.getsize(os.path.join(out, name)) > 0, name


def test_module_entry_dispatches(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = [sys.executable, '-m', 'sevennet_exp_tpu_torch.main.cli']
    res = subprocess.run(run, cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 2
    assert ('{train,preset,graph_build,inference,cp,get_model,patch_lammps}'
            in res.stderr)
    res = subprocess.run(run + ['preset', 'base'], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and 'model:' in res.stdout


def test_new_modules_import_no_jax(tmp_path):
    """The modules of the user entry points, imported and driven in a
    fresh interpreter (a keyword checkpoint, the native neighbor list, an
    OUTCAR, the CLI): neither jax, optax nor sevennet_exp_tpu may appear in
    sys.modules."""
    from test_torch_vasp import write_outcar
    outcar = write_outcar(str(tmp_path / 'OUTCAR'))
    code = (
        'import sys\n'
        'import sevennet_exp_tpu_torch.util\n'
        'import sevennet_exp_tpu_torch.data.native\n'
        'import sevennet_exp_tpu_torch.data.atoms_dataset\n'
        'import sevennet_exp_tpu_torch.data.modal_dataset\n'
        'import sevennet_exp_tpu_torch.scripts.convert_modality\n'
        'import sevennet_exp_tpu_torch.scripts.processing_continue\n'
        'import sevennet_exp_tpu_torch.scripts.inference\n'
        'import sevennet_exp_tpu_torch.scripts.train\n'
        'from sevennet_exp_tpu_torch.main import cli\n'
        'from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint\n'
        'from sevennet_exp_tpu_torch.data import vasp, neighborlist\n'
        'cp = SevenNetCheckpoint("7net-0-nacl-demo")\n'
        'assert len(cp.params) > 5 and cp.epoch == 227\n'
        f'at = vasp.read_outcar({outcar!r})[0]\n'
        'neighborlist.neighbor_list(at.pos, at.cell, at.pbc, 4.0)\n'
        'cli.main(["preset", "base"])\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "optax", "sevennet_exp_tpu")]\n'
        'assert not bad, bad\n'
        'print("clean", neighborlist.ROUTE["last"])\n'
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert 'clean' in res.stdout
