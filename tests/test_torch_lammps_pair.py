"""The port's LAMMPS pair style (``lammps_pair/pair_sevennet_torch.cpp``)
must compile warning-clean against its mock LAMMPS headers and, driven by
the mock LAMMPS world with periodic ghosts (``lammps_pair/harness.cpp``)
over ``libsevenn_exec`` and a CPU artifact of the port's ``deploy``,
reproduce JAX ``model.apply``'s E/F/virial on two structures of different
edge counts through one artifact, with the harness's full neighbour list
holding as many edges as the Python graph builder. The counterpart of
``tests/test_lammps_pair.py``'s two tests, at their harness tolerance."""

import os
import subprocess

import numpy as np
import pytest
import torch

from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu_torch import native_build
from sevennet_exp_tpu_torch.scripts import deploy as D
from torch_deploy_util import (
    LATTICES,
    N_EDGE,
    N_NODE,
    batch,
    jax_reference,
    structure,
    tiny_checkpoint,
)

torch.set_num_threads(2)
SYMBOL = {11: 'Na', 17: 'Cl'}


def test_pair_style_compiles():
    """Warning-clean against the mock LAMMPS API surface (no artifact
    needed)."""
    r = subprocess.run(['g++', *native_build.LAMMPS_FLAGS, '-Wall', '-Wextra',
                        '-Werror', '-fsyntax-only', native_build.PAIR_SRC],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('lammps_pair')
    ckpt = tiny_checkpoint(root)
    dep = D.deploy(ckpt, str(root / 'dep'), n_node=N_NODE, n_edge=N_EDGE,
                   device='cpu')
    return ckpt, dep, native_build.build_all()['harness'], root


@pytest.mark.parametrize('a', LATTICES)
def test_pair_style_matches_model_apply(setup, a):
    ckpt, dep, harness, root = setup
    cutoff = float(JCK(ckpt).config['cutoff'])
    at = structure(a)
    L = np.diag(at.cell)
    assert np.allclose(at.cell, np.diag(L))
    species = sorted(set(int(z) for z in at.atomic_numbers))
    types = [species.index(int(z)) + 1 for z in at.atomic_numbers]
    pos = at.pos % L           # the harness's atoms sit inside the box
    lines = [f'{len(pos)}', ' '.join(f'{v:.17g}' for v in L)]
    lines += [f'{t} {p[0]:.17g} {p[1]:.17g} {p[2]:.17g}'
              for t, p in zip(types, pos)]
    struct = root / f'struct_{a}.txt'
    struct.write_text('\n'.join(lines) + '\n')
    out = root / f'out_{a}.txt'
    r = subprocess.run([harness, dep, repr(cutoff), str(struct), str(out),
                        *(SYMBOL[z] for z in species)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr[-2000:])
    assert 'harness ok' in r.stdout

    b = batch(at, cutoff)
    assert int(r.stdout.split('edges=')[1].split()[0]) == \
        int(b['edge_mask'].sum())
    e_ref, f_ref, s_ref = jax_reference(ckpt, b)
    vals = out.read_text().split('\n')
    n = len(pos)
    e = float(vals[0])
    f = np.array([[float(v) for v in vals[1 + i].split()] for i in range(n)])
    vir = np.array([float(v) for v in vals[1 + n].split()])
    np.testing.assert_allclose(e, float(e_ref[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(f, f_ref[:n], rtol=1e-3, atol=1e-4)
    vir_ref = -s_ref[0][[0, 1, 2, 3, 5, 4]] * float(np.prod(L))
    np.testing.assert_allclose(vir, vir_ref, rtol=1e-3, atol=1e-4)


def test_pair_style_stops_on_a_failed_init(setup, tmp_path):
    """The pair style stops with an error when the host cannot load the
    artifact (no fallback)."""
    _, _, harness, root = setup
    struct = root / 'struct_3.6.txt'
    r = subprocess.run([harness, str(tmp_path), '4.0', str(struct),
                        str(tmp_path / 'o.txt'), 'Na', 'Cl'],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert 'artifact init failed' in r.stderr


def test_patch_lammps_copies_the_pair_style(tmp_path, capsys):
    from sevennet_exp_tpu_torch.main import cli
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'pair_sevennet_torch.h').write_text('old')
    assert cli.main(['patch_lammps', str(src)]) == 0
    printed = capsys.readouterr().out
    assert 'pair_style sevennet_torch' in printed
    assert 'get_model' in printed
    assert (src / 'pair_sevennet_torch.h.bak').read_text() == 'old'
    for fn in cli.PAIR_FILES:
        with open(os.path.join(native_build.PAIR_DIR, fn)) as fh:
            assert (src / fn).read_text() == fh.read()
    assert cli.main(['patch_lammps', str(tmp_path / 'missing')]) == 1
