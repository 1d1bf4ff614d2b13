"""The port's VASP readers (``data/vasp.py``) against the JAX package's,
on an OUTCAR and a ``structure_list`` the test writes itself (the
reference's example OUTCARs are not in the repo): two species, three ionic
steps with stress and a changing cell, an electronic-only energy line
before the first step; a ``structure_list`` with a brace range and index
slices. Every frame equals JAX's: numbers, positions, cell, pbc, energy,
forces, stress and ``info``. Also the ``braceexpand`` and ``string2index``
cases of ``tests/test_vasp.py`` and the dataset dispatch
(``read_structure_file``)."""

import os

import numpy as np
import pytest

from sevennet_exp_tpu.data import dataset as jds
from sevennet_exp_tpu.data import vasp as jv
from sevennet_exp_tpu_torch.data import dataset as pds
from sevennet_exp_tpu_torch.data import vasp as pv

FIELDS = ('atomic_numbers', 'pos', 'cell', 'pbc', 'energy', 'forces',
          'stress', 'info')


def write_outcar(path, seed=0, n_steps=3, reps=1):
    """A minimal OUTCAR: Na and Cl rocksalt (8 * reps^3 atoms), n_steps
    ionic steps with positions, forces, stress and energy from
    default_rng(seed)."""
    rng = np.random.default_rng(seed)
    n_type = 4 * reps ** 3
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    fr_na = np.concatenate([(base + [i, j, k]) / reps for i in range(reps)
                            for j in range(reps) for k in range(reps)])
    frac = np.concatenate([fr_na, (fr_na + 0.5 / reps) % 1.0])
    lines = [' vasp.6.3.0 18Jan22 complex\n',
             ' POTCAR:    PAW_PBE Na_pv 19Sep2006\n',
             ' POTCAR:    PAW_PBE Cl 06Sep2000\n',
             '   VRHFIN =Na: 2p3s\n', '   TITEL  = PAW_PBE Na_pv 19Sep2006\n',
             '   VRHFIN =Cl: s2p5\n', '   TITEL  = PAW_PBE Cl 06Sep2000\n',
             f'   ions per type =               {n_type}   {n_type}\n',
             '  free  energy   TOTEN  =       123.45678900 eV\n']
    for step in range(n_steps):
        a = 5.63 * reps * (1.0 + 0.01 * step)
        cell = np.eye(3) * a + rng.normal(scale=0.02, size=(3, 3))
        pos = frac @ cell + rng.normal(scale=0.05, size=frac.shape)
        forces = rng.normal(scale=0.3, size=frac.shape)
        kb = rng.normal(scale=20.0, size=6)
        rec = np.linalg.inv(cell).T
        lines.append('      direct lattice vectors'
                     '                 reciprocal lattice vectors\n')
        for r in range(3):
            lines.append(''.join(f'{v:13.9f}' for v in cell[r]) + '  '
                         + ''.join(f'{v:13.9f}' for v in rec[r]) + '\n')
        lines.append('  in kB  ' + ''.join(f'{v:12.5f}' for v in kb) + '\n')
        lines.append(' POSITION                                       '
                     'TOTAL-FORCE (eV/Angst)\n')
        lines.append(' ' + '-' * 83 + '\n')
        for p, f in zip(pos, forces):
            lines.append('     ' + ''.join(f'{v:13.5f}' for v in p)
                         + '   ' + ''.join(f'{v:14.6f}' for v in f) + '\n')
        lines.append(' ' + '-' * 83 + '\n')
        e = -3.4 * len(pos) + rng.normal(scale=0.5)
        lines.append(f'  free  energy   TOTEN  =     {e:.8f} eV\n')
        lines.append(f'  energy  without entropy=     {e:.8f}  '
                     f'energy(sigma->0) =     {e:.8f}\n')
    with open(path, 'w') as fh:
        fh.writelines(lines)
    return path


def write_structure_list(dirname):
    for i in (1, 2, 3):
        write_outcar(os.path.join(dirname, f'OUTCAR_{i}'), seed=i)
    path = os.path.join(dirname, 'structure_list')
    with open(path, 'w') as fh:
        fh.write('[label_a]\nOUTCAR_{1..2} ::2\n\n[label_b]\n'
                 'OUTCAR_3 -1\nOUTCAR_1 1:3\n')
    return path


def _same(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(vb, np.ndarray):
            assert va.dtype == vb.dtype, f
            np.testing.assert_array_equal(va, vb, err_msg=f)
        else:
            assert va == vb, f


def test_read_outcar_equals_jax(tmp_path):
    path = write_outcar(str(tmp_path / 'OUTCAR'))
    mine, theirs = pv.read_outcar(path), jv.read_outcar(path)
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        _same(a, b)
    at = mine[1]
    assert sorted(set(at.atomic_numbers.tolist())) == [11, 17]
    assert at.forces.shape == (8, 3) and at.stress.shape == (6,)
    assert not np.array_equal(mine[0].cell, mine[2].cell)
    assert at.info['data_from'] == 'user_OUTCAR'
    for index in ('-1', '1', '0:2', '::2', ':'):
        got = pv.read_outcar(path, index)
        want = jv.read_outcar(path, index)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    with pytest.raises(IndexError):
        pv.read_outcar(path, '7')


def test_structure_list_equals_jax(tmp_path):
    path = write_structure_list(str(tmp_path))
    mine = pv.structure_list_reader(path)
    theirs = jv.structure_list_reader(path)
    assert list(mine) == list(theirs) == ['label_a', 'label_b']
    assert [len(v) for v in mine.values()] == [4, 3]
    for k in theirs:
        for a, b in zip(mine[k], theirs[k]):
            _same(a, b)
    # the dataset's dispatch labels each frame with its section
    frames, jframes = pds.read_structure_file(path), \
        jds.read_structure_file(path)
    assert [f.info['label'] for f in frames] == ['label_a'] * 4 + \
        ['label_b'] * 3
    for a, b in zip(frames, jframes):
        _same(a, b)
    outcar = pds.read_structure_file(str(tmp_path / 'OUTCAR_2'))
    for a, b in zip(outcar, jds.read_structure_file(
            str(tmp_path / 'OUTCAR_2'))):
        _same(a, b)


def test_structure_list_format_errors(tmp_path):
    for body in ('[bad\nOUTCAR 1\n', '[a]\nOUTCAR 1 2\n', 'OUTCAR :\n'):
        path = tmp_path / 'structure_list'
        path.write_text(body)
        with pytest.raises(ValueError):
            pv.structure_list_reader(str(path))
        with pytest.raises(ValueError):
            jv.structure_list_reader(str(path))


def test_species_header_forms():
    hdr = ['   VRHFIN =Hf: 5p5d6s\n', '   VRHFIN =O: s2p4\n']
    assert pv._species_from_header(hdr) == ['Hf', 'O']
    titel = ['   TITEL  = PAW_PBE Hf_pv 06Sep2000\n',
             '   TITEL  = PAW_PBE O 08Apr2002\n']
    assert pv._species_from_header(titel) == \
        jv._species_from_header(titel) == ['Hf', 'O']


def test_braceexpand():
    for expr, want in (('x_{1..3}', ['x_1', 'x_2', 'x_3']),
                       ('{a,b}{1..2}', ['a1', 'a2', 'b1', 'b2']),
                       ('plain', ['plain']),
                       ('n{08..10}', ['n08', 'n09', 'n10']),
                       ('{5..1..-2}', ['5', '3', '1'])):
        assert pv.braceexpand(expr) == jv.braceexpand(expr) == want
    assert pds.braceexpand is pv.braceexpand


def test_string2index():
    for s, want in (('3', 3), (':', slice(None, None, None)),
                    ('1:5:2', slice(1, 5, 2)), ('-1', -1)):
        assert pv.string2index(s) == jv.string2index(s) == want
