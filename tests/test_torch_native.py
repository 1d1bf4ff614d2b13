"""The port's native neighbor list (``data/native.py``, built from
``csrc/neighbor.cpp`` into ``_build/``) against the port's cKDTree path and
the JAX package's ``neighbor_list``:

  - the same edge set, sorted by (i, j, shift), on periodic, triclinic,
    open and mixed-pbc cells of 60 atoms (as ``tests/test_data.py``):
    centers, neighbors and shifts equal, vectors within 1e-12 A (the C++
    list groups edges by center, and within a center orders them by cell
    bin);
  - the routes: ``SEVENN_NO_NATIVE`` selects cKDTree, the library lands
    under ``_build/`` with the source's hash in its name, the JAX package's
    ``runtime/libsevenn_native.so`` is neither read nor written, a failed
    compile raises with the compiler's message, no ``g++`` falls back with
    one warning;
  - the calculator's E/F/S do not depend on the route (1e-4 eV,
    1e-4 eV/A, 1e-5 eV/A^3).
"""

import hashlib
import os
import shutil

import numpy as np
import pytest
import torch

from sevennet_exp_tpu.data.neighborlist import neighbor_list as jnl
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.data import native
from sevennet_exp_tpu_torch.data import neighborlist as pnl
from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LIB = os.path.join(ROOT, 'runtime', 'libsevenn_native.so')
needs_gxx = pytest.mark.skipif(shutil.which('g++') is None,
                               reason='no g++ on PATH: nothing to compile')
torch.set_num_threads(2)


def _cell(kind):
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 9, size=(60, 3))
    if kind == 'periodic':
        return pos, np.eye(3) * 9.0 + rng.normal(scale=0.4, size=(3, 3)), \
            [True] * 3
    if kind == 'triclinic':
        return pos, np.array([[9.0, 0, 0], [4.5, 8.2, 0], [3.1, 2.7, 8.6]]), \
            [True] * 3
    if kind == 'open':
        return pos, np.zeros((3, 3)), [False] * 3
    return pos, np.eye(3) * 9.0, [True, False, True]


def _sorted(res):
    ei, ej, vec, shift = res
    shift = np.asarray(shift).astype(np.int64)
    o = np.lexsort((shift[:, 2], shift[:, 1], shift[:, 0], ej, ei))
    return ei[o], ej[o], shift[o], np.asarray(vec)[o]


def _ckdtree(*args):
    old = os.environ.get('SEVENN_NO_NATIVE')
    os.environ['SEVENN_NO_NATIVE'] = '1'
    try:
        return pnl.neighbor_list(*args)
    finally:
        if old is None:
            os.environ.pop('SEVENN_NO_NATIVE')
        else:
            os.environ['SEVENN_NO_NATIVE'] = old


@needs_gxx
@pytest.mark.parametrize('kind', ['periodic', 'triclinic', 'open',
                                  'mixed'])
def test_edge_sets_equal_ckdtree_and_jax(kind, monkeypatch):
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    pos, cell, pbc = _cell(kind)
    mine = pnl.neighbor_list(pos, cell, pbc, 4.0)
    assert pnl.ROUTE['last'] == 'native'
    ckd = _ckdtree(pos, cell, pbc, 4.0)
    assert pnl.ROUTE['last'] == 'ckdtree'
    theirs = jnl(pos, cell, pbc, 4.0)
    a = _sorted(mine)
    assert len(a[0]) > 300
    assert np.all(np.diff(mine[0]) >= 0)      # grouped by center
    for other in (_sorted(ckd), _sorted(theirs)):
        for x, y in zip(a[:3], other[:3]):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a[3], other[3], rtol=0, atol=1e-12)
    assert mine[0].dtype == mine[1].dtype == mine[3].dtype == np.int64


def _sha(path):
    with open(path, 'rb') as fh:
        return hashlib.sha1(fh.read()).hexdigest()


@needs_gxx
def test_library_lives_under_build_and_runtime_is_untouched(monkeypatch):
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    before = _sha(JAX_LIB) if os.path.exists(JAX_LIB) else None
    lib = native.get_library()
    assert lib is not None
    path = native.library_path()
    with open(native.SRC_PATH, 'rb') as fh:
        digest = hashlib.sha1(fh.read()).hexdigest()[:12]
    assert path == os.path.join(native.BUILD_DIR,
                                f'libsevenn_neighbor_{digest}.so')
    assert os.path.dirname(native.BUILD_DIR) == os.path.join(
        ROOT, 'sevennet_exp_tpu_torch')
    assert os.path.exists(path)
    pnl.neighbor_list(*_cell('periodic'), 4.0)
    after = _sha(JAX_LIB) if os.path.exists(JAX_LIB) else None
    assert before == after
    with open(native.__file__) as fh:
        assert 'libsevenn_native' not in fh.read()
    # the port's source is the JAX package's runtime/neighbor.cpp, code
    # for code (the header comment says how the port builds it)
    strip = lambda t: t[t.index('#include <cmath>'):]  # noqa: E731
    with open(native.SRC_PATH) as a, \
            open(os.path.join(ROOT, 'runtime', 'neighbor.cpp')) as b:
        assert strip(a.read()) == strip(b.read())


def test_no_native_switch_selects_ckdtree(monkeypatch):
    monkeypatch.setenv('SEVENN_NO_NATIVE', '1')
    n0 = pnl.ROUTE['ckdtree']
    assert native.get_library() is None
    assert native.native_neighbor_list(*_cell('periodic'), 4.0) is None
    pnl.neighbor_list(*_cell('periodic'), 4.0)
    assert pnl.ROUTE['last'] == 'ckdtree' and pnl.ROUTE['ckdtree'] == n0 + 1


def test_no_compiler_falls_back_with_one_warning(monkeypatch, tmp_path):
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, '_WARNED', False)
    monkeypatch.setattr(native, 'library_path',
                        lambda: str(tmp_path / 'absent.so'))
    monkeypatch.setattr(native.shutil, 'which', lambda name: None)
    with pytest.warns(UserWarning, match='g\\+\\+'):
        assert native.get_library() is None
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert native.get_library() is None
        pnl.neighbor_list(*_cell('periodic'), 4.0)
    assert pnl.ROUTE['last'] == 'ckdtree'


@needs_gxx
def test_failed_compile_raises_with_the_compiler_message(monkeypatch,
                                                          tmp_path):
    bad = tmp_path / 'neighbor.cpp'
    bad.write_text('extern "C" int sevenn_neighbor_list( {\n')
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    monkeypatch.setattr(native, '_LIB', None)
    monkeypatch.setattr(native, 'SRC_PATH', str(bad))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / '_build'))
    with pytest.raises(RuntimeError, match=r'(?s)g\+\+ failed.*error:'):
        native.get_library()
    with pytest.raises(RuntimeError):
        pnl.neighbor_list(*_cell('periodic'), 4.0)


@needs_gxx
def test_calculator_does_not_depend_on_the_route(monkeypatch):
    monkeypatch.delenv('SEVENN_NO_NATIVE', raising=False)
    from samples import tiny_model_config
    cfg = tiny_model_config({'lmax': 1, 'num_convolution_layer': 2})
    model = build_e3_equivariant_model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(3))
    from sevennet_exp_tpu_torch.model.model import flatten
    model.load_state(flatten(params))
    at = build_nacl(64, rattle=0.15, seed=1)
    at = Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)
    calc = SevenNetCalculator(model, device='cpu')
    nat = calc.calculate(at)
    assert pnl.ROUTE['last'] == 'native'
    monkeypatch.setenv('SEVENN_NO_NATIVE', '1')
    ckd = calc.calculate(at)
    assert pnl.ROUTE['last'] == 'ckdtree'
    assert abs(nat['energy'] - ckd['energy']) <= 1e-4
    assert np.abs(nat['forces'] - ckd['forces']).max() <= 1e-4
    assert np.abs(nat['stress'] - ckd['stress']).max() <= 1e-5
    assert np.abs(nat['forces']).max() > 1e-3
