"""The port's pretrained keywords (``util.py``), the cases of
``tests/test_pretrained_names.py`` against the port: the same aliases, the
same search roots in the same order, the same errors, and on every case the
same answer as the JAX package."""

import os

import pytest

from sevennet_exp_tpu import util as jutil
from sevennet_exp_tpu_torch import util as putil
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint


def test_tables_equal_jax():
    assert putil._PRETRAINED_ALIASES == jutil._PRETRAINED_ALIASES
    assert putil._PRETRAINED_FILES == jutil._PRETRAINED_FILES


def test_demo_keyword_resolves():
    p = putil.pretrained_name_to_path('7net-0-nacl-demo')
    assert p.endswith('trained_nacl/checkpoint_best.pth.sevennet')
    assert os.path.isfile(p)
    assert putil.pretrained_name_to_path('SevenNet-0-NaCl-Demo') == p
    assert p == jutil.pretrained_name_to_path('7net-0-nacl-demo')


def test_unknown_name_lists_keywords():
    with pytest.raises(ValueError, match='7net-0'):
        putil.pretrained_name_to_path('7net-9000')


def test_known_name_missing_file_reports_search_paths(monkeypatch,
                                                      tmp_path):
    monkeypatch.setenv('SEVENNET_CHECKPOINT_DIR', '/nonexistent-root')
    monkeypatch.setenv('HOME', str(tmp_path))
    with pytest.raises(FileNotFoundError, match='/nonexistent-root') as e:
        putil.pretrained_name_to_path('7net-l3i5')
    with pytest.raises(FileNotFoundError) as ej:
        jutil.pretrained_name_to_path('7net-l3i5')
    assert str(e.value) == str(ej.value)


def test_env_dir_precedence(tmp_path, monkeypatch):
    rel = 'SevenNet_l3i5/checkpoint_l3i5.pth'
    first, second = tmp_path / 'a', tmp_path / 'b'
    for root in (first, second):
        f = root / rel
        f.parent.mkdir(parents=True)
        f.write_bytes(b'x')
    monkeypatch.setenv('SEVENNET_CHECKPOINT_DIR', f'{second}:{first}')
    got = putil.pretrained_name_to_path('7net-l3i5')
    assert got == str(second / rel)
    assert got == jutil.pretrained_name_to_path('7net-l3i5')


def test_home_cache_before_repo_root(tmp_path, monkeypatch):
    monkeypatch.delenv('SEVENNET_CHECKPOINT_DIR', raising=False)
    monkeypatch.setenv('HOME', str(tmp_path))
    f = (tmp_path / '.cache' / 'sevennet_exp_tpu' / 'trained_nacl'
         / 'checkpoint_best.pth.sevennet')
    f.parent.mkdir(parents=True)
    f.write_bytes(b'x')
    got = putil.pretrained_name_to_path('7net-0-nacl-demo')
    assert got == str(f)
    assert got == jutil.pretrained_name_to_path('7net-0-nacl-demo')


def test_resolve_checkpoint_passthrough(tmp_path):
    f = tmp_path / 'cp.pth'
    f.write_bytes(b'x')
    assert putil.resolve_checkpoint(str(f)) == str(f)
    assert putil.resolve_checkpoint('no/such/file.pth') == 'no/such/file.pth'
    assert putil.resolve_checkpoint('7net-0-nacl-demo') == \
        jutil.resolve_checkpoint('7net-0-nacl-demo')


def test_checkpoint_accepts_keyword():
    cp = SevenNetCheckpoint('7net-0-nacl-demo')
    assert os.path.isfile(cp.checkpoint_path)
    assert cp.config['cutoff'] == 5.0


def test_helpers_equal_jax(tmp_path):
    tm = {11: 0, 17: 1}
    assert putil.onehot_to_chem([1, 0, 1], tm) == \
        jutil.onehot_to_chem([1, 0, 1], tm) == ['Cl', 'Na', 'Cl']
    f = tmp_path / 'log.txt'
    assert putil.unique_filepath(str(f)) == str(f)
    f.write_text('')
    (tmp_path / 'log0.txt').write_text('')
    assert putil.unique_filepath(str(f)) == str(tmp_path / 'log1.txt') == \
        jutil.unique_filepath(str(f))
