"""Fault C.5: a reference checkpoint in torch's legacy (non-zip) format.

``torch.save(..., _use_new_zipfile_serialization=False)`` writes a
protocol-2 pickle that opens with torch's magic number; the port decides
the format by those first bytes and sends the file to ``torch.load``, so
it converts to the same tree as the JAX package's (which tries its native
loader first and falls back). A native file, corrupt or not, still goes to
the native loader, whose errors pass through.
"""

import pickle

import pytest
import torch

from sevennet_exp_tpu import checkpoint as jck
from sevennet_exp_tpu_torch import checkpoint as pck
from test_torch_pth_checkpoint import _assert_trees_equal, _form


def _legacy(path, tmp_path):
    cp = torch.load(path, map_location='cpu', weights_only=False)
    out = tmp_path / 'legacy.pth'
    torch.save(cp, str(out), _use_new_zipfile_serialization=False)
    return str(out)


@pytest.mark.parametrize('old', [False, True], ids=['current', 'old'])
def test_legacy_pth_converts_as_jax(old, tmp_path):
    cfg, jm, jp, path, _ = _form('plain', tmp_path, old)
    legacy = _legacy(path, tmp_path)
    with open(legacy, 'rb') as fh:
        head = fh.read(4)
    assert head == b'\x80\x02\x8a\x0a'
    assert pck.is_torch_archive(legacy)
    cp = pck.SevenNetCheckpoint(legacy)
    assert cp.is_torch and cp.epoch is None
    jcp = jck.SevenNetCheckpoint(legacy)
    _, jconv = jcp.build_model()
    _assert_trees_equal(cp.params, jconv)
    _assert_trees_equal(cp.params, jp)
    assert cp.config == jcp.config
    # the zip archive of the same checkpoint gives the same tree
    _assert_trees_equal(pck.SevenNetCheckpoint(path).params, cp.params)


def test_native_files_still_go_to_the_native_loader(tmp_path, monkeypatch):
    def no_torch(*a, **k):
        raise AssertionError('a native file was handed to torch.load')

    monkeypatch.setattr(pck, 'load_torch_checkpoint', no_torch)
    good = pickle.dumps({'config': {}, 'params': {}, 'epoch': 1},
                        protocol=2)
    # a protocol-2 native pickle opens with 80 02 but not with the magic
    native = tmp_path / 'native.pth.sevennet'
    native.write_bytes(good)
    assert not pck.is_torch_archive(str(native))
    assert pck.SevenNetCheckpoint(str(native)).epoch == 1
    corrupt = tmp_path / 'corrupt.pth.sevennet'
    corrupt.write_bytes(good[:len(good) // 2])
    assert not pck.is_torch_archive(str(corrupt))
    with pytest.raises((pickle.UnpicklingError, EOFError)):
        pck.SevenNetCheckpoint(str(corrupt)).config


def test_corrupt_legacy_file_raises_from_torch(tmp_path):
    cfg, jm, jp, path, _ = _form('plain', tmp_path)
    legacy = _legacy(path, tmp_path)
    with open(legacy, 'rb') as fh:
        data = fh.read()
    cut = tmp_path / 'cut.pth'
    cut.write_bytes(data[:len(data) // 3])
    assert pck.is_torch_archive(str(cut))
    with pytest.raises(Exception) as err:
        pck.SevenNetCheckpoint(str(cut)).config
    assert not isinstance(err.value, AssertionError)
