"""The port's deploy (``scripts/deploy.py``) on the CPU against the JAX
package's: the artifact directory's metadata and signature key by key, and
the reloaded program -- the ``torch.export`` file and the AOTInductor
package -- against JAX ``model.apply`` on two padded rattled structures of
different edge counts through one artifact (E 1e-4 eV, F 1e-4 eV/A, S 1e-5
eV/A^3), padding rows zero, ``deploy_parallel``'s ``comm_sizes``, and the
no-fallback check of a traced graph (on the card every convolution on the
kernel route must be the edge-pair op pair)."""

import os

import pytest
import torch
import yaml

from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.scripts.deploy import deploy as jdeploy
from sevennet_exp_tpu.scripts.deploy import deploy_parallel as jdeploy_parallel
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
from sevennet_exp_tpu_torch.scripts import deploy as D
from torch_deploy_util import (
    LATTICES,
    N_EDGE,
    N_NODE,
    assert_efs_close,
    batch,
    jax_reference,
    program_inputs,
    structure,
    tiny_checkpoint,
)

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('deploy')
    ckpt = tiny_checkpoint(root)
    jdir = jdeploy(ckpt, str(root / 'jax'), n_node=N_NODE, n_edge=N_EDGE)
    pdir = D.deploy(ckpt, str(root / 'port'), n_node=N_NODE, n_edge=N_EDGE,
                    device='cpu')
    return ckpt, jdir, pdir, root


def _yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


@pytest.fixture(scope='module')
def cases(dirs):
    """The two structures' batches and their JAX E/F/S."""
    ckpt = dirs[0]
    cutoff = float(JCK(ckpt).config['cutoff'])
    out = []
    for a in LATTICES:
        at = structure(a)
        b = batch(at, cutoff)
        out.append((len(at), b, jax_reference(ckpt, b)))
    edges = [int(b['edge_mask'].sum()) for _, b, _ in out]
    assert len(set(edges)) == 2 and max(edges) < N_EDGE, edges
    return out


def test_files_and_metadata_equal_jax(dirs):
    ckpt, jdir, pdir, _ = dirs
    for name in ('config.yaml', 'meta.yaml', 'state.pt', 'signature.yaml',
                 'model_export.pt2', 'model.pt2'):
        assert os.path.exists(os.path.join(pdir, name)), name
    jmeta = _yaml(os.path.join(jdir, 'meta.yaml'))
    pmeta = _yaml(os.path.join(pdir, 'meta.yaml'))
    assert sorted(set(pmeta) - set(jmeta)) == ['device', 'kernel_layers']
    for k, v in jmeta.items():
        assert pmeta[k] == v, k
    assert pmeta['device'] == 'cpu' and pmeta['kernel_layers'] == []
    assert _yaml(os.path.join(pdir, 'signature.yaml')) == _yaml(
        os.path.join(jdir, 'signature.yaml'))
    assert _yaml(os.path.join(pdir, 'config.yaml')) == _yaml(
        os.path.join(jdir, 'config.yaml'))


def test_state_is_the_checkpoint(dirs):
    state = torch.load(os.path.join(dirs[2], 'state.pt'))
    want = SevenNetCheckpoint(dirs[0]).build_model('cpu')[1]
    assert sorted(state) == sorted(want)
    for k, v in want.items():
        assert torch.equal(state[k], v.cpu()), k


@pytest.mark.parametrize('program', ['aoti', 'export'])
def test_artifact_equals_jax_apply(dirs, cases, program):
    art = D.load_deployed(dirs[2], program)
    for n, b, want in cases:
        got = art(*program_inputs(b, art.signature))
        assert [tuple(t.shape) for t in got] == [(1,), (N_NODE, 3), (1, 6)]
        assert all(t.dtype == torch.float32 for t in got)
        assert_efs_close([t.numpy() for t in got], want)


def test_padding_rows_are_zero(dirs, cases):
    art = D.load_deployed(dirs[2])
    for n, b, _ in cases:
        _, f, _ = art(*program_inputs(b, art.signature))
        assert torch.count_nonzero(f[n:]) == 0
        assert torch.isfinite(f).all()


def test_inputs_are_checked_against_the_signature(dirs, cases):
    art = D.load_deployed(dirs[2])
    ins = program_inputs(cases[0][1], art.signature)
    with pytest.raises(ValueError, match='inputs'):
        art(*ins[:-1])
    ins[0] = ins[0][:-1]
    with pytest.raises(ValueError, match='shape'):
        art(*ins)


def test_deploy_parallel_writes_comm_sizes(dirs):
    ckpt, _, _, root = dirs
    jdir = jdeploy_parallel(ckpt, str(root / 'jax_parallel'))
    pdir = D.deploy_parallel(ckpt, str(root / 'port_parallel'), device='cpu')
    pmeta = _yaml(os.path.join(pdir, 'meta.yaml'))
    jmeta = _yaml(os.path.join(jdir, 'meta.yaml'))
    assert pmeta['comm_sizes'] == jmeta['comm_sizes']
    assert len(pmeta['comm_sizes']) == 2
    assert pmeta['comm_size'] == max(pmeta['comm_sizes'])
    assert not os.path.exists(os.path.join(pdir, 'model.pt2'))


def test_graph_without_the_ops_raises(dirs):
    """A graph whose kernel-route convolutions are not the op pair (here
    the CPU's plain chain, held to the card's demand of two layers)
    raises."""
    model = SevenNetCheckpoint(dirs[0]).build_model('cpu')[0]
    assert len(D.kernel_layers(model)) == 2
    gm = D.trace(model, N_NODE, N_EDGE, 'cpu')
    assert D.op_counts(gm) == [0, 0]
    with pytest.raises(RuntimeError, match='edge-pair op'):
        D.check_graph(gm, 2)


def test_export_failure_raises(dirs, tmp_path, monkeypatch):
    """No ``stablehlo_error.txt``-style fallback: a failing export
    raises and leaves no program behind."""
    def fail(*a, **k):
        raise RuntimeError('export failed')
    monkeypatch.setattr(torch.export, 'export', fail)
    with pytest.raises(RuntimeError, match='export failed'):
        D.deploy(dirs[0], str(tmp_path / 'x'), n_node=N_NODE, n_edge=N_EDGE,
                 device='cpu')
    assert not os.path.exists(tmp_path / 'x' / 'model.pt2')
    assert not os.path.exists(tmp_path / 'x' / 'signature.yaml')


def test_cli_get_model_parallel(dirs, tmp_path, capsys):
    """``get_model -p`` (JAX's flags, ``--device cpu``) writes the parallel
    payload that ``deploy_parallel`` writes."""
    from sevennet_exp_tpu_torch.main import cli
    out = tmp_path / 'cli_parallel'
    cli.main(['get_model', dirs[0], '-o', str(out), '-p', '--device', 'cpu'])
    assert f'deployed to {out}' in capsys.readouterr().out
    want = D.deploy_parallel(dirs[0], str(tmp_path / 'direct'), device='cpu')
    for name in ('meta.yaml', 'config.yaml'):
        assert _yaml(out / name) == _yaml(os.path.join(want, name))
    assert not os.path.exists(out / 'model.pt2')


def test_deploy_modules_import_no_jax():
    """The deploy and native-serving modules, imported in a fresh
    interpreter, bring in neither jax nor the JAX package."""
    import subprocess
    import sys
    code = (
        'import sys\n'
        'import sevennet_exp_tpu_torch.scripts.deploy\n'
        'import sevennet_exp_tpu_torch.ops.torch_ops\n'
        'import sevennet_exp_tpu_torch.native_build\n'
        'import sevennet_exp_tpu_torch.main.cli\n'
        'bad = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "jaxlib", "sevennet_exp_tpu")]\n'
        'assert not bad, bad\n')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, '-c', code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_phase20_tool_needs_a_card():
    """tools/phase20.py (chip_smoke's phase 20 alone) exits 2 without a
    card, before it imports chip_smoke or builds anything."""
    from sevennet_exp_tpu_torch.tools import phase20
    assert torch.cuda.is_available() or phase20.main([]) == 2
