"""The port's native serving host on the CPU: ``csrc/sevenn_exec.cpp``
over libtorch's AOTInductor loader, as the C library ``libsevenn_exec``
(through ctypes) and as the manifest host (``-DSEVENN_EXEC_MAIN``: reads
``inputs.manifest`` and ``in_<i>.bin``, writes ``out_<i>.bin``), each on a
CPU artifact of the port's ``deploy`` and held against JAX ``model.apply``
on two padded structures of different edge counts (E 1e-4 eV, F 1e-4
eV/A, S 1e-5 eV/A^3). The counterpart of ``tests/test_pjrt_host.py``'s two
tests for the JAX package's PJRT host."""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch
import yaml

from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu_torch import native_build
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
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp('native_host')
    ckpt = tiny_checkpoint(root)
    dep = D.deploy(ckpt, str(root / 'dep'), n_node=N_NODE, n_edge=N_EDGE,
                   device='cpu')
    with open(os.path.join(dep, 'signature.yaml')) as f:
        sig = yaml.safe_load(f)
    cutoff = float(JCK(ckpt).config['cutoff'])
    cases = []
    for a in LATTICES:
        b = batch(structure(a), cutoff)
        cases.append((b, jax_reference(ckpt, b)))
    return dep, sig, cases, native_build.build_all()


def test_manifest_host_reproduces_jax(setup, tmp_path):
    dep, sig, cases, built = setup
    for b, want in cases:
        work = tmp_path / f"e{int(b['edge_mask'].sum())}"
        work.mkdir()
        for name in ('meta.yaml', 'signature.yaml', 'model.pt2'):
            os.symlink(os.path.join(dep, name), work / name)
        lines = []
        for i, arr in enumerate(program_inputs(b, sig)):
            arr.tofile(work / f'in_{i}.bin')
            dt = 'f32' if arr.dtype == np.float32 else 's32'
            lines.append(f'in_{i}.bin {dt} {arr.ndim} '
                         + ' '.join(map(str, arr.shape)))
        (work / 'inputs.manifest').write_text('\n'.join(lines) + '\n')
        r = subprocess.run([built['exec_host'], str(work)],
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert r.stdout.strip().endswith('ok')
        got = [np.fromfile(work / f'out_{i}.bin', np.float32)
               for i in range(3)]
        assert_efs_close([got[0], got[1].reshape(N_NODE, 3),
                          got[2].reshape(1, 6)], want)


def test_exec_library_reproduces_jax(setup):
    dep, sig, cases, built = setup
    lib = ctypes.CDLL(built['exec_library'])
    assert lib.sevenn_exec_init(dep.encode()) == 0
    try:
        assert lib.sevenn_exec_init(dep.encode()) == 1    # once a process
        nn, ne = ctypes.c_int(), ctypes.c_int()
        assert lib.sevenn_exec_capacity(ctypes.byref(nn),
                                        ctypes.byref(ne)) == 0
        assert (nn.value, ne.value) == (N_NODE, N_EDGE)
        P = ctypes.c_void_p
        for b, want in cases:
            ins = dict(zip((s['name'] for s in sig['inputs']),
                           program_inputs(b, sig)))
            e = np.zeros(1, np.float32)
            f = np.zeros((N_NODE, 3), np.float32)
            s = np.zeros(6, np.float32)
            assert lib.sevenn_exec_run(
                P(ins['atomic_numbers'].ctypes.data),
                P(ins['edge_index'].ctypes.data),
                P(ins['edge_vec'].ctypes.data),
                P(ins['edge_mask'].ctypes.data),
                P(ins['node_mask'].ctypes.data),
                ctypes.c_float(float(ins['cell_volume'][0])),
                P(e.ctypes.data), P(f.ctypes.data), P(s.ctypes.data)) == 0
            assert_efs_close([e, f, s], want)
    finally:
        assert lib.sevenn_exec_free() == 0


def test_init_failures_return_codes(setup, tmp_path):
    """No fallback: a directory without the artifact, or one that names a
    device the host does not run, fails init with its code."""
    dep, _, _, built = setup
    lib = ctypes.CDLL(built['exec_library'])
    assert lib.sevenn_exec_init(str(tmp_path).encode()) == 2
    for name in ('signature.yaml', 'model.pt2'):
        os.symlink(os.path.join(dep, name), tmp_path / name)
    (tmp_path / 'meta.yaml').write_text('device: tpu\n')
    assert lib.sevenn_exec_init(str(tmp_path).encode()) == 5
    (tmp_path / 'meta.yaml').write_text('device: cpu\n')
    os.remove(tmp_path / 'model.pt2')
    (tmp_path / 'model.pt2').write_bytes(b'not a package')
    assert lib.sevenn_exec_init(str(tmp_path).encode()) == 6
    one = ctypes.c_int()
    assert lib.sevenn_exec_capacity(ctypes.byref(one), ctypes.byref(one)) == 1
