"""The port's chunked convolution path on the CPU (mirror of
tests/test_pallas_conv.py::test_geom_packed_chunked_matches_whole).

Energy and forces through ``conv_chunk_atoms`` with a remainder chunk
equal the port's whole-array result and the JAX engine's XLA whole-array
result (|dE| <= 1e-4 eV, max|dF| <= 1e-4 eV/A), geometry-fused and not:

  - tiny config, 216-atom rattled rocksalt (a = 3.2 A), 16-atom chunks
    (13 chunks and a remainder of 8 atoms), random JAX weights;
  - the trained checkpoint at full width on the 64-atom NaCl of
    tests/test_torch_slice.py, 24-atom chunks (remainder 16).

Also: the opt-in geometry-fused whole-array branch, the engine's switch
point (no chunking at 1k, chunking at 97,336 atoms), and a grep that no
module of the port and not chip_smoke.py imports JAX or the JAX package.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from bench import build_nacl
from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    params_from_numpy,
)
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md import engine as pengine
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import fused_conv as pfc

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
E_TOL, F_TOL = 1e-4, 1e-4


def _port_atoms(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _jax_ef(jmodel, jparams, at, **kw):
    jmd = JMD(jmodel, jparams, at, use_pallas=False, **kw)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    e, f = jmd._ef_fn(jmd.state.pos, jnl)
    return float(e), np.array(f)


@pytest.fixture(scope='module')
def tiny():
    cfg = tiny_model_config()
    jmodel = jbuild(cfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(2))
    at = rattled_rocksalt(reps=3, a=3.2, rattle=0.05, seed=3)   # 216 atoms
    model = build_e3_equivariant_model(cfg)
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return dict(model=model, atoms=_port_atoms(at), chunk_atoms=16,
                kw=dict(skin=0.5), ref=_jax_ef(jmodel, jparams, at,
                                               skin=0.5))


@pytest.fixture(scope='module')
def full():
    jmodel, jparams = JCK(CKPT).build_model()
    at = build_nacl(64)
    model, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
    return dict(model=model, atoms=_port_atoms(at), chunk_atoms=24,
                kw=dict(rebuild_every=20),
                ref=_jax_ef(jmodel, jparams, at, rebuild_every=20))


def _system(which, tiny, full):
    return tiny if which == 'tiny' else full


class _Calls:
    """Counts the fused conv's forward and backward calls by route."""

    def __init__(self, monkeypatch):
        self.n = {'forward': 0, 'backward': 0, 'geom_forward': 0,
                  'geom_backward': 0}
        for name in self.n:
            monkeypatch.setattr(pfc.FusedConv, name,
                                self._counted(name,
                                              getattr(pfc.FusedConv, name)))

    def _counted(self, name, fn):
        def wrapped(conv, *args):
            self.n[name] += 1
            return fn(conv, *args)
        return wrapped


def _ef(md):
    e, f = md._ef_fn(md.state.pos, md._grid())
    return float(e), f.numpy()


@pytest.mark.parametrize('geom', [True, False], ids=['geom', 'shared'])
@pytest.mark.parametrize('which', ['tiny', 'full'])
def test_chunked_matches_whole_and_jax(tiny, full, monkeypatch, which, geom):
    s = _system(which, tiny, full)
    whole = MolecularDynamics(s['model'], s['atoms'], device='cpu', **s['kw'])
    assert whole.conv_chunk_rows == 0
    e_w, f_w = _ef(whole)
    md = MolecularDynamics(s['model'], s['atoms'], device='cpu',
                           conv_chunk_atoms=s['chunk_atoms'],
                           geom_fused=geom, **s['kw'])
    assert md.conv_chunk_rows == s['chunk_atoms'] * md.deg_cap
    n_chunks = -(-md.n // s['chunk_atoms'])
    assert md.n % s['chunk_atoms'], 'want a remainder chunk'
    assert md._geom_packed_ok()
    calls = _Calls(monkeypatch)
    e_c, f_c = _ef(md)
    n_conv = s['model'].config[KEY.NUM_CONVOLUTION]
    fwd, bwd = ('geom_forward', 'geom_backward') if geom else \
        ('forward', 'backward')
    want = dict.fromkeys(calls.n, 0)
    want[fwd] = want[bwd] = n_conv * n_chunks
    assert calls.n == want, 'the chunked route did not engage as asked'
    e_j, f_j = s['ref']
    assert abs(e_c - e_w) <= E_TOL and abs(e_c - e_j) <= E_TOL
    assert np.abs(f_c - f_w).max() <= F_TOL
    assert np.abs(f_c - f_j).max() <= F_TOL
    assert np.abs(f_j).max() > 10 * F_TOL


@pytest.mark.parametrize('which', ['tiny', 'full'])
def test_geometry_fused_whole_array_branch(tiny, full, monkeypatch, which):
    """``geom_dense``: the whole-array path through the geometry-fused
    conv gives the default path's energy and forces, and the edge
    embedding then computes no sh/emb."""
    s = _system(which, tiny, full)
    e_w, f_w = _ef(MolecularDynamics(s['model'], s['atoms'], device='cpu',
                                     **s['kw']))
    md = MolecularDynamics(s['model'], s['atoms'], device='cpu',
                           geom_dense=True, **s['kw'])
    assert md.conv_chunk_rows == 0
    calls = _Calls(monkeypatch)
    e_g, f_g = _ef(md)
    n_conv = s['model'].config[KEY.NUM_CONVOLUTION]
    assert calls.n == {'forward': 0, 'backward': 0, 'geom_forward': n_conv,
                       'geom_backward': n_conv}
    assert abs(e_g - e_w) <= E_TOL and np.abs(f_g - f_w).max() <= F_TOL
    data = s['model'].apply_energy(md._graph(md.state.pos, md._grid()))
    assert KEY.EDGE_ATTR not in data and KEY.EDGE_EMBEDDING not in data
    assert KEY.EDGE_BESSEL_COEFFS in data


def test_geom_fused_without_geom_spec_raises(tiny):
    """EDGE_GEOM_PACKED on a convolution without a GeomSpec raises (no
    silent other route)."""
    from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
    md = MolecularDynamics(tiny['model'], tiny['atoms'], device='cpu',
                           skin=0.5)
    data = md._graph(md.state.pos, md._grid())
    data[KEY.EDGE_GEOM_PACKED] = True
    convs = [l for l in tiny['model'].layers.values()
             if isinstance(l, IrrepsConvolution)]
    saved = convs[0].geom
    convs[0].geom = None
    try:
        with pytest.raises(ValueError, match='geometry-fused'):
            tiny['model'].energy(data)
    finally:
        convs[0].geom = saved


def test_chunk_switch_point(full):
    """No chunking at 1k atoms; chunking by itself at 97,336 atoms x the
    grid degree (sizes set on a small engine: nothing of 97k is built)."""
    md = MolecularDynamics(full['model'], full['atoms'], device='cpu')
    deg = md.deg_cap
    assert deg == 32
    md.n = 1000
    assert md.e_cap_model == 32000 and md.conv_chunk_rows == 0
    md.n = pengine.CHUNK_SWITCH_ROWS // deg       # exactly at the switch
    assert md.conv_chunk_rows == 0
    md.n = 97336
    rows = md.conv_chunk_rows
    assert md.e_cap_model == 3114752 > pengine.CHUNK_SWITCH_ROWS
    assert rows > 0 and rows % deg == 0 and rows <= pengine.CHUNK_ROWS
    assert md.e_cap_model % rows, '97,336 atoms leave a remainder chunk'
    md.conv_chunk_atoms = 4096
    assert md.conv_chunk_rows == 4096 * deg
    md.deg_cap = 36                               # a degree that regrew
    md.conv_chunk_atoms = 0
    assert md.conv_chunk_rows % 36 == 0 and md.conv_chunk_rows > 0


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports jax or the JAX
    package, and no environment variable selects a path in the port."""
    pat = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|optax|flax|'
                     r'sevennet_exp_tpu)(\.|\s|$)', re.M)
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for base, _, names in os.walk(os.path.join(ROOT,
                                               'sevennet_exp_tpu_torch')):
        files += [os.path.join(base, n) for n in names if n.endswith('.py')]
    assert len(files) > 20
    for path in files:
        with open(path) as fh:
            src = fh.read()
        assert not pat.search(src), path
        if 'sevennet_exp_tpu_torch' in path:
            assert 'os.environ' not in src, path
