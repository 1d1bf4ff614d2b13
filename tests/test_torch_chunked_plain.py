"""The chunked convolution's plain branch on the CPU (fault C.4): a layer the
kernels do not fuse runs the plain chain chunk by chunk, as the JAX package
runs it (a scan of ``jax.checkpoint`` pieces, JAX ``model/layers.py``).

Two models of each of tests/test_torch_chunked.py's systems, forced to chunk
with a remainder chunk:

  - tiny config, 216-atom rattled rocksalt (a = 3.2 A), 16-atom chunks,
    random JAX weights; full width on the 64-atom NaCl, 24-atom chunks;
  - ``use_kernels=False`` (the tiny model and the trained checkpoint: every
    layer on the plain chain), and one refused layer (fault C.3's si2
    fan-out: a layer's output irreps repeat a non-scalar irrep; the tiny
    config and the trained checkpoint's full-width config, random JAX
    weights; the other layers keep the fused conv).

In both: energy and forces equal the whole-array plain path and the JAX
engine's XLA path (|dE| <= 1e-4 eV, max|dF| <= 1e-4 eV/A); no fused conv
call reaches the refused layer (none at all with the kernels off) and no
kernel is launched; each chunk of a plain layer runs twice (forward and
the checkpoint's recomputation); and a gradient of the forces taken with
``create_graph=True`` (every layer on the plain chain, as the trainer
runs) matches the whole-array one within 1e-4 of its largest entry.
"""

import copy

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
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model import layers as L
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import cuda_build
from sevennet_exp_tpu_torch.ops import fused_conv as pfc

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
E_TOL, F_TOL = 1e-4, 1e-4
# a layer's output irreps that repeat 1o (2e) as separate entries: its si2
# input entry of that irrep feeds two output entries (fault C.3), so the
# kernels refuse that layer and only that one
TINY_FANOUT = ['4x0e', '4x0e+2x1o+2x2e+2x1o', '4x0e+4x1o+4x2e', '4x0e']
FULL_FANOUT_AT = 2, '128x0e+32x1e+32x2e+32x1e'


def _port_atoms(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _jax_ef(jmodel, jparams, at, **kw):
    jmd = JMD(jmodel, jparams, at, use_pallas=False, **kw)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    e, f = jmd._ef_fn(jmd.state.pos, jnl)
    return float(e), np.array(f)


def _random_pair(cfg, seed):
    jmodel = jbuild(copy.deepcopy(cfg))
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed))
    model = build_e3_equivariant_model(copy.deepcopy(cfg))
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, model


def _system(model, jmodel, jparams, at, chunk_atoms, kw):
    return dict(model=model, atoms=_port_atoms(at), chunk_atoms=chunk_atoms,
                kw=kw, ref=_jax_ef(jmodel, jparams, at, **kw))


@pytest.fixture(scope='module')
def systems():
    """Built on first use: {(which, case): system}."""
    made = {}

    def get(which, case):
        if (which, case) in made:
            return made[which, case]
        if which == 'tiny':
            at = rattled_rocksalt(reps=3, a=3.2, rattle=0.05, seed=3)
            over = {} if case == 'kernels_off' else {
                KEY.IRREPS_MANUAL: TINY_FANOUT}
            jm, jp, m = _random_pair(tiny_model_config(over), 2)
            s = _system(m, jm, jp, at, 16, dict(skin=0.5))
        else:
            at = build_nacl(64)
            if case == 'kernels_off':
                jm, jp = JCK(CKPT).build_model()
                m, _ = SevenNetCheckpoint(CKPT).build_model(device='cpu')
            else:
                cfg = copy.deepcopy(SevenNetCheckpoint(CKPT).config)
                irreps = list(cfg[KEY.IRREPS_MANUAL])
                irreps[FULL_FANOUT_AT[0]] = FULL_FANOUT_AT[1]
                cfg[KEY.IRREPS_MANUAL] = irreps
                jm, jp, m = _random_pair(cfg, 7)
            s = _system(m, jm, jp, at, 24, dict(rebuild_every=20))
        made[which, case] = s
        return s
    return get


class _Calls:
    """Counts the fused conv's calls and the plain chunks' runs."""

    def __init__(self, monkeypatch):
        self.n = {'forward': 0, 'backward': 0, 'geom_forward': 0,
                  'geom_backward': 0, 'plain_chunk': 0}
        for name in list(self.n)[:4]:
            monkeypatch.setattr(pfc.FusedConv, name,
                                self._counted(name,
                                              getattr(pfc.FusedConv, name)))
        monkeypatch.setattr(L.IrrepsConvolution, '_plain_chunk',
                            self._counted('plain_chunk',
                                          L.IrrepsConvolution._plain_chunk))

    def _counted(self, name, fn):
        def wrapped(obj, *args):
            self.n[name] += 1
            return fn(obj, *args)
        return wrapped


def _ef(md):
    e, f = md._ef_fn(md.state.pos, md._grid())
    return float(e), f.numpy()


def _force_grad(md, pos, w0):
    """d(sum F . v)/d(pos, w0) with the forces taken by create_graph=True,
    every layer on the plain chain (USE_KERNELS_KEY False)."""
    pos = pos.clone().requires_grad_(True)
    data = md._graph(pos, md._grid())
    data[pfc.USE_KERNELS_KEY] = False
    e = md.model.energy(data)
    (g,) = torch.autograd.grad(e, pos, create_graph=True)
    v = torch.as_tensor(np.random.default_rng(5).normal(size=g.shape),
                        dtype=g.dtype)
    return torch.autograd.grad((g * v).sum(), [pos, w0])


@pytest.mark.parametrize('case', ['kernels_off', 'refused_layer'])
@pytest.mark.parametrize('which', ['tiny', 'full'])
def test_chunked_plain_matches_whole_and_jax(systems, monkeypatch, which,
                                             case):
    s = systems(which, case)
    off = case == 'kernels_off'
    model = s['model']
    routes = [r['route'] for r in model.conv_routes(32, use_kernels=not off)]
    n_conv = model.config[KEY.NUM_CONVOLUTION]
    n_plain = n_conv if off else 1
    assert routes.count('plain') == n_plain
    whole = MolecularDynamics(model, s['atoms'], device='cpu',
                              use_kernels=False, **s['kw'])
    assert whole.conv_chunk_rows == 0
    e_w, f_w = _ef(whole)
    md = MolecularDynamics(model, s['atoms'], device='cpu',
                           conv_chunk_atoms=s['chunk_atoms'],
                           use_kernels=not off, **s['kw'])
    assert md.conv_chunk_rows == s['chunk_atoms'] * md.deg_cap
    assert md.n % s['chunk_atoms'], 'want a remainder chunk'
    n_chunks = -(-md.n // s['chunk_atoms'])
    # a refused layer turns geometry fusion off (its ValueError unreached)
    assert not md._geom_packed_ok() or off
    assert not md._graph(md.state.pos, md._grid())[KEY.EDGE_GEOM_PACKED]
    cuda_build.reset_launch_counts()
    calls = _Calls(monkeypatch)
    e_c, f_c = _ef(md)
    fused = (n_conv - n_plain) * n_chunks
    assert calls.n == {'forward': fused, 'backward': fused,
                       'geom_forward': 0, 'geom_backward': 0,
                       'plain_chunk': 2 * n_plain * n_chunks}
    assert not any(cuda_build.launch_counts.values())
    e_j, f_j = s['ref']
    assert abs(e_c - e_w) <= E_TOL and abs(e_c - e_j) <= E_TOL
    assert np.abs(f_c - f_w).max() <= F_TOL
    assert np.abs(f_c - f_j).max() <= F_TOL
    assert np.abs(f_j).max() > 10 * F_TOL
    # create_graph: a gradient of the forces, chunked against whole-array
    conv = model.layers['1_convolution']
    w0 = conv.weight_nn_p.w0
    w0.requires_grad_(True)
    try:
        got = _force_grad(md, md.state.pos, w0)
        want = _force_grad(whole, md.state.pos, w0)
    finally:
        w0.requires_grad_(False)
    for a, b in zip(got, want):
        assert float(b.abs().max()) > 0
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_chunked_plain_branch_needs_whole_atoms():
    """A plain chunk holds whole atoms (rows % D == 0), as a fused one."""
    s_cfg = tiny_model_config({KEY.NUM_CONVOLUTION: 1})
    model = build_e3_equivariant_model(s_cfg)
    conv = model.layers['0_convolution']
    x = torch.zeros(4, conv.tp.irreps_in1.dim)
    feats = (torch.zeros(32, conv.tp.irreps_in2.dim),
             torch.zeros(32, conv.weight_nn.hs[0]))
    with pytest.raises(ValueError, match='whole'):
        conv._rows_to_nodes_chunked(x, torch.zeros(32, dtype=torch.long),
                                    None, feats, None, torch.ones(32, 1), 8,
                                    12, 'cmshared', False)
