"""The port's per-layer cutoffs (``multi_cutoff``) on the CPU against the JAX
package, as ``tests/test_multi_cutoff.py`` tests it: weights from the JAX
``init`` on a seed, carried across by ``params_from_numpy``; the inputs a
rattled rocksalt made with numpy from a seed.

  - a uniform multi-cutoff model equals the single-cutoff model;
  - heterogeneous cutoffs match JAX (calculator E/F/S, from config and from
    a checkpoint the JAX package wrote) and differ from the single cutoff;
  - the embedding is exactly zero beyond its cutoff, each convolution reads
    its own cutoff's embedding and mask;
  - the model is never geometry-fused, its convolutions keep the kernel
    route (kernels 1-2 on the card), and the MD engine's force call, whole
    array and chunk by chunk, matches the JAX engine's.

Tolerances: 1e-4 eV, 1e-4 eV/A, 1e-5 eV/A^3 (fp32 both sides); the uniform
model against the single-cutoff one 1e-6 eV and 1e-6 eV/A (the same
arithmetic on a masked list).
"""

import jax
import numpy as np
import pytest
import torch

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data.graph import (
    Atoms,
    collate_graphs,
    unlabeled_atoms_to_graph,
)
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.layers import (
    IrrepsConvolution,
    MultiCutoffEdgeEmbedding,
    geom_packed_ok,
)
from sevennet_exp_tpu_torch.ops import fused_conv as pfc

torch.set_num_threads(2)
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5
BASE = {'cutoff': 4.0, 'channel': 4, 'lmax': 1, 'num_convolution_layer': 2}


def _pair(over, key=5):
    cfg = tiny_model_config(dict(BASE, **over))
    jm = jbuild(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(key))
    m = build_e3_equivariant_model(cfg)
    m.load_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return cfg, jm, jp, m


def _atoms():
    at = rattled_rocksalt(reps=2, a=3.2, rattle=0.05, seed=2)
    return at, Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _close(res, ref):
    assert abs(res['energy'] - ref['energy']) <= max(
        E_TOL, 4 * float(np.spacing(np.float32(abs(ref['energy'])))))
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= S_TOL


def test_uniform_multi_cutoff_matches_single():
    _, jm, jp, single = _pair({})
    _, _, _, multi = _pair({'multi_cutoff': [4.0, 4.0]})
    at, pat = _atoms()
    r0 = SevenNetCalculator(single, device='cpu').calculate(pat)
    r1 = SevenNetCalculator(multi, device='cpu').calculate(pat)
    assert r1['energy'] == pytest.approx(r0['energy'], abs=1e-6, rel=1e-6)
    np.testing.assert_allclose(r1['forces'], r0['forces'], atol=1e-6,
                               rtol=1e-5)
    _close(r1, JCalc(model=jm, params=jp,
                     use_pallas=False).calculate_single(at))


def test_heterogeneous_cutoffs_match_jax_and_differ(tmp_path):
    cfg, jm, jp, m = _pair({'multi_cutoff': [4.0, 3.0]})
    _, _, _, single = _pair({})
    at, pat = _atoms()
    ref = JCalc(model=jm, params=jp, use_pallas=False).calculate_single(at)
    res = SevenNetCalculator(m, device='cpu').calculate(pat)
    _close(res, ref)
    e_single = SevenNetCalculator(single, device='cpu').calculate(
        pat)['energy']
    assert np.isfinite(res['energy'])
    assert abs(res['energy'] - e_single) > 1e-3    # layer 1 sees fewer edges
    # from a checkpoint the JAX package wrote
    path = str(tmp_path / 'multi.sevennet')
    jsave(path, cfg, jp)
    jm2, jp2 = JCK(path).build_model()
    from_ckpt = SevenNetCalculator(path, device='cpu')
    assert isinstance(from_ckpt.model.layers['edge_embedding'],
                      MultiCutoffEdgeEmbedding)
    _close(from_ckpt.calculate(pat),
           JCalc(model=jm2, params=jp2, use_pallas=False).calculate_single(at))


def test_embedding_layer_masks_beyond_cutoff():
    _, jm, jp, m = _pair({'multi_cutoff': [4.0, 3.0]})
    emb = m.layers['edge_embedding']
    assert isinstance(emb, MultiCutoffEdgeEmbedding)
    assert set(emb.param_tree()) == set(jp['edge_embedding']) == \
        {'c3.0', 'c4.0'}
    _, pat = _atoms()
    g = unlabeled_atoms_to_graph(pat, 4.0)
    b = collate_graphs([g], n_node=72, n_edge=2048)
    batch = {k: torch.as_tensor(v) for k, v in b.items()}
    data = emb(dict(batch))
    r = data[KEY.EDGE_LENGTH].numpy()
    base = b[KEY.EDGE_MASK]
    # the JAX layer on the same batch
    jdata = dict(jm.layers)['edge_embedding'].apply(
        jp['edge_embedding'], {k: jax.numpy.asarray(v) for k, v in b.items()})
    for c in (3.0, 4.0):
        mask = data[KEY.EDGE_MASK + str(c)].numpy()
        np.testing.assert_array_equal(mask, (r <= c) & (base > 0))
        e = data[KEY.EDGE_EMBEDDING + str(c)].numpy()
        assert np.all(e[mask == 0] == 0.0)
        assert np.any(e[mask == 1] != 0.0)
        np.testing.assert_array_equal(
            mask, np.asarray(jdata[KEY.EDGE_MASK + str(c)]))
        np.testing.assert_allclose(
            e, np.asarray(jdata[KEY.EDGE_EMBEDDING + str(c)]), atol=1e-6)
    convs = [l for n, l in m.layers.items() if n.endswith('_convolution')]
    assert convs[0].key_weight_input.endswith('4.0')
    assert convs[1].key_weight_input.endswith('3.0')
    assert convs[1].key_mask == KEY.EDGE_MASK + '3.0'
    # a message beyond the layer's cutoff is exactly zero: the layer's
    # output does not move when such an edge's geometry changes
    conv = convs[1]
    data = m.preprocess(dict(batch))
    for name, layer in m.layers.items():
        if layer is conv:
            break
        data = layer(data)
    out = conv(dict(data))[KEY.NODE_FEATURE]
    far = (r > 3.0) & (base > 0)
    assert far.any()
    moved = dict(data)
    far_t = torch.as_tensor(far)[:, None]
    emb_key = KEY.EDGE_EMBEDDING + '3.0'
    moved[emb_key] = data[emb_key] + far_t * 5.0
    moved[KEY.EDGE_ATTR] = torch.where(far_t, data[KEY.EDGE_ATTR] * 3.0,
                                       data[KEY.EDGE_ATTR])
    assert torch.equal(conv(moved)[KEY.NODE_FEATURE], out)


def test_multi_cutoff_model_is_not_geometry_fused():
    _, jm, jp, m = _pair({'multi_cutoff': [4.0, 3.0]})
    convs = [l for l in m.layers.values() if isinstance(l, IrrepsConvolution)]
    assert all(c.geom is None for c in convs)
    assert not geom_packed_ok(m)
    # the kernels take every layer: dense grid and edge list (rows 1-2)
    for dd in (0, 32):
        assert [r['route'] for r in m.conv_routes(dd)] == ['kernel'] * 2
    _, _, _, single = _pair({})
    assert geom_packed_ok(single)


@pytest.mark.parametrize('chunked', [False, True])
def test_engine_force_call_matches_jax(chunked):
    """The engine's dense-grid force call (the fused conv's plain version on
    the CPU), whole array or in chunks of 16 atoms, against the JAX engine
    (whose multi-cutoff embedding runs the whole array either way)."""
    _, jm, jp, m = _pair({'multi_cutoff': [4.0, 3.0]})
    at = rattled_rocksalt(reps=3, a=3.2, rattle=0.03, seed=4)
    kw = dict(ensemble='nve', seed=1)
    jmd = JMD(jm, jp, at, use_pallas=False, **kw)
    jnl = jmd._compact_nl(jmd._build_nl(jmd.state.pos), jmd.state.pos)
    je, jf = jmd._ef_fn(jmd.state.pos, jnl)
    md = MolecularDynamics(m, Atoms(at.atomic_numbers, at.pos, at.cell,
                                    at.pbc), device='cpu',
                           conv_chunk_atoms=16 if chunked else 0,
                           velocities=np.array(jmd.state.vel), **kw)
    assert bool(md.conv_chunk_rows) == chunked
    nl = md._grid()
    data = md._graph(md.state.pos, nl)
    assert not data[KEY.EDGE_GEOM_PACKED]
    pfc.reset_launch_counts()
    e, f = md._ef_fn(md.state.pos, nl)
    assert not any(pfc.launch_counts.values())
    assert abs(float(e) - float(je)) <= E_TOL
    assert np.abs(f.numpy() - np.asarray(jf)).max() <= F_TOL
