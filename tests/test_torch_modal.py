"""The port's multi-modal models on the CPU against the JAX package: the
model-level cases of ``tests/test_modal.py`` (modality tagging, the modal
linears, the modal split of self_interaction_2, ``ModalWiseRescale``) with
weights from the JAX ``init`` on a seed, carried across by
``params_from_numpy``, on rattled rocksalts made with numpy from a seed.

  - E/F/S of every modality through the calculator's ``modal=`` against the
    JAX calculator, for ``presets/multi_modal.yaml``'s flags and for every
    modal flag on, from config and from a checkpoint the JAX package wrote;
    the modalities give different answers;
  - ``ModalWiseRescale`` with the shift modal-wise only and with the scale
    too: the layer on a two-graph batch, and the whole model;
  - collation carries MODAL_TYPE per graph as the JAX collation does;
  - the convolutions without si2 (the modal split) are refused by the
    kernels, as in JAX, and run the plain chain; the others keep the
    kernel route;
  - ``modal=`` is checked against the model's modalities.

Tolerances: 1e-4 eV, 1e-4 eV/A, 1e-5 eV/A^3 (fp32 both sides); the rescale
layer 1e-6 eV.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.data import graph as jgraph
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data import graph as pgraph
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.layers import (
    IrrepsConvolution,
    IrrepsLinear,
    ModalWiseRescale,
)

torch.set_num_threads(2)
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5
MODALS = {'pbe': 0, 'scan': 1}
PRESET = 'sevennet_exp_tpu/presets/multi_modal.yaml'
MODAL_FLAGS = ('use_modal_node_embedding', 'use_modal_self_inter_intro',
               'use_modal_self_inter_outro', 'use_modal_output_block',
               'use_modal_wise_shift', 'use_modal_wise_scale')


def _preset_flags():
    with open(PRESET) as fh:
        preset = yaml.safe_load(fh)
    flags = {}
    for section in preset.values():
        flags.update({k: v for k, v in section.items() if k in MODAL_FLAGS})
    return flags


def _config(flags, **over):
    cfg = {'cutoff': 4.0, 'channel': 4, 'lmax': 1,
           'num_convolution_layer': 2, 'use_modality': True,
           '_modal_map': dict(MODALS), '_number_of_modalities': 2,
           # modal-wise per species (4 types), one value per modality
           'shift': {'pbe': [0.5, -0.25, 0.1, 0.2],
                     'scan': [1.5, 2.0, 0.3, -0.4]},
           'scale': {'pbe': 1.3, 'scan': 0.7}}
    if not flags.get('use_modal_wise_shift'):
        cfg['shift'] = -10.0
    if not flags.get('use_modal_wise_scale'):
        cfg['scale'] = 10.0
    cfg.update(flags)
    cfg.update(over)
    return tiny_model_config(cfg)


def _pair(cfg, key=5):
    jm = jbuild(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(key))
    m = build_e3_equivariant_model(cfg)
    m.load_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    return jm, jp, m


def _atoms(seed=2):
    at = rattled_rocksalt(reps=2, a=3.2, rattle=0.05, seed=seed)
    return at, Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


def _close(res, ref):
    assert abs(res['energy'] - ref['energy']) <= max(
        E_TOL, 4 * float(np.spacing(np.float32(abs(ref['energy'])))))
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= S_TOL
    assert np.abs(res['energies'] - ref['energies']).max() <= E_TOL


FLAG_SETS = {
    'preset': _preset_flags(),
    'all': {k: True for k in MODAL_FLAGS},
}


@pytest.mark.parametrize('flags', list(FLAG_SETS))
def test_modalities_match_jax(flags, tmp_path):
    fl = FLAG_SETS[flags]
    if flags == 'preset':
        assert fl == {'use_modal_node_embedding': False,
                      'use_modal_self_inter_intro': True,
                      'use_modal_self_inter_outro': True,
                      'use_modal_output_block': True,
                      'use_modal_wise_shift': True,
                      'use_modal_wise_scale': False}
    cfg = _config(fl)
    jm, jp, m = _pair(cfg)
    assert m.modal_map == MODALS
    at, pat = _atoms()
    energies = {}
    for modal in MODALS:
        ref = JCalc(model=jm, params=jp, modal=modal,
                    use_pallas=False).calculate_single(at)
        res = SevenNetCalculator(m, device='cpu', modal=modal).calculate(pat)
        _close(res, ref)
        energies[modal] = res['energy']
    assert abs(energies['pbe'] - energies['scan']) > 1e-3
    # from a checkpoint the JAX package wrote: modal_map carried across
    path = str(tmp_path / 'modal.sevennet')
    jsave(path, cfg, jp)
    jm2, jp2 = JCK(path).build_model()
    calc = SevenNetCalculator(path, device='cpu', modal='scan')
    assert calc.model.modal_map == MODALS
    _close(calc.calculate(pat),
           JCalc(model=jm2, params=jp2, modal='scan',
                 use_pallas=False).calculate_single(at))


def test_modal_layers_and_routes():
    cfg = _config({k: True for k in MODAL_FLAGS})
    jm, jp, m = _pair(cfg)
    names = list(m.layers)
    assert names.index('one_hot_modality') == names.index(
        'onehot_idx_to_onehot') + 1
    for t in range(2):
        assert names.index(f'{t}_self_interaction_2') == names.index(
            f'{t}_convolution') + 1
        conv = m.layers[f'{t}_convolution']
        assert isinstance(conv, IrrepsConvolution) and conv.si2 is None
        assert 'si2' not in m.param_tree()[f'{t}_convolution']
        si2 = m.layers[f'{t}_self_interaction_2']
        assert isinstance(si2, IrrepsLinear) and si2.num_modalities == 2
    for name in ('onehot_to_feature_x', '0_self_interaction_1',
                 'reduce_input_to_hidden'):
        assert m.layers[name].num_modalities == 2
    # the layers and shapes of the JAX pytree, one to one
    flat_j = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    assert {k: tuple(v.shape) for k, v in flat_j.items()} == \
        {k: tuple(v.shape) for k, v in m.state().items()}
    for dd in (0, 32):
        routes = m.conv_routes(dd)
        assert [r['route'] for r in routes] == ['plain', 'plain']
        assert all('si2' in r['refusal'] for r in routes)
    # the preset's flags without the modal si2 keep the kernel route
    _, _, m2 = _pair(_config(dict(FLAG_SETS['preset'],
                                  use_modal_self_inter_outro=False)))
    assert [r['route'] for r in m2.conv_routes(32)] == ['kernel', 'kernel']


def _batch_two_graphs():
    a, _ = _atoms(seed=2)
    b, _ = _atoms(seed=5)
    gs = []
    for at, modal in ((a, 1), (b, 0)):
        g = pgraph.unlabeled_atoms_to_graph(
            Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc), 4.0)
        g[KEY.MODAL_TYPE] = modal
        gs.append(g)
    return gs


def test_collation_carries_modal_type():
    gs = _batch_two_graphs()
    kw = dict(n_node=136, n_edge=4096, n_graph=3)
    mine = pgraph.collate_graphs(gs, **kw)
    theirs = jgraph.collate_graphs(gs, **kw)
    assert set(mine) == set(theirs)
    np.testing.assert_array_equal(mine[KEY.MODAL_TYPE], [1, 0, 0])
    for k in mine:
        assert mine[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(mine[k], theirs[k])
    assert KEY.MODAL_TYPE not in pgraph.collate_graphs(
        [pgraph.unlabeled_atoms_to_graph(_atoms()[1], 4.0)])


@pytest.mark.parametrize('wise_scale', [False, True])
def test_modal_wise_rescale(wise_scale):
    """The shift modal-wise only, or the scale too: the layer on a
    two-graph batch (pad atoms included) against the JAX layer, and the
    whole model's per-graph energies and forces against JAX."""
    flags = dict(FLAG_SETS['preset'], use_modal_wise_scale=wise_scale)
    cfg = _config(flags)
    jm, jp, m = _pair(cfg)
    layer = m.layers['rescale_atomic_energy']
    assert isinstance(layer, ModalWiseRescale)
    assert tuple(layer.shift.shape) == (2, 4)
    assert tuple(layer.scale.shape) == ((2, 4) if wise_scale else (4,))
    np.testing.assert_array_equal(layer.shift.numpy(), np.float32(
        [[0.5, -0.25, 0.1, 0.2], [1.5, 2.0, 0.3, -0.4]]))
    b = pgraph.collate_graphs(_batch_two_graphs(), n_node=136, n_edge=4096,
                              n_graph=3)
    rng = np.random.default_rng(0)
    scaled = rng.normal(size=(136, 1)).astype(np.float32)
    atom_type = np.array([m.type_map.get(int(z), -1)
                          for z in b[KEY.ATOMIC_NUMBERS]])
    data = {KEY.SCALED_ATOMIC_ENERGY: scaled, KEY.ATOM_TYPE: atom_type,
            KEY.MODAL_TYPE: b[KEY.MODAL_TYPE], KEY.BATCH: b[KEY.BATCH]}
    got = layer({k: torch.as_tensor(v) for k, v in data.items()})
    jlayer = dict(jm.layers)['rescale_atomic_energy']
    ref = jlayer.apply(jp['rescale_atomic_energy'],
                       {k: jnp.asarray(v) for k, v in data.items()})
    np.testing.assert_allclose(got[KEY.ATOMIC_ENERGY].numpy(),
                               np.asarray(ref[KEY.ATOMIC_ENERGY]), atol=1e-6)
    # the whole model on the batch: per-graph energies and the forces
    batch = {k: torch.as_tensor(
                 v, dtype=torch.long if v.dtype.kind == 'i' else None)
             for k, v in b.items()}
    out = m.apply(batch)
    jout = jm.apply(jp, {k: jnp.asarray(v) for k, v in b.items()})
    e, je = out[KEY.PRED_TOTAL_ENERGY].numpy(), np.asarray(
        jout[KEY.PRED_TOTAL_ENERGY])
    assert np.abs(e[:2] - je[:2]).max() <= max(
        E_TOL, 4 * float(np.spacing(np.float32(np.abs(je).max()))))
    assert np.abs(out[KEY.PRED_FORCE].numpy()[:128]
                  - np.asarray(jout[KEY.PRED_FORCE])[:128]).max() <= F_TOL


def test_calculator_checks_modal():
    _, _, m = _pair(_config(FLAG_SETS['preset']))
    with pytest.raises(ValueError, match='modalities'):
        SevenNetCalculator(m, device='cpu')
    with pytest.raises(ValueError, match='modalities'):
        SevenNetCalculator(m, device='cpu', modal='hse')
    calc = SevenNetCalculator(m, device='cpu', modal='scan')
    assert calc.modal_idx == 1
    _, _, single = _pair(tiny_model_config(
        {'cutoff': 4.0, 'channel': 4, 'lmax': 1,
         'num_convolution_layer': 2}))
    with pytest.raises(ValueError, match='modalities'):
        SevenNetCalculator(single, device='cpu', modal='pbe')
