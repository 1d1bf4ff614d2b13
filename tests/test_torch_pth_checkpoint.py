"""The port reads reference SevenNet ``.pth`` checkpoints as the JAX
package does (``sevennet_exp_tpu/checkpoint.py::convert_torch_state_dict``).

The test writes its own ``.pth`` files: a JAX-initialized model's
parameters inverted into the e3nn flat layouts, in the current (>= 0.11)
form and in the old (< 0.11) form, whose convolution weight columns follow
the unsorted instruction list and whose stored ``_w3j_*`` tensors are one
sign-flipped key among unflipped ones. Then:

  - the port's converted tree equals the JAX package's conversion exactly
    (and so the JAX-initialized parameters), for the plain, the modal and
    the FCN-readout model; E/F/S of the port's calculator on the ``.pth``
    match the JAX calculator (1e-4 eV, 1e-4 eV/A, 1e-5 eV/A^3);
  - a multi-cutoff ``.pth``: JAX converts no coefficients for its
    ``MultiCutoffEdgeEmbedding`` (it is not an ``EdgeEmbedding``), and
    neither does the port: both trees lack the layer, and both packages
    raise KeyError when the model is run or built;
  - ``_patch_old_config`` and ``yaml_dict`` equal JAX's;
  - the format is decided by the file's first bytes: a corrupt native
    pickle raises from the native loader and is never handed to
    ``torch.load``; keywords and paths both resolve.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu import checkpoint as jck
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.irreps import Irrep
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops.wigner import wigner_3j
from sevennet_exp_tpu_torch import checkpoint as pck
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.data.graph import Atoms

torch.set_num_threads(2)
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5

SMALL = {'lmax': 1, 'is_parity': False, 'channel': 4,
         'num_convolution_layer': 3, 'weight_nn_hidden_neurons': [16, 16],
         'self_connection_type': 'linear'}
FORMS = {
    'plain': {},
    'modal': {'use_modality': True, '_modal_map': {'pbe': 0, 'scan': 1},
              '_number_of_modalities': 2,
              'use_modal_node_embedding': False,
              'use_modal_self_inter_intro': True,
              'use_modal_self_inter_outro': True,
              'use_modal_output_block': True,
              'use_modal_wise_shift': True,
              'shift': {'pbe': [0.5, -0.25, 0.1, 0.2],
                        'scan': [1.5, 2.0, 0.3, -0.4]}},
    'fcn_readout': {'readout_as_fcn': True},
    'multi_cutoff': {'multi_cutoff': [4.0, 3.5, 3.5]},
}


def _invert_linear(spec, prefix, p, sd):
    sd[f'{prefix}.weight'] = np.concatenate(
        [np.asarray(p[f'w{n}']).reshape(-1) for n in range(len(spec.paths))])
    if spec.biases:
        bs = [np.asarray(p[f'b{j}']).reshape(-1)
              for j, (mul, ir) in enumerate(spec.irreps_out)
              if ir == Irrep(0, 1)]
        if bs:
            sd[f'{prefix}.bias'] = np.concatenate(bs)


def _state_dict(model, params, old):
    """JAX parameters -> a reference state dict; ``old``: the < 0.11
    convolution columns (unsorted) with the first l > 0 triple's stored w3j
    sign-flipped and its columns pre-negated."""
    sd, flipped = {}, []
    for name, layer in model.layers:
        p = params.get(name)
        if isinstance(layer, JL.EdgeEmbedding):
            sd[f'{name}.basis_function.coeffs'] = np.asarray(p['coeffs'])
        elif isinstance(layer, JL.MultiCutoffEdgeEmbedding):
            for c, sub in p.items():
                sd[f'{name}.{c}.basis_function.coeffs'] = np.asarray(
                    sub['coeffs'])
        elif isinstance(layer, (JL.IrrepsLinear,
                                JL.SelfConnectionLinearIntro)):
            _invert_linear(layer.spec, f'{name}.linear', p, sd)
        elif isinstance(layer, JL.SelfConnectionIntro):
            sd[f'{name}.fc_tensor_product.weight'] = np.concatenate(
                [np.asarray(p[f'w{n}']).reshape(-1)
                 for n in range(len(layer.spec.instructions))])
        elif isinstance(layer, JL.IrrepsConvolution):
            wnn = p['weight_nn']
            nl = len(layer.weight_nn.hs) - 1
            for i in range(nl):
                sd[f'{name}.weight_nn.layer{i}.weight'] = np.asarray(
                    wnn[f'w{i}'])
            sd[f'{name}.denominator'] = np.asarray(
                p['denominator']).reshape(())
            if old:
                tp = layer.tp
                last = np.asarray(wnn[f'w{nl - 1}'])
                ranges, off = {}, 0
                for inst in tp.instructions:
                    mul = tp.irreps_in1[inst[0]].mul
                    ranges.setdefault(tuple(inst), []).append((off, mul))
                    off += mul
                blocks, tris = [], []
                for inst in tp.instructions_unsorted:
                    o, mul = ranges[tuple(inst)].pop(0)
                    block = last[:, o:o + mul]
                    tri = (tp.irreps_in1[inst[0]].ir.l,
                           tp.irreps_in2[inst[1]].ir.l,
                           tp.irreps_out[inst[2]].ir.l)
                    if min(tri) > 0:
                        if tri not in tris:
                            tris.append(tri)
                        if tri == tris[0]:
                            block = -block
                    blocks.append(block)
                sd[f'{name}.weight_nn.layer{nl - 1}.weight'] = (
                    np.concatenate(blocks, axis=1))
                for k, tri in enumerate(tris):
                    w3j = wigner_3j(*tri)
                    sd[f'{name}.convolution._compiled_main_left_right.'
                       f'_w3j_{tri[0]}_{tri[1]}_{tri[2]}'] = (
                        -w3j if k == 0 else w3j)
                flipped += tris[:1]
            if layer.si2 is not None:
                _invert_linear(
                    layer.si2, name.replace('_convolution',
                                            '_self_interaction_2')
                    + '.linear', p['si2'], sd)
        elif isinstance(layer, (JL.Rescale, JL.SpeciesWiseRescale,
                                JL.ModalWiseRescale)):
            sd[f'{name}.shift'] = np.asarray(p['shift'])
            sd[f'{name}.scale'] = np.asarray(p['scale'])
        elif isinstance(layer, JL.FCNReadout):
            for i in range(len(layer.spec.hs) - 1):
                sd[f'{name}.fcn.layer{i}.weight'] = np.asarray(p[f'w{i}'])
        else:
            assert p is None, (name, type(layer))
    return sd, flipped


def _write_pth(path, config, sd, epoch=3):
    torch.save({'config': config, 'epoch': epoch,
                'model_state_dict': {
                    k: torch.from_numpy(np.array(v))
                    for k, v in sd.items()}}, path)


def _form(name, tmp_path, old=False, key=4):
    cfg = tiny_model_config(dict(SMALL, **FORMS[name]))
    jm = jbuild(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(key))
    jp = jax.tree_util.tree_map(np.asarray, jp)
    sd, flipped = _state_dict(jm, jp, old)
    cfg = dict(cfg, version='0.10.0' if old else '0.11.2')
    path = str(tmp_path / f'{name}{"_old" if old else ""}.pth')
    _write_pth(path, cfg, sd)
    return cfg, jm, jp, path, flipped


def _leaves(tree):
    return {'/'.join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_trees_equal(mine, theirs):
    a, b = _leaves(mine), _leaves(theirs)
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def _atoms():
    at = rattled_rocksalt(reps=2, a=3.2, rattle=0.05, seed=2)
    return at, Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


@pytest.mark.parametrize('old', [False, True], ids=['current', 'old'])
@pytest.mark.parametrize('form', ['plain', 'modal', 'fcn_readout'])
def test_pth_conversion_equals_jax(form, old, tmp_path):
    cfg, jm, jp, path, flipped = _form(form, tmp_path, old)
    if old:
        # the old layout really reorders and really flips a sign
        assert flipped and any(
            layer.tp.instructions != layer.tp.instructions_unsorted
            for _, layer in jm.layers
            if isinstance(layer, JL.IrrepsConvolution))
    cp = pck.SevenNetCheckpoint(path)
    assert cp.is_torch and cp.epoch is None
    jcp = jck.SevenNetCheckpoint(path)
    _, jconv = jcp.build_model()
    _assert_trees_equal(cp.params, jconv)
    _assert_trees_equal(cp.params, jp)
    assert cp.config == jcp.config
    # the port's model carries exactly those leaves
    model, state = cp.build_model(device='cpu')
    for k, v in _leaves(jp).items():
        assert np.array_equal(state[k].numpy(), v), k


@pytest.mark.parametrize('form', ['plain', 'modal', 'fcn_readout'])
def test_pth_energy_forces_stress_match_jax(form, tmp_path):
    cfg, jm, jp, path, _ = _form(form, tmp_path, old=(form == 'plain'))
    at, pat = _atoms()
    modal = 'scan' if form == 'modal' else None
    _, jconv = jck.SevenNetCheckpoint(path).build_model()
    ref = JCalc(model=jm, params=jconv, modal=modal,
                use_pallas=False).calculate_single(at)
    res = SevenNetCalculator(path, device='cpu', modal=modal).calculate(pat)
    assert abs(res['energy'] - ref['energy']) <= E_TOL
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= S_TOL


def test_multi_cutoff_pth_does_what_jax_does(tmp_path):
    cfg, jm, jp, path, _ = _form('multi_cutoff', tmp_path)
    assert any(isinstance(layer, JL.MultiCutoffEdgeEmbedding)
               for _, layer in jm.layers)
    cp = pck.SevenNetCheckpoint(path)
    _, jconv = jck.SevenNetCheckpoint(path).build_model()
    assert 'edge_embedding' not in jconv
    _assert_trees_equal(cp.params, jconv)
    at, pat = _atoms()
    with pytest.raises(KeyError):
        JCalc(model=jm, params=jconv, use_pallas=False).calculate_single(at)
    with pytest.raises(KeyError, match='edge_embedding'):
        cp.build_model(device='cpu')


OLD_CONFIGS = [
    {'version': '0.9.5', 'cutoff_function': {
        'cutoff_function_name': 'XPLOR', 'cutoff_on': 4.5,
        'poly_cut_p_value': 6}, 'train_avg_num_neigh': True},
    {'version': '0.9.0', 'cutoff_function': {
        'cutoff_function_name': 'poly_cut', 'poly_cut_p_value': 6}},
    {'version': '0.9.99', 'conv_denominator': 12.0,
     'train_denominator': True, '_normalize_sph': True},
    {'version': '0.10.0', 'train_avg_num_neigh': True},
    {'cutoff': 5.0},
]


@pytest.mark.parametrize('config', OLD_CONFIGS)
def test_patch_old_config_equals_jax(config):
    import copy
    mine = pck._patch_old_config(copy.deepcopy(config))
    theirs = jck._patch_old_config(copy.deepcopy(config))
    assert mine == theirs
    assert pck._version_tuple(config.get('version', '0.11.0')) == \
        jck._version_tuple(config.get('version', '0.11.0'))


@pytest.mark.parametrize('mode', ['reproduce', 'continue'])
@pytest.mark.parametrize('which', ['native', 'pth'])
def test_yaml_dict_equals_jax(which, mode, tmp_path):
    if which == 'native':
        path = '7net-0-nacl-demo'
    else:
        path = _form('plain', tmp_path)[3]
    assert pck.SevenNetCheckpoint(path).yaml_dict(mode) == \
        jck.SevenNetCheckpoint(path).yaml_dict(mode)


def test_format_is_decided_by_the_first_bytes(tmp_path, monkeypatch):
    def no_torch(*a, **k):
        raise AssertionError('a native file was handed to torch.load')

    monkeypatch.setattr(pck, 'load_torch_checkpoint', no_torch)
    corrupt = tmp_path / 'corrupt.pth.sevennet'
    good = pickle.dumps({'config': {}, 'params': {}, 'epoch': 1})
    corrupt.write_bytes(good[:len(good) // 2])
    with pytest.raises((pickle.UnpicklingError, EOFError)):
        pck.SevenNetCheckpoint(str(corrupt)).config
    foreign = tmp_path / 'foreign.pkl'
    foreign.write_bytes(pickle.dumps({'config': {}, 'params': {},
                                      'x': pytest.raises}))
    with pytest.raises(pickle.UnpicklingError, match='_pytest'):
        pck.SevenNetCheckpoint(str(foreign)).config
    # a torch archive goes to torch.load (here refused by the stub)
    arch = tmp_path / 'cp.pth'
    torch.save({'config': {}, 'model_state_dict': {}}, str(arch))
    assert pck.is_torch_archive(str(arch))
    with pytest.raises(AssertionError, match='torch.load'):
        pck.SevenNetCheckpoint(str(arch)).config


def test_keyword_and_path_open_the_same_checkpoint():
    by_name = pck.SevenNetCheckpoint('7net-0-NaCl-demo')
    by_path = pck.load_checkpoint(by_name.checkpoint_path)
    assert by_name.checkpoint_path == by_path.checkpoint_path
    assert by_name.epoch == by_path.epoch == \
        jck.SevenNetCheckpoint('7net-0-nacl-demo').epoch
    assert not by_name.is_torch
    with pytest.raises(ValueError, match='not found'):
        pck.load_checkpoint('no/such/checkpoint.pth')
