"""The port's modality conversion (``scripts/convert_modality.py``), the
cases of ``tests/test_convert_modality.py`` against the port:

  - ``append_modality_to_params`` and ``single_modal_params`` give the
    JAX package's config and parameter tree exactly (every leaf equal);
  - the converted models keep their outputs: each original modality's
    E/F/S after appending, and the chosen modality's after collapsing
    (the JAX test's tolerances: 1e-5 eV, 1e-4 relative);
  - ``cp --append-modal`` / ``--get-single-modal`` of the port's CLI write
    checkpoints that hold the same, and the JAX package reads them;
  - bad modality names raise as in JAX.
Weights from the JAX ``init`` on a seed; structures from numpy on a seed.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.scripts import convert_modality as jconv
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    params_from_numpy,
    save_checkpoint,
)
from sevennet_exp_tpu_torch.data.graph import (
    Atoms,
    atoms_to_graph,
    collate_graphs,
)
from sevennet_exp_tpu_torch.main.cli import main_cp
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops.fused_conv import USE_KERNELS_KEY
from sevennet_exp_tpu_torch.scripts import convert_modality as pconv

torch.set_num_threads(2)
_INT = (KEY.ATOMIC_NUMBERS, KEY.BATCH, KEY.EDGE_IDX, KEY.NUM_ATOMS,
        KEY.MODAL_TYPE)


def _modal_config(n_modal=2, **extra):
    over = {
        'cutoff': 4.0, 'channel': 4, 'lmax': 1,
        'num_convolution_layer': 2,
        'use_modality': True,
        'use_modal_node_embedding': True,
        'use_modal_self_inter_intro': True,
        'use_modal_self_inter_outro': True,
        'use_modal_output_block': True,
        KEY.MODAL_MAP: {f'm{i}': i for i in range(n_modal)},
        KEY.NUM_MODALITIES: n_modal,
    }
    over.update(extra)
    return tiny_model_config(over)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(config, key):
    jp, _ = jbuild(config).init(jax.random.PRNGKey(key))
    return _np(jp)


def _model(config, params):
    m = build_e3_equivariant_model(config)
    m.load_state(params_from_numpy(params))
    return m


def _batch(modal_idx=None):
    at = rattled_rocksalt(reps=2, a=5.63, rattle=0.1, seed=5)
    g = atoms_to_graph(Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc),
                       4.0, allow_unlabeled=True)
    if modal_idx is not None:
        g[KEY.MODAL_TYPE] = modal_idx
    b = collate_graphs([g], n_node=72, n_edge=2048)
    out = {k: torch.as_tensor(v, dtype=torch.long if k in _INT else None)
           for k, v in b.items()}
    out[USE_KERNELS_KEY] = True
    return out


def _efs(model, batch):
    out = model.apply(batch)
    return (out[KEY.PRED_TOTAL_ENERGY].numpy(), out[KEY.PRED_FORCE].numpy(),
            out[KEY.PRED_STRESS].numpy())


def _close(a, b):
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a[1], b[1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a[2], b[2], rtol=1e-4, atol=1e-7)


def _leaves(tree):
    return {'/'.join(str(k.key) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(tree)}


def _same(mine, theirs):
    cm, pm = mine
    cj, pj = theirs
    assert cm == cj
    a, b = _leaves(pm), _leaves(_np(pj))
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize('case', ['append_modal', 'append_single',
                                  'strip_m0', 'strip_m1', 'strip_common'])
def test_converted_params_equal_jax(case):
    if case == 'append_single':
        config = tiny_model_config({'cutoff': 4.0, 'channel': 4, 'lmax': 1,
                                    'num_convolution_layer': 2})
    else:
        config = _modal_config(2)
    params = _params(config, 3)
    if case.startswith('append'):
        fn, arg = 'append_modality_to_params', ['extra']
    else:
        fn, arg = 'single_modal_params', case.split('_')[1]
    mine = getattr(pconv, fn)(copy.deepcopy(config), copy.deepcopy(params),
                              arg)
    theirs = getattr(jconv, fn)(copy.deepcopy(config),
                                copy.deepcopy(params), arg)
    _same(mine, theirs)


def test_single_modal_strip_preserves_outputs():
    config = _modal_config(2)
    params = _params(config, 7)
    model = _model(config, params)
    for name, idx in config[KEY.MODAL_MAP].items():
        ref = _efs(model, _batch(idx))
        cfg1, p1 = pconv.single_modal_params(config, params, name)
        assert cfg1[KEY.USE_MODALITY] is False
        _close(_efs(_model(cfg1, p1), _batch()), ref)


def test_append_modality_preserves_original_modals():
    config = _modal_config(2)
    params = _params(config, 3)
    model = _model(config, params)
    ref = [_efs(model, _batch(i)) for i in range(2)]
    cfg2, p2 = pconv.append_modality_to_params(config, params, ['extra'])
    assert cfg2[KEY.MODAL_MAP] == {'m0': 0, 'm1': 1, 'extra': 2}
    m2 = _model(cfg2, p2)
    for i in range(2):
        _close(_efs(m2, _batch(i)), ref[i])
    e, f, _ = _efs(m2, _batch(2))
    assert np.isfinite(e).all() and np.isfinite(f).all()


def test_append_to_single_modal_checkpoint():
    config = tiny_model_config({'cutoff': 4.0, 'channel': 4, 'lmax': 1,
                                'num_convolution_layer': 2})
    params = _params(config, 11)
    ref = _efs(_model(config, params), _batch())
    cfg2, p2 = pconv.append_modality_to_params(config, params, ['pbe52'])
    assert cfg2[KEY.MODAL_MAP] == {'origin': 0, 'pbe52': 1}
    _close(_efs(_model(cfg2, p2), _batch(0)), ref)


def test_checkpoint_append_modal_cli(tmp_path, capsys):
    config = _modal_config(2)
    params = _params(config, 1)
    src = str(tmp_path / 'cp_modal.pkl')
    dst = str(tmp_path / 'cp_widened.pkl')
    save_checkpoint(src, config, params, epoch=3)

    main_cp([src, '--append-modal', 'new_modal', '-o', dst])
    assert f"appended modal(s) ['new_modal'] -> {dst}" in capsys.readouterr().out
    cp2 = SevenNetCheckpoint(dst)
    assert cp2.config[KEY.MODAL_MAP] == {'m0': 0, 'm1': 1, 'new_modal': 2}
    assert cp2.epoch == 3
    m2, _ = cp2.build_model(device='cpu')
    ref = _efs(_model(config, params), _batch(1))
    _close(_efs(m2, _batch(1)), ref)
    # the JAX package reads the widened checkpoint, leaf for leaf
    _, jp2 = JCK(dst).build_model()
    _same((cp2.config, cp2.params), (JCK(dst).config, jp2))

    single = str(tmp_path / 'cp_single.pkl')
    main_cp([dst, '--get-single-modal', 'm1', '-o', single])
    ms, _ = SevenNetCheckpoint(single).build_model(device='cpu')
    _close(_efs(ms, _batch()), ref)


def test_bad_modal_names():
    config = _modal_config(2)
    params = _params(config, 0)
    with pytest.raises(ValueError):
        pconv.append_modality_to_params(config, params, ['m0'])
    with pytest.raises(KeyError):
        pconv.single_modal_params(config, params, 'nope')
