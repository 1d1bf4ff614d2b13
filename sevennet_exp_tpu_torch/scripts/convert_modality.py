"""Modality conversion of model parameters.

Counterpart of ``sevennet_exp_tpu/scripts/convert_modality.py`` on numpy
parameter trees in the JAX layout (``SevenNetCheckpoint.params``); the
port's models give the linears' specs. A parameter that neither copy nor
conversion sets keeps its value from the new model's ``init`` on
``torch.Generator().manual_seed(0)`` (biases: zeros, as in JAX).

Capability parity with the reference's convert_model_modality.py:
- :func:`append_modality_to_params` widens the modal one-hot blocks of
  the modal-bearing linears with zero rows (reference
  `append_modality_to_model_dct`, convert_model_modality.py:253-301),
  so a single/multi-modal checkpoint keeps its exact function on the
  original modalities while gaining slots for new ones.
- :func:`single_modal_params` folds one modality's one-hot weights into
  linear biases and strips the modal blocks (reference
  `get_single_modal_model_dct`, :142-249), producing a plain
  single-modal model for deployment.

Layout notes: layers.IrrepsLinear appends the modal one-hot at the END
of the feature vector, i.e. as the trailing `n_modal x 0e` entry of
irreps_in. Depending on adjacency, Irreps.simplify() either merges it
into the preceding scalar block (onehot_to_feature_x) or keeps it as a
separate path (self-interactions, readout). Both cases reduce to the
same rule: in the dense matrix of ALL scalar (0e) input rows — paths
concatenated in input-entry order — the modal rows are the LAST
n_modal. Runtime normalization is alpha = 1/sqrt(fan_in) recomputed
from the spec (path_normalization 'element'), so resizing the scalar
fan requires rescaling surviving rows by sqrt(fan_new/fan_old) to
preserve the function — the correction the reference applies at
convert_model_modality.py:117-123.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _keys as KEY
from ..irreps import Irrep
from ..model.build import build_e3_equivariant_model
from ..model.layers import IrrepsLinear

MODAL_MODULE_FLAGS = {
    KEY.USE_MODAL_NODE_EMBEDDING: 'onehot_to_feature_x',
    KEY.USE_MODAL_SELF_INTER_INTRO: 'self_interaction_1',
    KEY.USE_MODAL_SELF_INTER_OUTRO: 'self_interaction_2',
    KEY.USE_MODAL_OUTPUT_BLOCK: 'reduce_input_to_hidden',
}

_SCALAR = Irrep(0, 1)


def _modal_linears(model) -> List[Tuple[str, IrrepsLinear]]:
    return [
        (name, layer) for name, layer in model.layers.items()
        if isinstance(layer, IrrepsLinear) and layer.num_modalities > 1
    ]


def _init_numpy(model) -> Dict[str, Any]:
    """The model's ``init`` tree on seed 0, as numpy."""
    params, _ = model.init(torch.Generator().manual_seed(0))

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}
    return walk(params)


def _resolve_linear(model, params, name):
    """(spec, param_subdict) for a named linear. `{t}_self_interaction_2`
    may exist as its own layer (modal path) or fused into
    `{t}_convolution` as the 'si2' subtree (layers.py IrrepsConvolution
    docstring)."""
    layers = dict(model.layers.items())
    layer = layers.get(name)
    if isinstance(layer, IrrepsLinear):
        return layer.spec, params[name]
    if name.endswith('_self_interaction_2'):
        conv_name = name.replace('_self_interaction_2', '_convolution')
        conv = layers.get(conv_name)
        if conv is not None and getattr(conv, 'si2', None) is not None:
            return conv.si2, params[conv_name].setdefault('si2', {})
    raise KeyError(f'cannot locate linear {name!r} in model')


def _split_paths(spec):
    """(scalar_paths, other_paths): path ids with 0e->0e first, in input
    entry order; others keep spec order."""
    scal, other = [], []
    for n, (i, j, mi, mo, _a) in enumerate(spec.paths):
        if spec.irreps_in[i].ir == _SCALAR and spec.irreps_out[j].ir == _SCALAR:
            scal.append((i, n, mi, mo, j))
        else:
            other.append(n)
    scal.sort()  # by input entry index == dense row order
    return scal, other


def _dense_scalar_weight(spec, lparams) -> Tuple[np.ndarray, int]:
    """Concatenate every 0e->0e path weight into (fan, mul_out) rows."""
    scal, _ = _split_paths(spec)
    rows = [np.asarray(lparams[f'w{n}']) for (_i, n, _mi, _mo, _j) in scal]
    return np.concatenate(rows, 0), scal[0][4] if scal else 0


def _set_dense_scalar_weight(spec, lparams, dense: np.ndarray):
    scal, _ = _split_paths(spec)
    off = 0
    for (_i, n, mi, _mo, _j) in scal:
        lparams[f'w{n}'] = np.asarray(dense[off:off + mi])
        off += mi
    assert off == dense.shape[0], (off, dense.shape)


def _transfer_linear(old_spec, new_spec, old_lp: Dict, new_lp: Dict,
                     transform_dense) -> None:
    """Copy non-scalar paths 1:1 in order; scalar paths go through
    transform_dense(old_dense) -> new_dense."""
    _, other_old = _split_paths(old_spec)
    _, other_new = _split_paths(new_spec)
    assert len(other_old) == len(other_new), 'path structure changed'
    for n_old, n_new in zip(other_old, other_new):
        assert np.shape(old_lp[f'w{n_old}']) == np.shape(new_lp[f'w{n_new}'])
        new_lp[f'w{n_new}'] = old_lp[f'w{n_old}']
    dense_old, _ = _dense_scalar_weight(old_spec, old_lp)
    _set_dense_scalar_weight(new_spec, new_lp, transform_dense(dense_old))


def append_modality_to_params(
    config: Dict[str, Any],
    params: Dict[str, Any],
    new_modals: List[str],
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Extend the modal map by `new_modals`; returns (config, params) of
    the widened model. New modal rows start at zero so every original
    modality computes exactly what it did before (up to the shared
    1/sqrt(fan) renormalization, which is compensated)."""
    if not new_modals:
        return config, params
    old_map = dict(config.get(KEY.MODAL_MAP) or {})
    new_map = dict(old_map)
    if not new_map:
        # single-modal checkpoint gaining modality: original weights act
        # as modal slot 0 ('origin', cf. reference checkpoint.py:399-447)
        new_map = {'origin': 0}
    for m in new_modals:
        if m in new_map:
            raise ValueError(f'modal {m!r} already exists')
        new_map[m] = len(new_map)

    new_config = copy.deepcopy(config)
    new_config[KEY.USE_MODALITY] = True
    new_config[KEY.MODAL_MAP] = new_map
    new_config[KEY.NUM_MODALITIES] = len(new_map)
    for flag in MODAL_MODULE_FLAGS:
        new_config.setdefault(flag, True)

    # modal-wise shift/scale rows for new modals copy the first modal
    for use_key, name in ((KEY.USE_MODAL_WISE_SHIFT, KEY.SHIFT),
                          (KEY.USE_MODAL_WISE_SCALE, KEY.SCALE)):
        if new_config.get(use_key, False):
            v = np.asarray(new_config[name], dtype=np.float64)
            if v.ndim == 1:
                v = np.tile(v[None], (max(len(old_map), 1), 1))
            rows = np.concatenate(
                [v] + [v[:1]] * (len(new_map) - v.shape[0]), 0)
            new_config[name] = rows.tolist()

    old_model = build_e3_equivariant_model(config)
    new_model = build_e3_equivariant_model(new_config)
    new_params = _copy_common(params, _init_numpy(new_model))

    for name, new_layer in _modal_linears(new_model):
        old_spec, old_lp = _resolve_linear(old_model, params, name)
        new_spec = new_layer.spec

        def widen(dense, _ns=new_spec):
            fan_old = dense.shape[0]
            fan_new = sum(mi for (_i, _n, mi, _mo, _j)
                          in _split_paths(_ns)[0])
            pad = np.zeros((fan_new - fan_old, dense.shape[1]), dense.dtype)
            return np.concatenate(
                [dense * math.sqrt(fan_new / fan_old), pad], 0)

        _transfer_linear(old_spec, new_spec, old_lp,
                         new_params[name], widen)

    _transfer_modal_rescale(config, new_config, params, new_params,
                            len(new_map))
    return new_config, new_params


def single_modal_params(
    config: Dict[str, Any],
    params: Dict[str, Any],
    ref_modal: str,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Collapse a multi-modal model onto one modality (reference
    get_single_modal_model_dct): the chosen modal's one-hot weights fold
    into linear biases ('common' folds nothing); modal-wise shift/scale
    select the modal's row."""
    if not config.get(KEY.USE_MODALITY, False):
        return config, params
    modal_map = config[KEY.MODAL_MAP]
    if ref_modal != 'common' and ref_modal not in modal_map:
        raise KeyError(
            f'{ref_modal} not in modal map; use one of {list(modal_map)}')
    ref_idx: Optional[int] = (
        None if ref_modal == 'common' else modal_map[ref_modal])

    new_config = copy.deepcopy(config)
    new_config[KEY.USE_MODALITY] = False
    new_config[KEY.USE_BIAS_IN_LINEAR] = True  # fold target (ref :162)
    new_config[KEY.MODAL_MAP] = {}
    new_config[KEY.NUM_MODALITIES] = 0
    for use_key, name in ((KEY.USE_MODAL_WISE_SHIFT, KEY.SHIFT),
                          (KEY.USE_MODAL_WISE_SCALE, KEY.SCALE)):
        if new_config.get(use_key, False):
            v = np.asarray(new_config[name])
            if v.ndim == 2:
                new_config[name] = v[ref_idx or 0].tolist()
            new_config[use_key] = False

    old_model = build_e3_equivariant_model(config)
    new_model = build_e3_equivariant_model(new_config)
    new_params = _copy_common(params, _init_numpy(new_model))

    for name, old_layer in _modal_linears(old_model):
        n_modal = old_layer.num_modalities
        old_spec = old_layer.spec
        new_spec, new_lp = _resolve_linear(new_model, new_params, name)

        folded: Dict[str, np.ndarray] = {}

        def strip(dense, _nm=n_modal, _f=folded):
            fan_old = dense.shape[0]
            fan_new = fan_old - _nm
            if _f is not None and ref_idx is not None:
                _f['bias'] = dense[fan_new + ref_idx] / math.sqrt(fan_old)
            return dense[:fan_new] * math.sqrt(fan_new / fan_old)

        _transfer_linear(old_spec, new_spec, params[name], new_lp, strip)
        if 'bias' in folded:
            scal_new, _ = _split_paths(new_spec)
            j_out = scal_new[0][4]
            b_key = f'b{j_out}'
            b = np.asarray(new_lp.get(
                b_key, np.zeros_like(folded['bias'])))
            new_lp[b_key] = np.asarray(b + folded['bias'])

    rk = 'rescale_atomic_energy'
    if rk in params and rk in new_params:
        for pname in ('shift', 'scale'):
            v = np.asarray(params[rk][pname])
            if v.ndim == 2 and np.asarray(new_params[rk][pname]).ndim == 1:
                new_params[rk][pname] = np.asarray(v[ref_idx or 0])
    return new_config, new_params


def _transfer_modal_rescale(old_config, new_config, params, new_params,
                            n_modal_new: int):
    rk = 'rescale_atomic_energy'
    if rk not in params or rk not in new_params:
        return
    for pname, use_key in (('shift', KEY.USE_MODAL_WISE_SHIFT),
                           ('scale', KEY.USE_MODAL_WISE_SCALE)):
        if not new_config.get(use_key, False):
            continue
        v = np.asarray(params[rk][pname])
        if v.ndim == 1:
            v = np.tile(v[None], (1, 1)) if v.shape[0] == 1 else v[None]
        rows = np.concatenate([v] + [v[:1]] * (n_modal_new - v.shape[0]), 0)
        new_params[rk][pname] = np.asarray(rows)


def _copy_common(src: Dict[str, Any], dst: Dict[str, Any]) -> Dict[str, Any]:
    """Copy every parameter whose name and shape match; leave the rest
    (freshly initialized, then patched by the callers)."""
    out: Dict[str, Any] = {}
    for lname, ldst in dst.items():
        out[lname] = dict(ldst)
        lsrc = src.get(lname, {})
        for pname, v in ldst.items():
            sv = lsrc.get(pname)
            if sv is not None and np.shape(sv) == np.shape(v):
                out[lname][pname] = sv
    return out
