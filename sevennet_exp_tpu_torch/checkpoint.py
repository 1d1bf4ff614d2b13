"""Checkpoints: the native writer and loader (no JAX, no optax) and the
reference SevenNet ``.pth`` ingestion.

Counterpart of ``sevennet_exp_tpu/checkpoint.py``. ``save_checkpoint``
writes the JAX package's format from the port's trainer: ``params`` in the
JAX tree layout and an ``optimizer_state`` of numpy arrays and builtins
only, so that the JAX ``load_checkpoint`` reads a checkpoint the port
trained.
A native checkpoint is a pickle of ``{config, params, optimizer_state,
epoch, version, hash}`` whose ``params`` are plain numpy arrays. Its
``optimizer_state`` holds optax named tuples, and a plain ``pickle.load``
imports optax -- which imports JAX. ``load_native_checkpoint`` therefore
unpickles with a restricted ``find_class``:

  - every ``optax.*`` global becomes an inert stub and the optimizer
    state is thrown away;
  - ``numpy._core.*`` maps to ``numpy.core.*`` where the installed numpy
    predates the rename;
  - any other module outside numpy, the builtins and the standard
    containers raises, so a corrupt or foreign pickle is not swallowed.

A reference checkpoint is a ``torch.save`` file ``{config,
model_state_dict, ...}`` (reference trainer.py:192-205), a zip archive or
torch's legacy non-zip pickle.
``convert_torch_state_dict`` writes it into the JAX tree layout as numpy
(one conversion for both packages; ``params_from_numpy`` carries it onto
the port's buffers), reproducing the e3nn flat weight layouts of Linear
and FullyConnectedTensorProduct and the pre-v0.11 convolution weight
order with its w3j sign flips (reference
scripts/backward_compatibility.py:74-176). The format is decided by the
file's first bytes, never by trying one loader after the other: a zip
archive or a pickle that opens with torch's legacy magic number goes to
``torch.load``, anything else to the native loader, whose errors pass
through.
"""

from __future__ import annotations

import importlib
import os
import pickle
import uuid
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import _keys as KEY
from .irreps import Irrep
from .model import layers as L
from .model.build import build_e3_equivariant_model
from .model.model import SevenNetModel
from .ops.wigner import wigner_3j
from .util import resolve_checkpoint


class _Stub:
    """Inert stand-in for an optax class inside the optimizer state."""

    def __init__(self, *args, **kwargs):
        pass


_ALLOWED_MODULES = ('numpy', 'builtins', 'collections', 'copyreg',
                    '_codecs')


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split('.')[0]
        if root == 'optax':
            return type(name, (_Stub,), {'__module__': 'stub.' + module})
        if root not in _ALLOWED_MODULES:
            raise pickle.UnpicklingError(
                f'checkpoint names {module}.{name}: not a numpy/builtin '
                'global, refusing to import it')
        if module.startswith('numpy._core'):
            try:
                importlib.import_module(module)
            except ImportError:
                module = 'numpy.core' + module[len('numpy._core'):]
        return super().find_class(module, name)


def save_checkpoint(path: str, config: Dict, params,
                    optimizer_state=None, epoch: Optional[int] = None):
    """{config, params, optimizer_state, epoch, version, hash} as a
    pickle (JAX ``save_checkpoint``); ``params`` and ``optimizer_state``
    must hold numpy arrays and builtins (``Trainer.get_checkpoint_pieces``).
    """
    payload = {
        'config': config,
        'params': params,
        'optimizer_state': optimizer_state,
        'epoch': epoch,
        'version': '0.1.0+tpu',
        'hash': uuid.uuid4().hex,
    }
    with open(path, 'wb') as f:
        pickle.dump(payload, f)


def load_native_checkpoint(path: str) -> Dict[str, Any]:
    """{config, params, epoch, version, hash}; optimizer state dropped."""
    with open(path, 'rb') as fh:
        payload = _CheckpointUnpickler(fh).load()
    if not isinstance(payload, dict) or 'params' not in payload:
        raise ValueError(f'{path}: not a native SevenNet checkpoint')
    payload['optimizer_state'] = None
    return payload


def params_from_numpy(params: Dict[str, Any], device='cpu'
                      ) -> Dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts of numpy arrays) -> the port's
    flat state {'layer/sub/key': float32 tensor}, for
    ``SevenNetModel.load_state``."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f'{prefix}{k}'
            if isinstance(v, dict):
                walk(v, key + '/')
            else:
                out[key] = torch.as_tensor(
                    np.array(v, dtype=np.float32), device=device)

    walk(params, '')
    return out


# ---------------------------------------------------------------------------
# reference torch checkpoint ingestion
# ---------------------------------------------------------------------------

_ZIP_MAGIC = b'PK\x03\x04'
# torch's legacy (non-zip) format: a protocol-2 pickle whose first object
# is the long 0x1950a86a20f9469cfc6c (PROTO 2, LONG1 of 10 bytes, the
# magic little-endian)
_LEGACY_MAGIC = (b'\x80\x02\x8a\x0a'
                 + (0x1950a86a20f9469cfc6c).to_bytes(10, 'little'))


def is_torch_archive(path: str) -> bool:
    """A file for ``torch.load``: a torch zip archive (``torch.save``'s
    format since torch 1.6) or torch's legacy format, decided by the first
    bytes."""
    with open(path, 'rb') as fh:
        head = fh.read(len(_LEGACY_MAGIC))
    return head[:4] == _ZIP_MAGIC or head == _LEGACY_MAGIC


def load_torch_checkpoint(path: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Read a reference torch checkpoint -> (config, numpy state dict)."""
    cp = torch.load(path, map_location='cpu', weights_only=False)
    config = cp['config']
    sd = {
        k: v.detach().cpu().numpy() if hasattr(v, 'detach') else v
        for k, v in cp['model_state_dict'].items()
    }
    return config, sd


def _version_tuple(v: str):
    parts = str(v).split('.')
    out = []
    for p in parts[:3]:
        num = ''.join(c for c in p if c.isdigit())
        out.append(int(num) if num else 0)
    while len(out) < 3:
        out.append(0)
    return tuple(out)


def _convert_linear(spec, prefix: str, sd) -> Dict[str, np.ndarray]:
    """e3nn Linear flat weight -> per-path params (order: i_in outer)."""
    flat = sd[f'{prefix}.weight'].reshape(-1)
    params: Dict[str, np.ndarray] = {}
    off = 0
    for n, (i, j, mi, mo, _) in enumerate(spec.paths):
        w = flat[off:off + mi * mo].reshape(mi, mo)
        params[f'w{n}'] = np.ascontiguousarray(w, dtype=np.float32)
        off += mi * mo
    assert off == flat.size, f'{prefix}: weight numel mismatch {off} vs {flat.size}'
    if spec.biases:
        bflat = sd[f'{prefix}.bias'].reshape(-1)
        boff = 0
        for j, (mul, ir) in enumerate(spec.irreps_out):
            if ir == Irrep(0, 1):
                params[f'b{j}'] = np.ascontiguousarray(
                    bflat[boff:boff + mul], dtype=np.float32
                )
                boff += mul
    return params


def _convert_fctp(spec, prefix: str, sd) -> Dict[str, np.ndarray]:
    flat = sd[f'{prefix}.weight'].reshape(-1)
    params: Dict[str, np.ndarray] = {}
    off = 0
    for n, (i1, i2, k) in enumerate(spec.instructions):
        m1 = spec.irreps_in1[i1].mul
        m2 = spec.irreps_in2[i2].mul
        m3 = spec.irreps_out[k].mul
        num = m1 * m2 * m3
        params[f'w{n}'] = np.ascontiguousarray(
            flat[off:off + num].reshape(m1, m2, m3), dtype=np.float32
        )
        off += num
    assert off == flat.size, f'{prefix}: fctp numel mismatch'
    return params


def _resort_conv_weight_columns(
    tp_spec, last_w: np.ndarray, conv_name: str, sd
) -> np.ndarray:
    """Old (<=0.10) checkpoints order radial-MLP output columns by the
    UNSORTED instruction list and may carry sign-flipped w3j; reorder to the
    sorted convention and fold sign flips into the columns
    (reference backward_compatibility.py:74-155)."""
    in1 = tp_spec.irreps_in1
    in2 = tp_spec.irreps_in2
    out = tp_spec.irreps_out
    # old column ranges per unsorted instruction
    col_ranges = []
    off = 0
    for (i1, i2, k) in tp_spec.instructions_unsorted:
        mul = in1[i1].mul
        col_ranges.append(((i1, i2, k), off, mul))
        off += mul
    assert off == last_w.shape[1]
    # map each sorted instruction to its old columns
    pieces = []
    for inst in tp_spec.instructions:
        for (old_inst, o, mul) in col_ranges:
            if old_inst == inst:
                block = last_w[:, o:o + mul]
                l1 = in1[inst[0]].ir.l
                l2 = in2[inst[1]].ir.l
                l3 = out[inst[2]].ir.l
                if l1 > 0 and l2 > 0 and l3 > 0:
                    w3j_key = (
                        f'{conv_name}.convolution._compiled_main_left_right.'
                        f'_w3j_{l1}_{l2}_{l3}'
                    )
                    if w3j_key in sd:
                        mine = wigner_3j(l1, l2, l3)
                        stored = sd[w3j_key]
                        if not np.allclose(stored, mine, atol=1e-5):
                            assert np.allclose(stored, -mine, atol=1e-5), (
                                f'{w3j_key}: unexpected w3j in checkpoint'
                            )
                            block = -block
                pieces.append(block)
                break
        else:
            raise ValueError(f'missing instruction {inst} in old layout')
    return np.concatenate(pieces, axis=1)


def convert_torch_state_dict(
    model: SevenNetModel, sd: Dict[str, np.ndarray], cp_config: Dict
) -> Dict:
    """Torch state dict -> the JAX parameter pytree (same layer names) as
    numpy. The layers converted are the JAX converter's: a
    ``MultiCutoffEdgeEmbedding`` is not an ``EdgeEmbedding`` there either,
    so its coefficients are not converted and the tree has no entry for it
    (``SevenNetModel.load_state`` then raises on the missing buffers)."""
    version = _version_tuple(cp_config.get('version', '0.11.0'))
    needs_sort = version < (0, 11, 0)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)  # noqa: E731

    params: Dict[str, Any] = {}
    for name, layer in model.layers.items():
        if isinstance(layer, L.EdgeEmbedding):
            key = f'{name}.basis_function.coeffs'
            if key in sd:
                params[name] = {'coeffs': f32(sd[key])}
        elif isinstance(layer, L.IrrepsLinear):
            params[name] = _convert_linear(layer.spec, f'{name}.linear', sd)
        elif isinstance(layer, L.SelfConnectionLinearIntro):
            params[name] = _convert_linear(layer.spec, f'{name}.linear', sd)
        elif isinstance(layer, L.SelfConnectionIntro):
            params[name] = _convert_fctp(
                layer.spec, f'{name}.fc_tensor_product', sd
            )
        elif isinstance(layer, L.IrrepsConvolution):
            nlayers = len(layer.weight_nn.hs) - 1
            wnn = {}
            for i in range(nlayers):
                wnn[f'w{i}'] = f32(sd[f'{name}.weight_nn.layer{i}.weight'])
            if needs_sort:
                wnn[f'w{nlayers - 1}'] = f32(_resort_conv_weight_columns(
                    layer.tp, wnn[f'w{nlayers - 1}'], name, sd
                ))
            params[name] = {
                'weight_nn': wnn,
                'denominator': f32(sd[f'{name}.denominator'].reshape(1)),
            }
            if layer.si2 is not None:
                # fused block: reference stores these under
                # '{t}_self_interaction_2.linear.*'
                si2_name = name.replace('_convolution',
                                        '_self_interaction_2')
                params[name]['si2'] = _convert_linear(
                    layer.si2, f'{si2_name}.linear', sd
                )
        elif isinstance(layer, (L.Rescale, L.SpeciesWiseRescale)):
            params[name] = {
                'shift': f32(np.atleast_1d(sd[f'{name}.shift'])),
                'scale': f32(np.atleast_1d(sd[f'{name}.scale'])),
            }
        elif isinstance(layer, L.ModalWiseRescale):
            params[name] = {
                'shift': f32(sd[f'{name}.shift']),
                'scale': f32(sd[f'{name}.scale']),
            }
        elif isinstance(layer, L.FCNReadout):
            n = len(layer.spec.hs) - 1
            params[name] = {
                f'w{i}': f32(sd[f'{name}.fcn.layer{i}.weight'])
                for i in range(n)
            }
    return params


def _patch_old_config(config: Dict) -> Dict:
    """Reference backward_compatibility.py:13-36."""
    version = _version_tuple(config.get('version', '0.11.0'))
    if version <= (0, 9, 99):
        if (
            config.get(KEY.CUTOFF_FUNCTION, {}).get(KEY.CUTOFF_FUNCTION_NAME)
            == 'XPLOR'
        ):
            config[KEY.CUTOFF_FUNCTION].pop('poly_cut_p_value', None)
        if KEY.TRAIN_DENOMINTAOR not in config:
            config[KEY.TRAIN_DENOMINTAOR] = config.pop(
                'train_avg_num_neigh', False
            )
        if KEY.CONV_DENOMINATOR not in config:
            config[KEY.CONV_DENOMINATOR] = 0.0
        if KEY._NORMALIZE_SPH not in config:
            config[KEY._NORMALIZE_SPH] = False
    return config


# ---------------------------------------------------------------------------
# the checkpoint handle (reference sevenn/checkpoint.py SevenNetCheckpoint)
# ---------------------------------------------------------------------------

# stored configs may still carry dataset-statistic keywords; the stored
# parameters hold the resolved arrays, so the build only needs numeric
# placeholders (as sevennet_exp_tpu.checkpoint.SevenNetCheckpoint)
_PLACEHOLDERS = {KEY.SHIFT: 0.0, KEY.SCALE: 1.0, KEY.CONV_DENOMINATOR: 1.0}


def _build_from_config(config: Dict) -> SevenNetModel:
    cfg = dict(config)
    for k, v in _PLACEHOLDERS.items():
        if isinstance(cfg.get(k), str):
            cfg[k] = v
    return build_e3_equivariant_model(cfg)


class SevenNetCheckpoint:
    """Lazy handle on a checkpoint: a path or a pretrained keyword
    ('7net-0', '7net-0-nacl-demo', ...), native or reference ``.pth``.
    ``params`` is the JAX parameter tree as numpy; ``build_model`` builds
    the port's model with them."""

    def __init__(self, checkpoint_path: str):
        checkpoint_path = resolve_checkpoint(checkpoint_path)
        self.checkpoint_path = os.path.abspath(checkpoint_path)
        self._loaded = False
        self._config: Optional[Dict] = None
        self._params = None
        self._torch_sd = None
        self._epoch = None

    def _load(self):
        if self._loaded:
            return
        if is_torch_archive(self.checkpoint_path):
            config, self._torch_sd = load_torch_checkpoint(
                self.checkpoint_path)
            self._config = _patch_old_config(dict(config))
        else:
            payload = load_native_checkpoint(self.checkpoint_path)
            self._config = payload['config']
            self._params = payload['params']
            self._epoch = payload.get('epoch')
        self._loaded = True

    @property
    def is_torch(self) -> bool:
        self._load()
        return self._torch_sd is not None

    @property
    def config(self) -> Dict:
        self._load()
        return dict(self._config)

    @property
    def epoch(self):
        """The stored epoch (None for a reference ``.pth``, as in JAX)."""
        self._load()
        return self._epoch

    @property
    def params(self) -> Dict[str, Any]:
        """The parameters in the JAX tree layout, numpy leaves."""
        self._load()
        if self._params is None:
            self._params = convert_torch_state_dict(
                _build_from_config(self._config), self._torch_sd,
                self._config)
        return self._params

    def build_model(self, device='cuda') -> Tuple[SevenNetModel,
                                                   Dict[str, torch.Tensor]]:
        """(model on ``device`` with the stored weights, flat state)."""
        params = self.params
        model = _build_from_config(self._config).to(device)
        state = params_from_numpy(params, device=device)
        model.load_state(state)
        return model, state

    def yaml_dict(self, mode: str = 'reproduce') -> Dict:
        """Config as {model:, train:, data:} sections for re-training
        (reference checkpoint.py:313-397)."""
        from . import _const
        cfg = self.config
        model_keys = set(_const.DEFAULT_E3_EQUIVARIANT_MODEL_CONFIG)
        train_keys = set(_const.DEFAULT_TRAINING_CONFIG)
        data_keys = set(_const.DEFAULT_DATA_CONFIG)
        out = {'model': {}, 'train': {}, 'data': {}}
        for k, v in cfg.items():
            if k in model_keys or k == KEY.CHEMICAL_SPECIES:
                out['model'][k] = v
            elif k in train_keys:
                out['train'][k] = v
            elif k in data_keys:
                out['data'][k] = v
        if mode == 'continue':
            out['train'][KEY.CONTINUE] = {
                KEY.CHECKPOINT: self.checkpoint_path
            }
        return out

    def append_modal(self, new_modals, output_path: str) -> str:
        """Append modalities to this checkpoint and save the widened one
        (reference checkpoint.py:399-447). New modal one-hot rows start
        at zero; original modalities are bit-preserved."""
        from .scripts.convert_modality import append_modality_to_params
        new_config, new_params = append_modality_to_params(
            self.config, self.params, list(new_modals))
        save_checkpoint(
            output_path, new_config, new_params, epoch=self.epoch)
        return output_path

    def to_single_modal(self, ref_modal: str, output_path: str) -> str:
        """Collapse onto one modality and save (reference
        convert_model_modality.get_single_modal_model_dct)."""
        from .scripts.convert_modality import single_modal_params
        new_config, new_params = single_modal_params(
            self.config, self.params, ref_modal)
        save_checkpoint(
            output_path, new_config, new_params, epoch=self.epoch)
        return output_path


def load_checkpoint(checkpoint: str) -> SevenNetCheckpoint:
    if os.path.isfile(checkpoint):
        return SevenNetCheckpoint(checkpoint)
    raise ValueError(f'checkpoint not found: {checkpoint}')
