"""Defaults & allowed values (reference sevenn/_const.py).

Copy of ``sevennet_exp_tpu/_const.py``, kept here so the PyTorch port
imports nothing of the JAX package: the model builder reads the model
defaults, ``parse_input`` all three sections and their conditions.
"""

from __future__ import annotations

from typing import Any, Dict

from . import _keys as KEY

NUM_UNIV_ELEMENT = 119  # Z = 0 ~ 118

IMPLEMENTED_RADIAL_BASIS = ['bessel']
IMPLEMENTED_CUTOFF_FUNCTION = ['poly_cut', 'XPLOR']
IMPLEMENTED_SELF_CONNECTION_TYPE = ['nequip', 'linear']
IMPLEMENTED_INTERACTION_TYPE = ['nequip']

IMPLEMENTED_SHIFT = ['per_atom_energy_mean', 'elemwise_reference_energies']
IMPLEMENTED_SCALE = ['force_rms', 'per_atom_energy_std', 'elemwise_force_rms']

SUPPORTING_METRICS = ['RMSE', 'ComponentRMSE', 'MAE', 'Loss']
SUPPORTING_ERROR_TYPES = [
    'TotalEnergy', 'Energy', 'Force', 'Stress', 'Stress_GPa', 'TotalLoss',
]

IMPLEMENTED_MODEL = ['E3_equivariant_model']

# eV/A^3 -> kbar
KBAR_COEFF = 1602.1766208
GPA_COEFF = 160.21766208

DEFAULT_E3_EQUIVARIANT_MODEL_CONFIG: Dict[str, Any] = {
    KEY.CUTOFF: 4.5,
    KEY.NODE_FEATURE_MULTIPLICITY: 32,
    KEY.IRREPS_MANUAL: False,
    KEY.LMAX: 1,
    KEY.LMAX_EDGE: -1,
    KEY.LMAX_NODE: -1,
    KEY.IS_PARITY: True,
    KEY.NUM_CONVOLUTION: 3,
    KEY.RADIAL_BASIS: {KEY.RADIAL_BASIS_NAME: 'bessel'},
    KEY.CUTOFF_FUNCTION: {KEY.CUTOFF_FUNCTION_NAME: 'poly_cut'},
    KEY.ACTIVATION_RADIAL: 'silu',
    KEY.MULTI_CUTOFF: None,
    KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64],
    KEY.ACTIVATION_SCARLAR: {'e': 'silu', 'o': 'tanh'},
    KEY.ACTIVATION_GATE: {'e': 'silu', 'o': 'tanh'},
    KEY.CONV_DENOMINATOR: 'avg_num_neigh',
    KEY.TRAIN_DENOMINTAOR: False,
    KEY.TRAIN_SHIFT_SCALE: False,
    KEY.USE_BIAS_IN_LINEAR: False,
    KEY.USE_MODAL_NODE_EMBEDDING: False,
    KEY.USE_MODAL_SELF_INTER_INTRO: False,
    KEY.USE_MODAL_SELF_INTER_OUTRO: False,
    KEY.USE_MODAL_OUTPUT_BLOCK: False,
    KEY.READOUT_AS_FCN: False,
    KEY.READOUT_FCN_HIDDEN_NEURONS: [30, 30],
    KEY.READOUT_FCN_ACTIVATION: 'relu',
    KEY.SELF_CONNECTION_TYPE: 'nequip',
    KEY.INTERACTION_TYPE: 'nequip',
    KEY._NORMALIZE_SPH: True,
}

DEFAULT_DATA_CONFIG: Dict[str, Any] = {
    KEY.DTYPE: 'single',
    KEY.DATA_FORMAT: 'ase',
    KEY.DATA_FORMAT_ARGS: {},
    KEY.SAVE_DATASET: False,
    KEY.SAVE_BY_LABEL: False,
    KEY.SAVE_BY_TRAIN_VALID: False,
    KEY.RATIO: 0.1,
    KEY.BATCH_SIZE: 6,
    KEY.PREPROCESS_NUM_CORES: 1,
    KEY.COMPUTE_STATISTICS: True,
    KEY.DATASET_TYPE: 'graph',
    KEY.USE_MODAL_WISE_SHIFT: False,
    KEY.USE_MODAL_WISE_SCALE: False,
    KEY.SHIFT: 'per_atom_energy_mean',
    KEY.SCALE: 'force_rms',
}

DEFAULT_TRAINING_CONFIG: Dict[str, Any] = {
    KEY.RANDOM_SEED: 1,
    KEY.EPOCH: 300,
    KEY.LOSS: 'mse',
    KEY.LOSS_PARAM: {},
    KEY.OPTIMIZER: 'adam',
    KEY.OPTIM_PARAM: {},
    KEY.SCHEDULER: 'exponentiallr',
    KEY.SCHEDULER_PARAM: {},
    KEY.FORCE_WEIGHT: 0.1,
    KEY.STRESS_WEIGHT: 1e-6,
    KEY.PER_EPOCH: 5,
    KEY.CONTINUE: {
        KEY.CHECKPOINT: False,
        KEY.RESET_OPTIMIZER: False,
        KEY.RESET_SCHEDULER: False,
        KEY.RESET_EPOCH: False,
        KEY.USE_STATISTIC_VALUES_OF_CHECKPOINT: True,
    },
    KEY.CSV_LOG: 'log.csv',
    KEY.NUM_WORKERS: 0,
    KEY.IS_TRAIN_STRESS: True,
    KEY.TRAIN_SHUFFLE: True,
    KEY.ERROR_RECORD: [
        ['Energy', 'RMSE'],
        ['Force', 'RMSE'],
        ['Stress', 'RMSE'],
        ['TotalLoss', 'None'],
    ],
    KEY.BEST_METRIC: 'TotalLoss',
    KEY.USE_WEIGHT: False,
    KEY.USE_MODALITY: False,
}


# Per-key validation conditions (reference sevenn/parse_input.py:14-52
# contract): a type means isinstance-or-cast, a callable must return
# truthy, a dict recurses into the sub-section. Keys without an entry
# accept any value.
MODEL_CONFIG_CONDITION: Dict[str, Any] = {
    KEY.CUTOFF: float,
    KEY.NODE_FEATURE_MULTIPLICITY: int,
    KEY.LMAX: int,
    KEY.LMAX_EDGE: int,
    KEY.LMAX_NODE: int,
    KEY.IS_PARITY: bool,
    KEY.NUM_CONVOLUTION: int,
    KEY.RADIAL_BASIS: {
        KEY.RADIAL_BASIS_NAME: lambda x: x in IMPLEMENTED_RADIAL_BASIS,
    },
    KEY.CUTOFF_FUNCTION: {
        KEY.CUTOFF_FUNCTION_NAME:
            lambda x: x in IMPLEMENTED_CUTOFF_FUNCTION,
    },
    KEY.ACTIVATION_RADIAL: str,
    KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: list,
    KEY.CONV_DENOMINATOR: lambda x: isinstance(x, (float, int))
    or x in ('avg_num_neigh', 'sqrt_avg_num_neigh'),
    KEY.TRAIN_DENOMINTAOR: bool,
    KEY.TRAIN_SHIFT_SCALE: bool,
    KEY.USE_BIAS_IN_LINEAR: bool,
    KEY.USE_MODAL_NODE_EMBEDDING: bool,
    KEY.USE_MODAL_SELF_INTER_INTRO: bool,
    KEY.USE_MODAL_SELF_INTER_OUTRO: bool,
    KEY.USE_MODAL_OUTPUT_BLOCK: bool,
    KEY.READOUT_AS_FCN: bool,
    KEY.READOUT_FCN_HIDDEN_NEURONS: list,
    KEY.READOUT_FCN_ACTIVATION: str,
    KEY.SELF_CONNECTION_TYPE:
        lambda x: x in IMPLEMENTED_SELF_CONNECTION_TYPE,
    KEY.INTERACTION_TYPE: lambda x: x in IMPLEMENTED_INTERACTION_TYPE,
    KEY._NORMALIZE_SPH: bool,
}

DATA_CONFIG_CONDITION: Dict[str, Any] = {
    KEY.DTYPE: str,
    KEY.DATA_FORMAT: str,
    KEY.DATA_FORMAT_ARGS: dict,
    KEY.SAVE_BY_LABEL: bool,
    KEY.SAVE_BY_TRAIN_VALID: bool,
    KEY.RATIO: float,
    KEY.BATCH_SIZE: int,
    KEY.PREPROCESS_NUM_CORES: int,
    KEY.COMPUTE_STATISTICS: bool,
    KEY.DATASET_TYPE: lambda x: x in ('graph', 'atoms'),
    KEY.USE_MODAL_WISE_SHIFT: bool,
    KEY.USE_MODAL_WISE_SCALE: bool,
    KEY.SHIFT: lambda x: isinstance(x, (float, int, list, dict))
    or x in IMPLEMENTED_SHIFT,
    KEY.SCALE: lambda x: isinstance(x, (float, int, list, dict))
    or x in IMPLEMENTED_SCALE,
}

TRAIN_CONFIG_CONDITION: Dict[str, Any] = {
    KEY.RANDOM_SEED: int,
    KEY.EPOCH: int,
    KEY.LOSS: str,
    KEY.LOSS_PARAM: dict,
    KEY.OPTIMIZER: str,
    KEY.OPTIM_PARAM: dict,
    KEY.SCHEDULER: str,
    KEY.SCHEDULER_PARAM: dict,
    KEY.FORCE_WEIGHT: float,
    KEY.STRESS_WEIGHT: float,
    KEY.PER_EPOCH: int,
    KEY.CONTINUE: {
        KEY.RESET_OPTIMIZER: bool,
        KEY.RESET_SCHEDULER: bool,
        KEY.RESET_EPOCH: bool,
        KEY.USE_STATISTIC_VALUES_OF_CHECKPOINT: bool,
    },
    KEY.CSV_LOG: str,
    KEY.NUM_WORKERS: int,
    KEY.IS_TRAIN_STRESS: bool,
    KEY.TRAIN_SHUFFLE: bool,
    KEY.BEST_METRIC: str,
    KEY.USE_WEIGHT: bool,
    KEY.USE_MODALITY: bool,
    KEY.ERROR_RECORD: lambda lst: isinstance(lst, list) and all(
        isinstance(p, (list, tuple)) and len(p) == 2
        and (p[1] in SUPPORTING_METRICS or p[1] == 'None')
        for p in lst
    ),
}


def model_defaults(config):
    defaults = dict(DEFAULT_E3_EQUIVARIANT_MODEL_CONFIG)
    if not config.get(KEY.READOUT_AS_FCN, defaults[KEY.READOUT_AS_FCN]):
        defaults.pop(KEY.READOUT_FCN_ACTIVATION, None)
        defaults.pop(KEY.READOUT_FCN_HIDDEN_NEURONS, None)
    return defaults


def data_defaults(config):
    defaults = dict(DEFAULT_DATA_CONFIG)
    if KEY.LOAD_VALIDSET in config:
        defaults.pop(KEY.RATIO, None)
    return defaults


def train_defaults(config):
    defaults = dict(DEFAULT_TRAINING_CONFIG)
    if not config.get(KEY.IS_TRAIN_STRESS, defaults[KEY.IS_TRAIN_STRESS]):
        defaults.pop(KEY.STRESS_WEIGHT, None)
    return defaults
