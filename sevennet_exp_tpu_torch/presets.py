"""Flagship model configurations (reference sevenn/presets/*.yaml).

Copy of ``sevennet_exp_tpu/presets.py``, kept here so that the PyTorch
port imports nothing of the JAX package.

`sevennet_0_config()` reproduces the 7net-0 architecture
(reference presets/sevennet-0.yaml: 5 interaction layers,
128x0e+64x1e+32x2e, r_cut 5 A, XPLOR 4.5, 8 bessel, SO(3) no parity,
linear self-connection); `sevennet_l3i5_config()` the lmax=3 variant.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import _keys as KEY
from .util import chemical_species_preprocess


def _base(cutoff: float, layers: int, irreps: List[str], lmax: int,
          parity: bool, self_conn: str, cutoff_fn: Dict,
          species: Optional[List[str]] = None) -> Dict:
    cfg = {
        KEY.CUTOFF: cutoff,
        KEY.NODE_FEATURE_MULTIPLICITY: 128,
        KEY.IRREPS_MANUAL: irreps,
        KEY.LMAX: lmax,
        KEY.LMAX_EDGE: -1,
        KEY.LMAX_NODE: -1,
        KEY.IS_PARITY: parity,
        KEY.NUM_CONVOLUTION: layers,
        KEY.RADIAL_BASIS: {
            KEY.RADIAL_BASIS_NAME: 'bessel', KEY.BESSEL_BASIS_NUM: 8,
        },
        KEY.CUTOFF_FUNCTION: cutoff_fn,
        KEY.ACTIVATION_RADIAL: 'silu',
        KEY.ACTIVATION_SCARLAR: {'e': 'silu', 'o': 'tanh'},
        KEY.ACTIVATION_GATE: {'e': 'silu', 'o': 'tanh'},
        KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [64, 64],
        KEY.CONV_DENOMINATOR: 35.0,
        KEY.TRAIN_DENOMINTAOR: False,
        KEY.TRAIN_SHIFT_SCALE: False,
        KEY.SELF_CONNECTION_TYPE: self_conn,
        KEY.USE_BIAS_IN_LINEAR: False,
        KEY.READOUT_AS_FCN: False,
        KEY.INTERACTION_TYPE: 'nequip',
        KEY._NORMALIZE_SPH: True,
        KEY.SHIFT: 0.0,
        KEY.SCALE: 1.0,
        KEY.MULTI_CUTOFF: None,
    }
    if species is None:
        cfg.update(chemical_species_preprocess([], universal=True))
    else:
        cfg.update(chemical_species_preprocess(species))
    return cfg


def sevennet_0_config(species: Optional[List[str]] = None) -> Dict:
    return _base(
        cutoff=5.0, layers=5,
        irreps=['128x0e', '128x0e+64x1e+32x2e', '128x0e+64x1e+32x2e',
                '128x0e+64x1e+32x2e', '128x0e+64x1e+32x2e', '128x0e'],
        lmax=2, parity=False, self_conn='linear',
        cutoff_fn={KEY.CUTOFF_FUNCTION_NAME: 'XPLOR', 'cutoff_on': 4.5},
        species=species,
    )


def sevennet_l3i5_config(species: Optional[List[str]] = None) -> Dict:
    return _base(
        cutoff=5.0, layers=5,
        irreps=['128x0e', '128x0e+64x1e+32x2e+16x3e',
                '128x0e+64x1e+32x2e+16x3e', '128x0e+64x1e+32x2e+16x3e',
                '128x0e+64x1e+32x2e+16x3e', '128x0e'],
        lmax=3, parity=False, self_conn='linear',
        cutoff_fn={KEY.CUTOFF_FUNCTION_NAME: 'XPLOR', 'cutoff_on': 4.5},
        species=species,
    )
