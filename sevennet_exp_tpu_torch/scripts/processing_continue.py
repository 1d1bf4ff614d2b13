"""Continue / fine-tune bootstrap (reference
sevenn/scripts/processing_continue.py:15-89).

Copy of ``sevennet_exp_tpu/scripts/processing_continue.py`` on the port's
checkpoint handle: the model is built on the CPU (the trainer moves it),
the parameters are the checkpoint's numpy tree. As in the JAX package the
optimizer and the scheduler start fresh: ``reset_optimizer`` and
``reset_scheduler`` are carried in the state and read by nothing.

Loads a checkpoint (native or torch), inherits shift/scale/
conv_denominator and chemical species from it (overriding dataset
statistics, processing_continue.py:43-64), and returns the starting
parameters + state to reset or keep.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as _np

from .. import _keys as KEY
from ..checkpoint import SevenNetCheckpoint
from ..logger import Logger


def processing_continue_v2(config: Dict[str, Any]) -> Tuple[Any, Dict]:
    log = Logger()
    continue_cfg = config[KEY.CONTINUE]
    cp_path = continue_cfg[KEY.CHECKPOINT]
    log.writeline(f'Continue from {cp_path}')

    cp = SevenNetCheckpoint(cp_path)
    cp_config = cp.config
    model, _ = cp.build_model(device='cpu')
    params = cp.params

    # statistics are inherited from the RESOLVED model parameters, not
    # the stored config: the config may still carry keyword strings
    # ('per_atom_energy_std', ...) that a rebuild-from-config path
    # cannot consume (reference resolves from the state dict,
    # processing_continue.py:43-52)
    if continue_cfg.get(KEY.USE_STATISTIC_VALUES_OF_CHECKPOINT, True):
        rescale = params.get('rescale_atomic_energy', {})
        for cfg_key, p_key in ((KEY.SHIFT, 'shift'),
                               (KEY.SCALE, 'scale')):
            if p_key in rescale:
                v = _np.asarray(rescale[p_key]).reshape(-1)
                config[cfg_key] = (
                    float(v[0]) if v.size == 1 else v.tolist()
                )
                log.writeline(
                    f'{cfg_key} inherited from checkpoint parameters'
                )
        if KEY.CONV_DENOMINATOR in cp_config:
            denoms = [
                float(_np.asarray(p['denominator']).reshape(-1)[0])
                for name, p in params.items()
                if name.endswith('_convolution') and 'denominator' in p
            ]
            config[KEY.CONV_DENOMINATOR] = (
                denoms if denoms else cp_config[KEY.CONV_DENOMINATOR]
            )
            log.writeline(
                'conv_denominator inherited from checkpoint parameters'
            )
    for k in (KEY.CHEMICAL_SPECIES, KEY.NUM_SPECIES, KEY.TYPE_MAP,
              KEY.CHEMICAL_SPECIES_BY_ATOMIC_NUMBER):
        if k in cp_config:
            config[k] = cp_config[k]

    # architecture keys must match (reference check_config_compatible)
    must_match = [
        KEY.NODE_FEATURE_MULTIPLICITY, KEY.LMAX, KEY.IS_PARITY,
        KEY.NUM_CONVOLUTION, KEY.IRREPS_MANUAL, KEY.SELF_CONNECTION_TYPE,
    ]
    for k in must_match:
        if k in config and k in cp_config and config[k] != cp_config[k]:
            raise ValueError(
                f'config mismatch with checkpoint for {k}: '
                f'{config[k]} != {cp_config[k]}'
            )

    start_epoch = 1
    if not continue_cfg.get(KEY.RESET_EPOCH, False) and cp.epoch:
        start_epoch = int(cp.epoch) + 1

    state = {
        'params': params,
        'start_epoch': start_epoch,
        'reset_optimizer': continue_cfg.get(KEY.RESET_OPTIMIZER, False),
        'reset_scheduler': continue_cfg.get(KEY.RESET_SCHEDULER, False),
    }
    return model, state
