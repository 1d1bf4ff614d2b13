"""input.yaml -> validated config (reference sevenn/parse_input.py).

Copy of ``sevennet_exp_tpu/parse_input.py`` for the port. The train
section also takes ``device`` (the port's trainer: 'cuda', the default,
or 'cpu').

Same three sections (model:/train:/data:), same key names (_keys.py), so
existing SevenNet input files work unchanged. Unknown keys warn instead of
erroring (parse_input.py:114-121).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict

from . import _const
from . import _keys as KEY
from .util import chemical_species_preprocess


def _validate(key: str, user: Any, condition: Any):
    """Apply one condition (reference parse_input.py:14-52 semantics):
    a type means isinstance-or-cast (bool never casts -- YAML already
    typed it), a callable must return truthy. Raises ValueError with
    the offending key/value so malformed input fails at parse time, not
    deep inside the model build."""
    if isinstance(condition, type):
        if isinstance(user, condition):
            return user
        if condition is bool or isinstance(user, (dict, list)):
            raise ValueError(
                f"expected {condition.__name__} for '{key}', "
                f'got {user!r}'
            )
        try:
            return condition(user)
        except (TypeError, ValueError):
            raise ValueError(
                f"expected {condition.__name__} for '{key}', "
                f'got {user!r}'
            ) from None
    if callable(condition):
        if condition(user):
            return user
        raise ValueError(f"invalid value {user!r} for '{key}'")
    return user


def config_initialize(key: str, config: Dict, default: Any,
                      conditions: Dict = None):
    conditions = conditions or {}
    if key not in config:
        config[key] = default
        return config
    user = config[key]
    condition = conditions.get(key)
    if isinstance(default, dict) and isinstance(user, dict):
        merged = dict(default)
        merged.update(user)
        if isinstance(condition, dict):
            for sub_k, sub_v in list(merged.items()):
                if sub_k in condition:
                    merged[sub_k] = _validate(
                        f'{key}.{sub_k}', sub_v, condition[sub_k]
                    )
        config[key] = merged
    elif condition is not None:
        config[key] = _validate(key, user, condition)
    return config


def _warn_unknown(section: str, config: Dict, known) -> None:
    unknown = [k for k in config if k not in known]
    if unknown:
        warnings.warn(
            f'unexpected {section} keys: {unknown} will be ignored',
            UserWarning,
        )


def init_model_config(config: Dict[str, Any]) -> Dict[str, Any]:
    defaults = _const.model_defaults(config)
    model_config: Dict[str, Any] = {}

    chem = config.get(KEY.CHEMICAL_SPECIES, 'auto')
    if isinstance(chem, str) and chem.lower() == 'auto':
        model_config[KEY.CHEMICAL_SPECIES] = 'auto'
        model_config[KEY.NUM_SPECIES] = 'auto'
        model_config[KEY.TYPE_MAP] = 'auto'
    elif isinstance(chem, str) and chem.lower() in ('univ', 'universal'):
        model_config.update(chemical_species_preprocess([], universal=True))
    else:
        if isinstance(chem, str):
            chem = chem.replace('-', ',').replace(' ', ',').split(',')
            chem = [c for c in chem if c]
        model_config.update(chemical_species_preprocess(chem))

    for k, v in config.items():
        if k == KEY.CHEMICAL_SPECIES:
            continue
        model_config[k] = v
    cond = _const.MODEL_CONFIG_CONDITION
    for k, default in defaults.items():
        config_initialize(k, model_config, default, cond)
    for k in set(model_config) - set(defaults):
        if k in cond:
            model_config[k] = _validate(k, model_config[k], cond[k])
    _warn_unknown(
        'model', config,
        set(defaults) | set(cond) | {
            KEY.CHEMICAL_SPECIES, KEY.IRREPS_MANUAL, KEY.MULTI_CUTOFF,
            KEY.NUM_SPECIES, KEY.TYPE_MAP,
        },
    )
    return model_config


def init_train_config(config: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(config)
    cond = _const.TRAIN_CONFIG_CONDITION
    defaults = _const.train_defaults(config)
    for k, default in defaults.items():
        config_initialize(k, out, default, cond)
    for k in set(out) - set(defaults):
        if k in cond:
            out[k] = _validate(k, out[k], cond[k])
    _warn_unknown('train', config, set(defaults) | set(cond) | {'device'})
    return out


def init_data_config(config: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(config)
    cond = _const.DATA_CONFIG_CONDITION
    defaults = _const.data_defaults(config)
    for k, default in defaults.items():
        config_initialize(k, out, default, cond)
    for k in set(out) - set(defaults):
        if k in cond:
            out[k] = _validate(k, out[k], cond[k])
    _warn_unknown(
        'data', config,
        set(defaults) | set(cond) | {
            KEY.LOAD_TRAINSET, KEY.LOAD_VALIDSET, KEY.LOAD_DATASET,
            KEY.SAVE_DATASET,
        },
    )
    return out


def read_config_yaml(
    filename: str, return_separately: bool = False
):
    import yaml
    with open(filename) as f:
        raw = yaml.safe_load(f)

    model_cfg, train_cfg, data_cfg = {}, {}, {}
    for key, section in raw.items():
        if key.lower() == 'model':
            model_cfg = init_model_config(section)
        elif key.lower() == 'train':
            train_cfg = init_train_config(section)
        elif key.lower() == 'data':
            data_cfg = init_data_config(section)
        else:
            warnings.warn(f'unknown main section: {key}')

    if return_separately:
        return model_cfg, train_cfg, data_cfg
    merged = {}
    merged.update(model_cfg)
    merged.update(train_cfg)
    merged.update(data_cfg)
    return merged
