"""Species helpers of the model configurations and the pretrained keywords.

Copies of ``sevennet_exp_tpu/util.py`` (its species helpers, file names
and pretrained-keyword resolution; reference sevenn/util.py:115-207) and of
``sevennet_exp_tpu/data/periodic.py::get_type_mapper_from_specie``
(reference nn/node_embedding.py:56-70), kept here so that the PyTorch port
imports nothing of the JAX package. The JAX package's
``enable_compile_cache`` is XLA's compile cache and has no counterpart.
"""

from __future__ import annotations

import os
from typing import Dict, List

from . import _keys as KEY
from .data.periodic import atomic_numbers, chemical_symbols


def get_type_mapper_from_specie(specie_list) -> Dict[int, int]:
    """['Hf','O'] -> {72: 0, 8: 1} (reference nn/node_embedding.py:56-70)."""
    specie_list = sorted(specie_list)
    type_map: Dict[int, int] = {}
    counter = 0
    for specie in specie_list:
        z = atomic_numbers[specie]
        if z in type_map:
            continue
        type_map[z] = counter
        counter += 1
    return type_map


def chemical_species_preprocess(input_chem: List[str],
                                universal: bool = False) -> Dict:
    """Reference sevenn/util.py:115-140."""
    config: Dict = {}
    if not universal:
        input_chem = list(set(input_chem))
        chemical_specie = sorted([x.strip() for x in input_chem])
        config[KEY.CHEMICAL_SPECIES] = chemical_specie
        config[KEY.CHEMICAL_SPECIES_BY_ATOMIC_NUMBER] = [
            atomic_numbers[x] for x in chemical_specie
        ]
        config[KEY.NUM_SPECIES] = len(chemical_specie)
        config[KEY.TYPE_MAP] = get_type_mapper_from_specie(chemical_specie)
    else:
        config[KEY.CHEMICAL_SPECIES] = list(chemical_symbols)
        n = len(chemical_symbols)
        config[KEY.CHEMICAL_SPECIES_BY_ATOMIC_NUMBER] = list(range(n))
        config[KEY.NUM_SPECIES] = n
        config[KEY.TYPE_MAP] = {z: z for z in range(n)}
    return config


def onehot_to_chem(one_hot_indices: List[int],
                   type_map: Dict[int, int]) -> List[str]:
    rev = {v: k for k, v in type_map.items()}
    return [chemical_symbols[rev[i]] for i in one_hot_indices]


def unique_filepath(filepath: str) -> str:
    if not os.path.isfile(filepath):
        return filepath
    dirname = os.path.dirname(filepath)
    name, ext = os.path.splitext(os.path.basename(filepath))
    cnt = 0
    while True:
        new_path = os.path.join(dirname, f'{name}{cnt}{ext}')
        if not os.path.exists(new_path):
            return new_path
        cnt += 1


# -- pretrained-name resolution ---------------------------------------------

# canonical name -> relative checkpoint paths, looked up under each root (see
# pretrained_name_to_path); the keyword surface of the reference
# (sevenn/util.py:188-207, sevenn/_const.py:50-59). The repo ships no
# upstream weights, so the known names resolve against user-provided
# checkpoint directories; the demo potential is committed.
_PRETRAINED_ALIASES = {
    '7net-0': 'sevennet-0_11jul2024',
    'sevennet-0': 'sevennet-0_11jul2024',
    '7net-0_11jul2024': 'sevennet-0_11jul2024',
    '7net-0_11july2024': 'sevennet-0_11jul2024',
    'sevennet-0_11july2024': 'sevennet-0_11jul2024',
    '7net-0_22may2024': 'sevennet-0_22may2024',
    'sevennet-0_22may2024': 'sevennet-0_22may2024',
    '7net-l3i5': 'sevennet-l3i5',
    'sevennet-l3i5': 'sevennet-l3i5',
    # in-repo demo flagship (trained on the analytic NaCl ground truth)
    '7net-0-nacl-demo': 'nacl-demo',
    'sevennet-0-nacl-demo': 'nacl-demo',
}

_PRETRAINED_FILES = {
    'sevennet-0_11jul2024': (
        'SevenNet_0__11Jul2024/checkpoint_sevennet_0.pth',
        'sevennet-0_11jul2024.pth',
    ),
    'sevennet-0_22may2024': (
        'SevenNet_0__22May2024/checkpoint_sevennet_0.pth',
        'sevennet-0_22may2024.pth',
    ),
    'sevennet-l3i5': (
        'SevenNet_l3i5/checkpoint_l3i5.pth',
        'sevennet-l3i5.pth',
    ),
    'nacl-demo': (
        'trained_nacl/checkpoint_best.pth.sevennet',
    ),
}


def pretrained_name_to_path(name: str) -> str:
    """Resolve a pretrained-potential keyword ('7net-0', '7net-l3i5',
    '7net-0-nacl-demo', ...) to a checkpoint path.

    Search roots, in order: each entry of $SEVENNET_CHECKPOINT_DIR
    (colon-separated), ~/.cache/sevennet_exp_tpu, and the repo root (which
    carries the committed demo potential): the JAX package's roots, so both
    packages find the same files. Raises ValueError with the known names
    when the keyword is unknown, and FileNotFoundError with the searched
    paths when no file exists.
    """
    canonical = _PRETRAINED_ALIASES.get(name.lower())
    if canonical is None:
        known = sorted(set(_PRETRAINED_ALIASES))
        raise ValueError(
            f'unknown pretrained potential {name!r}; known keywords: '
            f'{", ".join(known)}'
        )
    roots = [
        r for r in os.environ.get('SEVENNET_CHECKPOINT_DIR', '').split(':')
        if r
    ]
    roots.append(os.path.join(os.path.expanduser('~'), '.cache',
                              'sevennet_exp_tpu'))
    roots.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tried = []
    for root in roots:
        for rel in _PRETRAINED_FILES[canonical]:
            path = os.path.join(root, rel)
            if os.path.isfile(path):
                return path
            tried.append(path)
    raise FileNotFoundError(
        f'pretrained potential {name!r} ({canonical}) not found; '
        f'place the checkpoint under $SEVENNET_CHECKPOINT_DIR. '
        f'Searched: {tried}'
    )


def resolve_checkpoint(path_or_name: str) -> str:
    """Existing path -> as-is; otherwise try the pretrained keywords."""
    if os.path.exists(path_or_name):
        return path_or_name
    if path_or_name.lower() in _PRETRAINED_ALIASES:
        return pretrained_name_to_path(path_or_name)
    return path_or_name
