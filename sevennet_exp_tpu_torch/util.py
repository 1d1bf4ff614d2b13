"""Species helpers of the model configurations.

Copies of ``sevennet_exp_tpu/util.py::chemical_species_preprocess`` and
``sevennet_exp_tpu/data/periodic.py::get_type_mapper_from_specie``
(reference sevenn/util.py:115-140, nn/node_embedding.py:56-70), kept here
so that the PyTorch port imports nothing of the JAX package.
"""

from __future__ import annotations

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
