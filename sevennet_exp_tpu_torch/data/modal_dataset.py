"""Multi-modal dataset (reference sevenn/train/modal_dataset.py).

Copy of ``sevennet_exp_tpu/data/modal_dataset.py`` on the port's graph
dataset.

Concatenates per-modality datasets, tags each graph with its modality
index, pools statistics across modalities (Welford-style combination,
modal_dataset.py:29-93), and resolves modal-wise shift/scale keywords in
from_config (:252-365).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from .. import _keys as KEY
from ..util import chemical_species_preprocess
from .dataset import SevenNetGraphDataset


def _pooled_mean_std(stats_list: List[Dict]) -> Dict[str, float]:
    """Combine per-modality (mean, std, count) into pooled values."""
    total = sum(s['count'] for s in stats_list)
    mean = sum(s['mean'] * s['count'] for s in stats_list) / total
    var = 0.0
    for s in stats_list:
        var += s['count'] * (s['std'] ** 2 + (s['mean'] - mean) ** 2)
    return {'mean': mean, 'std': math.sqrt(var / total), 'count': total}


class SevenNetMultiModalDataset:
    """dict of modality name -> SevenNetGraphDataset."""

    def __init__(self, datasets: Dict[str, SevenNetGraphDataset]):
        self.datasets = dict(datasets)
        self.modal_map = {m: i for i, m in enumerate(sorted(datasets))}
        self.graphs: List[Dict] = []
        for modal, ds in self.datasets.items():
            idx = self.modal_map[modal]
            for g in ds.graphs:
                g = dict(g)
                g[KEY.DATA_MODALITY] = modal
                g[KEY.MODAL_TYPE] = idx
                self.graphs.append(g)

    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]

    # -- pooled statistics --------------------------------------------
    @property
    def species(self):
        out = set()
        for ds in self.datasets.values():
            out.update(ds.species)
        return sorted(out)

    @property
    def per_atom_energy_mean(self):
        return _pooled_mean_std([
            ds.statistics[KEY.PER_ATOM_ENERGY]
            for ds in self.datasets.values()
        ])['mean']

    @property
    def per_atom_energy_std(self):
        return _pooled_mean_std([
            ds.statistics[KEY.PER_ATOM_ENERGY]
            for ds in self.datasets.values()
        ])['std']

    @property
    def force_rms(self):
        pooled = _pooled_mean_std([
            ds.statistics[KEY.FORCE] for ds in self.datasets.values()
        ])
        return float(
            (pooled['mean'] ** 2 + pooled['std'] ** 2) ** 0.5
        )

    @property
    def avg_num_neigh(self):
        stats = [ds.statistics['num_neighbor']
                 for ds in self.datasets.values()]
        return _pooled_mean_std(stats)['mean']

    @property
    def sqrt_avg_num_neigh(self):
        return float(self.avg_num_neigh ** 0.5)

    @property
    def elemwise_reference_energies(self):
        # pooled ridge over concatenated compositions/energies
        comps, es = [], []
        for ds in self.datasets.values():
            comps.append(ds.statistics['_composition'])
            es.extend(
                float(g[KEY.ENERGY]) for g in ds.graphs
                if KEY.ENERGY in g and not np.isnan(g[KEY.ENERGY])
            )
        from .dataset import _elemwise_reference_energies
        return _elemwise_reference_energies(
            np.concatenate(comps), np.array(es)
        )

    # per-modality views for modal-wise shift/scale resolution
    def modal_statistic(self, keyword: str) -> Dict[str, Any]:
        return {
            modal: getattr(ds, keyword)
            for modal, ds in self.datasets.items()
        }


def multimodal_dataset_from_config(
    config: Dict[str, Any], working_dir: str = '.'
) -> Dict[str, Any]:
    """Reference modal_dataset from_config (:252-365): trainset given as
    {modal_name: [paths]} dicts; resolves modal_map + modal-wise
    shift/scale/conv_denominator."""
    raw = config[KEY.LOAD_TRAINSET]
    assert isinstance(raw, dict), 'multimodal trainset must be a dict'
    per_modal = {}
    for modal, paths in raw.items():
        if isinstance(paths, str):
            paths = [paths]
        per_modal[modal] = SevenNetGraphDataset(
            cutoff=config[KEY.CUTOFF], root=working_dir, files=paths,
            processed_name=f'trainset_{modal}',
        )
    mm = SevenNetMultiModalDataset(per_modal)
    config[KEY.MODAL_MAP] = mm.modal_map
    config[KEY.NUM_MODALITIES] = len(mm.modal_map)
    config[KEY.USE_MODALITY] = True

    if config.get(KEY.CHEMICAL_SPECIES, 'auto') == 'auto':
        config.update(chemical_species_preprocess(mm.species))

    for k, use_mw_key in (
        (KEY.SHIFT, KEY.USE_MODAL_WISE_SHIFT),
        (KEY.SCALE, KEY.USE_MODAL_WISE_SCALE),
    ):
        v = config.get(k)
        if isinstance(v, str):
            if config.get(use_mw_key, False):
                config[k] = mm.modal_statistic(v)
            else:
                config[k] = getattr(mm, v)
    v = config.get(KEY.CONV_DENOMINATOR)
    if isinstance(v, str):
        config[KEY.CONV_DENOMINATOR] = getattr(mm, v)
    return {'trainset': mm}
