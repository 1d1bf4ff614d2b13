"""Graph dataset with statistics (reference sevenn/train/graph_dataset.py).

Counterpart of ``sevennet_exp_tpu/data/dataset.py``. Processes structure
files -> graphs -> `{root}/sevenn_data/{name}.pkl` (+ .yaml meta sidecar;
the pickle holds numpy arrays and builtins under the JAX package's field
names, so either package reads the other's), computes the statistics the
model-build wiring needs (shift/scale/conv_denominator keywords), and
exposes them as properties with the reference's names
(graph_dataset.py:360-392).

Not in the port yet (ROADMAP A.5, the next slice of the training path):
VASP OUTCAR and ``structure_list`` inputs, ``dataset_type: atoms``; they
raise ``NotImplementedError``.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import _keys as KEY
from .._const import NUM_UNIV_ELEMENT
from ..util import chemical_species_preprocess
from .extxyz import read_extxyz
from .graph import Atoms, atoms_to_graph
from .periodic import chemical_symbols

_NEXT_SLICE = ('is not in the port yet: ROADMAP A.5 queues it for the '
               'next slice of the training path')


def run_statistics(graph_list: Sequence[Dict]) -> Dict[str, Any]:
    """Reference _run_stat (graph_dataset.py:61-112)."""
    n_neigh = []
    composition = np.zeros((len(graph_list), NUM_UNIV_ELEMENT))
    arrays: Dict[str, List[np.ndarray]] = {
        KEY.ENERGY: [], KEY.PER_ATOM_ENERGY: [], KEY.FORCE: [],
        KEY.STRESS: [],
    }
    natoms_counter: Dict[int, int] = {}
    for i, g in enumerate(graph_list):
        z = np.asarray(g[KEY.ATOMIC_NUMBERS])
        for zz in z:
            natoms_counter[int(zz)] = natoms_counter.get(int(zz), 0) + 1
        composition[i] = np.bincount(z, minlength=NUM_UNIV_ELEMENT)
        # neighbor counts of atoms that have neighbors (torch.unique analog)
        idx0 = np.asarray(g[KEY.EDGE_IDX][0])
        if idx0.size:
            _, counts = np.unique(idx0, return_counts=True)
            n_neigh.append(counts.astype(np.float64))
        for y in arrays:
            if y in g:
                arrays[y].append(np.asarray(g[y], dtype=np.float64).reshape(-1))

    stats: Dict[str, Any] = {}
    arrays['num_neighbor'] = n_neigh
    for y, arrs in arrays.items():
        if not arrs:
            continue
        a = np.concatenate(arrs)
        a = a[~np.isnan(a)]
        if a.size == 0:
            continue
        stats[y] = {
            'mean': float(np.mean(a)),
            'std': float(np.std(a)),  # correction=0 like the reference
            'median': float(np.median(a)),
            'max': float(np.max(a)),
            'min': float(np.min(a)),
            'count': int(a.size),
        }
    natoms = {
        chemical_symbols[z]: int(c) for z, c in sorted(natoms_counter.items())
    }
    natoms['total'] = int(sum(natoms_counter.values()))
    stats['natoms'] = natoms
    stats['_composition'] = composition

    energies = np.array(
        [float(g[KEY.ENERGY]) for g in graph_list
         if KEY.ENERGY in g and not np.isnan(g[KEY.ENERGY])]
    )
    if energies.size == len(graph_list):
        stats['elemwise_reference_energies'] = _elemwise_reference_energies(
            composition, energies
        )
    # per-species force rms
    stats['elemwise_force_rms'] = _elemwise_force_rms(graph_list)
    return stats


def _elemwise_reference_energies(composition, energies):
    """Ridge(alpha=0.1, no intercept), reference graph_dataset.py:115-127."""
    c = composition
    zero = np.all(c == 0, axis=0)
    cr = c[:, ~zero]
    alpha = 0.1
    A = cr.T @ cr + alpha * np.eye(cr.shape[1])
    coef = np.linalg.solve(A, cr.T @ energies)
    full = np.zeros(NUM_UNIV_ELEMENT)
    full[~zero] = coef
    return full.tolist()


def _elemwise_force_rms(graph_list):
    sq = np.zeros(NUM_UNIV_ELEMENT)
    cnt = np.zeros(NUM_UNIV_ELEMENT)
    for g in graph_list:
        if KEY.FORCE not in g:
            continue
        f = np.asarray(g[KEY.FORCE], dtype=np.float64)
        z = np.asarray(g[KEY.ATOMIC_NUMBERS])
        ok = ~np.isnan(f).any(axis=1)
        for zz in np.unique(z):
            m = (z == zz) & ok
            sq[zz] += float((f[m] ** 2).sum())
            cnt[zz] += int(m.sum()) * 3
    rms = np.ones(NUM_UNIV_ELEMENT)
    nonzero = cnt > 0
    rms[nonzero] = np.sqrt(sq[nonzero] / cnt[nonzero])
    return rms.tolist()


class SevenNetGraphDataset:
    """In-memory list of graphs + statistics; cached processed file."""

    def __init__(
        self,
        cutoff: float,
        root: str = '.',
        files: Optional[List[str]] = None,
        processed_name: str = 'graph',
        force_reload: bool = False,
        use_data_weight: bool = False,
        graphs: Optional[List[Dict]] = None,
        **kwargs,
    ):
        self.cutoff = cutoff
        self.root = root
        if not processed_name.endswith('.pkl'):
            processed_name += '.pkl'
        self.processed_dir = os.path.join(root, 'sevenn_data')
        self.processed_path = os.path.join(self.processed_dir, processed_name)
        self.meta_path = self.processed_path.replace('.pkl', '.yaml')

        if graphs is not None:
            self.graphs = list(graphs)
            self.statistics = run_statistics(self.graphs)
        elif os.path.exists(self.processed_path) and not force_reload:
            with open(self.processed_path, 'rb') as f:
                payload = pickle.load(f)
            assert abs(payload['cutoff'] - cutoff) < 1e-9, (
                'cached dataset has different cutoff'
            )
            self.graphs = payload['graphs']
            self.statistics = payload['statistics']
        else:
            assert files, 'no input files'
            self.graphs = []
            for path in expand_dataset_paths(list(files)):
                self.graphs.extend(self._file_to_graphs(path, cutoff))
            self.statistics = run_statistics(self.graphs)
            self._save()

    @staticmethod
    def _file_to_graphs(path: str, cutoff: float) -> List[Dict]:
        """reference file_to_graph_list (graph_dataset.py:511-540)."""
        if path.endswith('.pkl'):
            with open(path, 'rb') as f:
                return pickle.load(f)['graphs']
        return [atoms_to_graph(a, cutoff, allow_unlabeled=True)
                for a in read_structure_file(path)]

    def _save(self):
        os.makedirs(self.processed_dir, exist_ok=True)
        with open(self.processed_path, 'wb') as f:
            pickle.dump({
                'graphs': self.graphs,
                'statistics': self.statistics,
                'cutoff': self.cutoff,
                'version': '0.1.0+tpu',
            }, f)
        try:
            import yaml
            meta = {
                'cutoff': float(self.cutoff),
                'statistics': {
                    k: v for k, v in self.statistics.items()
                    if not k.startswith('_')
                },
                'version': '0.1.0+tpu',
            }
            with open(self.meta_path, 'w') as f:
                yaml.dump(meta, f, default_flow_style=False)
        except Exception:
            pass

    # -- container protocol -------------------------------------------
    def __len__(self):
        return len(self.graphs)

    def __getitem__(self, i):
        return self.graphs[i]

    # -- statistics properties (reference graph_dataset.py:360-392) ---
    @property
    def species(self):
        return [s for s in self.statistics['natoms'] if s != 'total']

    @property
    def natoms(self):
        return self.statistics['natoms']

    @property
    def per_atom_energy_mean(self):
        return self.statistics[KEY.PER_ATOM_ENERGY]['mean']

    @property
    def per_atom_energy_std(self):
        return self.statistics[KEY.PER_ATOM_ENERGY]['std']

    @property
    def elemwise_reference_energies(self):
        return self.statistics['elemwise_reference_energies']

    @property
    def elemwise_force_rms(self):
        return self.statistics['elemwise_force_rms']

    @property
    def force_rms(self):
        m = self.statistics[KEY.FORCE]['mean']
        s = self.statistics[KEY.FORCE]['std']
        return float((m ** 2 + s ** 2) ** 0.5)

    @property
    def avg_num_neigh(self):
        return self.statistics['num_neighbor']['mean']

    @property
    def sqrt_avg_num_neigh(self):
        return float(self.avg_num_neigh ** 0.5)


def braceexpand(expr: str) -> List[str]:
    """Bash-style brace expansion: ``{a,b}`` lists and ``{1..5}`` ranges
    (copy of ``sevennet_exp_tpu/data/vasp.py::braceexpand``)."""
    m = re.search(r'\{([^{}]*)\}', expr)
    if m is None:
        return [expr]
    head, tail = expr[:m.start()], expr[m.end():]
    body = m.group(1)
    rng = re.fullmatch(r'(-?\d+)\.\.(-?\d+)(?:\.\.(-?\d+))?', body)
    if rng:
        a, b = int(rng.group(1)), int(rng.group(2))
        step = int(rng.group(3) or (1 if b >= a else -1))
        if step == 0:
            raise ValueError(f'zero step in brace range: {expr}')
        stop = b + (1 if step > 0 else -1)
        width = None
        if rng.group(1).lstrip('-').startswith('0') or \
                rng.group(2).lstrip('-').startswith('0'):
            width = max(len(rng.group(1)), len(rng.group(2)))
        items = [str(v).zfill(width) if width else str(v)
                 for v in range(a, stop, step)]
    elif ',' in body:
        items = body.split(',')
    else:
        return [head + body + t for t in braceexpand(tail)]
    out = []
    for item in items:
        out.extend(braceexpand(head + item + tail))
    return out


def expand_dataset_paths(paths: List[str]) -> List[str]:
    """Brace + glob expansion of dataset path patterns (reference
    parse_input.py expands dataset globs; structure_list additionally
    brace-expands, dataload.py:431)."""
    import glob as _glob
    out: List[str] = []
    for pattern in paths:
        for expr in braceexpand(pattern):
            hits = sorted(_glob.glob(expr))
            if hits:
                out.extend(hits)
            else:
                out.append(expr)  # literal path; missing -> error later
    return out


def read_structure_file(path: str) -> List[Atoms]:
    """Format dispatch (reference graph_dataset.py:511-540): extxyz; VASP
    structure_list index files and raw OUTCARs raise."""
    base = os.path.basename(path)
    if base.startswith('structure_list') or base.endswith('.structure_list'):
        raise NotImplementedError(f'{path}: structure_list {_NEXT_SLICE}')
    if base.endswith(('.xyz', '.extxyz')):
        return read_extxyz(path)
    if 'OUTCAR' in base:
        raise NotImplementedError(f'{path}: the OUTCAR reader {_NEXT_SLICE}')
    return read_extxyz(path)


def datasets_from_config(
    config: Dict[str, Any],
    working_dir: str = '.',
) -> Dict[str, Any]:
    """Reference graph_dataset.from_config (graph_dataset.py:608-701):
    builds train/valid(/test) datasets, resolves 'auto' species and the
    shift/scale/conv_denominator statistics keywords, random-splits a
    validation set when none is given."""
    dataset_keys = [
        k for k in config if k.startswith('load_') and k.endswith('_path')
    ]
    assert KEY.LOAD_TRAINSET in dataset_keys, 'load_trainset_path required'

    dataset_type = config.get(KEY.DATASET_TYPE, 'graph')
    datasets = {}
    for dk in dataset_keys:
        paths = config[dk]
        if not paths:
            continue
        if isinstance(paths, str):
            paths = [paths]
        paths = expand_dataset_paths(paths)
        name = '_'.join(dk.split('_')[1:-1])
        if dataset_type == 'atoms':
            raise NotImplementedError(f'dataset_type: atoms {_NEXT_SLICE}')
        elif dataset_type == 'graph':
            datasets[name] = SevenNetGraphDataset(
                cutoff=config[KEY.CUTOFF], root=working_dir, files=paths,
                processed_name=name,
                **config.get(KEY.DATA_FORMAT_ARGS, {}),
            )
        else:
            raise ValueError(f'Unknown dataset type: {dataset_type}')

    train_set = datasets['trainset']

    chem = set(train_set.species)
    for ds in datasets.values():
        chem.update(ds.species)
    if config.get(KEY.CHEMICAL_SPECIES, 'auto') == 'auto':
        config.update(chemical_species_preprocess(sorted(chem)))

    for k in (KEY.SHIFT, KEY.SCALE, KEY.CONV_DENOMINATOR):
        v = config.get(k)
        if isinstance(v, str):
            if not hasattr(train_set, v):
                raise NotImplementedError(f'unknown statistic keyword {v}')
            config[k] = getattr(train_set, v)

    if ('validset' not in datasets and config.get(KEY.RATIO, 0.0) > 0.0
            and len(train_set) >= 2):
        ratio = float(config[KEY.RATIO])
        rng = np.random.default_rng(config.get(KEY.RANDOM_SEED, 1))
        idx = rng.permutation(len(train_set))
        n_valid = max(1, int(len(train_set) * ratio))
        datasets['trainset'] = SevenNetGraphDataset(
            cutoff=config[KEY.CUTOFF], root=working_dir,
            graphs=[train_set.graphs[i] for i in idx[n_valid:]],
        )
        datasets['validset'] = SevenNetGraphDataset(
            cutoff=config[KEY.CUTOFF], root=working_dir,
            graphs=[train_set.graphs[i] for i in idx[:n_valid]],
        )
    return datasets
