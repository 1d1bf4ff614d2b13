"""Memory-lean dataset: stores Atoms, builds each graph on access.

Copy of ``sevennet_exp_tpu/data/atoms_dataset.py`` on the port's data
path: the same statistics, and ``avg_num_neigh`` on the same sample
(``default_rng(0)``), so both packages resolve the same numbers.

Capability parity with the reference's SevenNetAtomsDataset
(sevenn/train/atoms_dataset.py:27-314): the trade of the graph dataset's
preprocessing cost/RAM for per-__getitem__ neighbor-list builds, with
statistics computed from the raw structures and avg_num_neigh
approximated on <= 10k random samples (atoms_dataset.py:157-170).

Exposes the same statistics property names as SevenNetGraphDataset so
`datasets_from_config` can resolve shift/scale/conv_denominator
keywords against either (`dataset_type: atoms` in the data config,
reference _const.py:195,216 and scripts/train.py:67-72).
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import _keys as KEY
from .._const import NUM_UNIV_ELEMENT
from .graph import Atoms, atoms_to_graph
from .periodic import chemical_symbols


class SevenNetAtomsDataset:
    """Lazy graphs over a list of Atoms; statistics from structures."""

    def __init__(
        self,
        cutoff: float,
        files: Optional[List[str]] = None,
        atoms_list: Optional[List[Atoms]] = None,
        **kwargs,
    ):
        self.cutoff = cutoff
        if atoms_list is None:
            from .dataset import expand_dataset_paths, read_structure_file
            assert files, 'no input files'
            atoms_list = []
            for path in expand_dataset_paths(list(files)):
                atoms_list.extend(read_structure_file(path))
        self.atoms_list = list(atoms_list)
        self._stats: Optional[Dict[str, Any]] = None
        self._avg_num_neigh: Optional[Tuple[int, float]] = None

    # -- container: __getitem__ builds the graph (atoms_dataset.py:97-112)
    def __len__(self):
        return len(self.atoms_list)

    def __getitem__(self, i) -> Dict:
        return atoms_to_graph(self.atoms_list[i], self.cutoff,
                              allow_unlabeled=True)

    def subset(self, indices) -> 'SevenNetAtomsDataset':
        return SevenNetAtomsDataset(
            self.cutoff, atoms_list=[self.atoms_list[i] for i in indices])

    # -- statistics from atoms, no graphs (atoms_dataset.py:115-170) ---
    def _run_stat(self) -> Dict[str, Any]:
        if self._stats is not None:
            return self._stats
        energies, forces, natoms = [], [], []
        composition = np.zeros((len(self), NUM_UNIV_ELEMENT))
        for i, at in enumerate(self.atoms_list):
            n = len(at)
            natoms.append(n)
            if at.energy is not None and np.isfinite(at.energy):
                energies.append(at.energy / n)
            if at.forces is not None:
                forces.append(np.asarray(at.forces).reshape(-1))
            composition[i] = np.bincount(
                at.atomic_numbers, minlength=NUM_UNIV_ELEMENT)
        f = (np.concatenate(forces)
             if forces else np.zeros((0,), np.float64))
        e = np.asarray(energies, np.float64)
        self._stats = {
            'per_atom_energy_mean': float(e.mean()) if len(e) else 0.0,
            'per_atom_energy_std': float(e.std()) if len(e) else 1.0,
            'force_rms': float(np.sqrt((f ** 2).mean())) if len(f) else 1.0,
            '_composition': composition,
            '_energies_total': np.array(
                [at.energy if at.energy is not None else np.nan
                 for at in self.atoms_list]),
            'natoms': {
                chemical_symbols[z]: int(c)
                for z, c in enumerate(composition.sum(0).astype(np.int64))
                if c > 0 and z > 0
            },
        }
        return self._stats

    @property
    def statistics(self) -> Dict[str, Any]:
        return self._run_stat()

    @property
    def species(self) -> List[str]:
        comp = self._run_stat()['_composition'].sum(0)
        return [chemical_symbols[z] for z in np.nonzero(comp)[0] if z > 0]

    @property
    def natoms(self) -> Dict[str, int]:
        return self._run_stat()['natoms']

    @property
    def per_atom_energy_mean(self) -> float:
        return self._run_stat()['per_atom_energy_mean']

    @property
    def per_atom_energy_std(self) -> float:
        return self._run_stat()['per_atom_energy_std']

    @property
    def force_rms(self) -> float:
        return self._run_stat()['force_rms']

    @property
    def elemwise_reference_energies(self) -> np.ndarray:
        from .dataset import _elemwise_reference_energies
        st = self._run_stat()
        ok = np.isfinite(st['_energies_total'])
        return _elemwise_reference_energies(
            st['_composition'][ok], st['_energies_total'][ok])

    @property
    def avg_num_neigh(self) -> float:
        """Approximated on <= 10k random graphs (atoms_dataset.py:157-170).
        Property (not method) so datasets_from_config's statistic-keyword
        resolution works uniformly across dataset types."""
        return self._avg_num_neigh_fn()

    def _avg_num_neigh_fn(self, n_sample: int = 10000) -> float:
        # cached per effective sample size so a coarse early estimate
        # (loader capacity sizing at 64 samples) never poisons the
        # statistic that datasets_from_config bakes into
        # conv_denominator
        eff = min(len(self), n_sample)
        if self._avg_num_neigh is None or self._avg_num_neigh[0] < eff:
            if len(self) > n_sample:
                warnings.warn(
                    'avg_num_neigh approximated on a random subset')
            rng = np.random.default_rng(0)
            idx = rng.permutation(len(self))[:eff]
            counts = []
            for i in idx:
                g = self[int(i)]
                _, nn = np.unique(
                    np.asarray(g[KEY.EDGE_IDX][0]), return_counts=True)
                counts.append(nn)
            all_counts = (np.concatenate(counts)
                          if counts else np.ones((1,)))
            self._avg_num_neigh = (eff, float(all_counts.mean()))
        return self._avg_num_neigh[1]

    @property
    def sqrt_avg_num_neigh(self) -> float:
        return float(np.sqrt(self._avg_num_neigh_fn()))

    # -- loader integration: lazy size estimates ----------------------
    def estimated_sizes(self, margin: float = 1.3):
        """(natoms, est_edges) per item without building every graph;
        edge counts from avg_num_neigh x natoms with a safety margin
        (the static-shape analog of the reference's on-the-fly
        AtomsToGraphCollater, train/collate.py:11-42)."""
        ann = self._avg_num_neigh_fn(n_sample=min(len(self), 64))
        return [
            (len(at), int(np.ceil(len(at) * ann * margin)) + 8)
            for at in self.atoms_list
        ]
