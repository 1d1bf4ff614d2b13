"""SevenNetCalculator: single-point energy, forces and stress.

Counterpart of ``sevennet_exp_tpu/calculator.py::SevenNetCalculator``
(reference sevenn/sevennet_calculator.py:22-231). It works on the port's
``Atoms`` container or on any object with ``get_atomic_numbers``,
``get_positions``, ``get_cell`` and ``get_pbc``, and is a genuine ASE
``Calculator`` subclass when ase can be imported (an optional dependency).

Per call: a host neighbor list (``data/neighborlist.py``), a batch padded
to bucketed capacities (they only grow, so repeated calls on similar
systems reuse their shapes), then ``SevenNetModel.apply`` on the device:
the plain edge-list convolution -- the fused conv with one output row per
edge, then a scatter-add -- and the gradient with respect to the edge
vectors for forces and the virial stress. On a CUDA device the fused conv
launches its kernels, on the CPU its plain version; the device decides,
there is no switch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from . import _keys as KEY
from .checkpoint import SevenNetCheckpoint
from .data.graph import (
    Atoms,
    collate_graphs,
    pad_cap,
    unlabeled_atoms_to_graph,
)
from .model.model import SevenNetModel

try:  # optional ASE integration
    from ase.calculators.calculator import Calculator as _ASECalculator
    from ase.calculators.calculator import all_changes as _ase_all_changes
    _HAS_ASE = True
except ImportError:  # ase is not installed
    _ASECalculator = object
    _ase_all_changes = None
    _HAS_ASE = False

_INT_KEYS = (KEY.ATOMIC_NUMBERS, KEY.BATCH, KEY.EDGE_IDX, KEY.NUM_ATOMS)


def _as_internal_atoms(atoms) -> Atoms:
    if isinstance(atoms, Atoms):
        return atoms
    return Atoms(
        atomic_numbers=np.asarray(atoms.get_atomic_numbers()),
        pos=np.asarray(atoms.get_positions()),
        cell=np.asarray(atoms.get_cell()),
        pbc=np.asarray(atoms.get_pbc()),
    )


class SevenNetCalculator(_ASECalculator):
    """Potential-energy calculator on one device.

    results: energy (eV), energies (N, eV), forces (N, 3, eV/A),
    stress (6, eV/A^3, ASE Voigt order xx yy zz yz xz xy, sign flipped
    like the reference sevennet_calculator.py:187-202).
    """

    implemented_properties = [
        'energy', 'free_energy', 'energies', 'forces', 'stress'
    ]

    def __init__(self, model: Union[str, SevenNetModel], device='cuda',
                 modal: Optional[str] = None, **kwargs):
        """model: a native checkpoint path or a built ``SevenNetModel``."""
        if _HAS_ASE:
            _ASECalculator.__init__(self, **kwargs)
        else:
            self.results = {}
        self.device = torch.device(device)
        if isinstance(model, str):
            cp = SevenNetCheckpoint(model)
            self.model, _ = cp.build_model(device=self.device)
            self.sevennet_config = cp.config
        else:
            self.model = model.to(self.device)
            self.sevennet_config = model.config
        if modal is not None:
            raise NotImplementedError('modalities are not in the port yet')
        self.cutoff = self.model.cutoff
        self.type_map = self.model.type_map
        self.dtype = np.float32
        self._caps = (8, 32)

    # -- core ----------------------------------------------------------
    def _batch(self, atoms) -> Dict[str, Any]:
        """Padded single-graph batch on the device, capacities bucketed."""
        at = _as_internal_atoms(atoms)
        g = unlabeled_atoms_to_graph(at, self.cutoff)
        n, e = len(at), g[KEY.EDGE_IDX].shape[1]
        n_cap = max(self._caps[0], pad_cap(n))
        e_cap = max(self._caps[1], pad_cap(e, multiple=256, margin=1.2))
        self._caps = (n_cap, e_cap)
        b = collate_graphs([g], n_node=n_cap, n_edge=e_cap, dtype=self.dtype)
        return {k: torch.as_tensor(
                    v, dtype=torch.long if k in _INT_KEYS else None,
                    device=self.device)
                for k, v in b.items()}

    def calculate_single(self, atoms) -> Dict[str, np.ndarray]:
        n = len(_as_internal_atoms(atoms))
        out = self.model.apply(self._batch(atoms))
        energies = out[KEY.ATOMIC_ENERGY][:n, 0].cpu().numpy()
        stress_raw = out[KEY.PRED_STRESS][0].cpu().numpy()
        # model Voigt (xx,yy,zz,xy,yz,zx) -> ASE (xx,yy,zz,yz,xz,xy), -1
        stress = -stress_raw[[0, 1, 2, 4, 5, 3]]
        return {
            'energy': float(out[KEY.PRED_TOTAL_ENERGY][0]),
            'energies': energies,
            'forces': out[KEY.PRED_FORCE][:n].cpu().numpy(),
            'stress': stress,
        }

    # -- ASE protocol --------------------------------------------------
    def calculate(self, atoms=None, properties=None, system_changes=None):
        if _HAS_ASE and atoms is None:
            atoms = self.atoms
        if _HAS_ASE:
            _ASECalculator.calculate(self, atoms, properties,
                                     system_changes or _ase_all_changes)
        res = self.calculate_single(atoms)
        res['free_energy'] = res['energy']
        self.results = res
        return res

    # accessors for callers without ase
    def _result(self, key, atoms):
        if not self.results or atoms is not None:
            self.calculate(atoms)
        return self.results[key]

    def get_potential_energy(self, atoms=None, **kw):
        return self._result('energy', atoms)

    def get_forces(self, atoms=None):
        return self._result('forces', atoms)

    def get_stress(self, atoms=None):
        return self._result('stress', atoms)
