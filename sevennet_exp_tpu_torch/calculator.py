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
launches its kernels, on the CPU its plain version; a layer the kernels
refuse runs the plain chain on either (``SevenNetModel.conv_routes``), and
``use_kernels=False`` (JAX ``use_pallas=False``) sends every layer there.

``D3Calculator`` is Grimme's D3 dispersion alone (``ops/d3.py``, plain
PyTorch) and ``SevenNetD3Calculator`` the sum of both, the counterpart of
the reference's LAMMPS ``pair_style hybrid/overlay e3gnn d3``.
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
from .ops.d3 import D3Dispersion
from .ops.fused_conv import CG_MODE_KEY, CG_MODES, USE_KERNELS_KEY

try:  # optional ASE integration
    from ase.calculators.calculator import Calculator as _ASECalculator
    from ase.calculators.calculator import all_changes as _ase_all_changes
    _HAS_ASE = True
except ImportError:  # ase is not installed
    _ASECalculator = object
    _ase_all_changes = None
    _HAS_ASE = False

_INT_KEYS = (KEY.ATOMIC_NUMBERS, KEY.BATCH, KEY.EDGE_IDX, KEY.NUM_ATOMS,
             KEY.MODAL_TYPE)


def _as_internal_atoms(atoms) -> Atoms:
    if isinstance(atoms, Atoms):
        return atoms
    return Atoms(
        atomic_numbers=np.asarray(atoms.get_atomic_numbers()),
        pos=np.asarray(atoms.get_positions()),
        cell=np.asarray(atoms.get_cell()),
        pbc=np.asarray(atoms.get_pbc()),
    )


class _SinglePoint(_ASECalculator):
    """The ASE calculator protocol over ``calculate_single(atoms)``."""

    def _init_results(self, **kwargs):
        if _HAS_ASE:
            _ASECalculator.__init__(self, **kwargs)
        else:
            self.results = {}

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


class SevenNetCalculator(_SinglePoint):
    """Potential-energy calculator on one device.

    results: energy (eV), energies (N, eV), forces (N, 3, eV/A),
    stress (6, eV/A^3, ASE Voigt order xx yy zz yz xz xy, sign flipped
    like the reference sevennet_calculator.py:187-202).
    """

    implemented_properties = [
        'energy', 'free_energy', 'energies', 'forces', 'stress'
    ]

    def __init__(self, model: Union[str, SevenNetModel], device='cuda',
                 modal: Optional[str] = None, cg_mode: str = 'cmshared',
                 use_kernels: bool = True, **kwargs):
        """model: a native checkpoint path or a built ``SevenNetModel``.
        cg_mode: which kernels the fused convolutions launch on the card,
        'cmshared' (default) or the independently derived 'terms'.
        use_kernels: False runs every convolution as the plain chain.
        modal: the modality a multi-modal model answers for (a key of its
        ``modal_map``; JAX ``modal=``)."""
        self._init_results(**kwargs)
        self.device = torch.device(device)
        if cg_mode not in CG_MODES:
            raise ValueError(f'cg_mode {cg_mode!r}: one of {CG_MODES}')
        self.cg_mode = cg_mode
        self.use_kernels = bool(use_kernels)
        if isinstance(model, str):
            cp = SevenNetCheckpoint(model)
            self.model, _ = cp.build_model(device=self.device)
            self.sevennet_config = cp.config
        else:
            self.model = model.to(self.device)
            self.sevennet_config = model.config
        modals = sorted(self.model.modal_map)
        if (modal is None) != (not modals) or (modal and modal not in modals):
            raise ValueError(f'modal={modal!r}: the model has modalities '
                             f'{modals} (give one of them, or None for a '
                             'single-modal model)')
        self.modal_idx = self.model.modal_map[modal] if modal else None
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
        if self.modal_idx is not None:
            g[KEY.MODAL_TYPE] = self.modal_idx
        b = collate_graphs([g], n_node=n_cap, n_edge=e_cap, dtype=self.dtype)
        batch = {k: torch.as_tensor(
                     v, dtype=torch.long if k in _INT_KEYS else None,
                     device=self.device)
                 for k, v in b.items()}
        batch[CG_MODE_KEY] = self.cg_mode
        batch[USE_KERNELS_KEY] = self.use_kernels
        return batch

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


def _ase_stress(sig: np.ndarray) -> np.ndarray:
    """A 3 x 3 dE/d(strain) / V as the ASE Voigt order xx yy zz yz xz xy."""
    return np.array([sig[0, 0], sig[1, 1], sig[2, 2],
                     sig[1, 2], sig[0, 2], sig[0, 1]])


class D3Calculator(_SinglePoint):
    """Grimme D3 dispersion alone (JAX ``D3Calculator``; the reference's
    ``pair_style d3 rthr cn_thr damping functional``, pair_d3.cu:262-301):
    energy, forces and stress from ``ops/d3.D3Dispersion`` on ``device``.
    ``rthr`` and ``cn_thr`` are squared cutoffs in bohr^2."""

    implemented_properties = ['energy', 'free_energy', 'forces', 'stress']

    def __init__(self, damping: str = 'damp_bj', functional: str = 'pbe',
                 rthr: float = 9000.0, cn_thr: float = 1600.0,
                 device='cuda', **kwargs):
        self._init_results(**kwargs)
        self.device = torch.device(device)
        self.d3 = D3Dispersion(damping, functional, rthr, cn_thr,
                               device=self.device)

    def calculate_single(self, atoms) -> Dict[str, np.ndarray]:
        at = _as_internal_atoms(atoms)
        out = self.d3.compute(at.atomic_numbers, at.pos, at.cell, at.pbc)
        return {'energy': out['energy'], 'forces': out['forces'],
                'stress': _ase_stress(out['stress'])}


class SevenNetD3Calculator(SevenNetCalculator):
    """The SevenNet potential plus Grimme D3, summed (JAX
    ``SevenNetD3Calculator``; the reference's ``pair_style hybrid/overlay
    e3gnn d3``): the model's arguments, then D3's ``damping``,
    ``functional``, ``rthr`` and ``cn_thr``. D3 runs on the model's
    device; its energy is spread evenly over the atoms' energies."""

    def __init__(self, *args, damping: str = 'damp_bj',
                 functional: str = 'pbe', rthr: float = 9000.0,
                 cn_thr: float = 1600.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.d3 = D3Dispersion(damping, functional, rthr, cn_thr,
                               device=self.device)

    def calculate_single(self, atoms) -> Dict[str, np.ndarray]:
        res = SevenNetCalculator.calculate_single(self, atoms)
        at = _as_internal_atoms(atoms)
        d3 = self.d3.compute(at.atomic_numbers, at.pos, at.cell, at.pbc)
        res['energy'] = res['energy'] + d3['energy']
        res['energies'] = res['energies'] + d3['energy'] / len(at)
        res['forces'] = res['forces'] + d3['forces']
        res['stress'] = res['stress'] + _ase_stress(d3['stress'])
        return res
