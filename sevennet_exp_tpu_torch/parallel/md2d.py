"""Domain-decomposed MD on a 2-D (Pa x Pb) pencil mesh.

Counterpart of ``sevennet_exp_tpu/parallel/md2d.py``: a front over the
brick engine (``mdbrick.py``) with a (Pa, Pb) mesh: two staged halo
phases (corner ghosts ride phase b, LAMMPS comm_brick's staged swaps), the
dense-grid path per pencil, the global Nose-Hoover thermostat, the summed
virial. Pencils lift the slab ring's ``width / n >= cutoff`` ceiling.
"""

from __future__ import annotations

from typing import Tuple

from ..data.graph import Atoms
from .mdbrick import BrickMolecularDynamics


class ParallelMolecularDynamics2D(BrickMolecularDynamics):
    """NVE / NVT MD over a (Pa x Pb) pencil mesh along ``axes``."""

    def __init__(self, model, atoms: Atoms, mesh_shape: Tuple[int, int],
                 axes: Tuple[int, int] = (0, 1), **kwargs):
        """kwargs: ``BrickMolecularDynamics``'s."""
        if len(mesh_shape) != 2:
            raise ValueError(f'mesh {tuple(mesh_shape)}: two axes')
        super().__init__(model, atoms, mesh_shape=tuple(mesh_shape),
                         axes=tuple(axes), **kwargs)
