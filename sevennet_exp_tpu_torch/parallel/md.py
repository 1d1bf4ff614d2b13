"""Domain-decomposed MD over a ring of bricks (slab decomposition).

Counterpart of ``sevennet_exp_tpu/parallel/md.py``: a front over the
brick engine (``mdbrick.py``) with an (n,) mesh: one staged halo phase,
the dense-grid path per slab, the global Nose-Hoover thermostat, the
summed virial. Its own entry point because the slab ring is the common
case and the reference's parallel pair style is the 1-D-per-rank analog
(pair_e3gnn_parallel.cpp + comm_brick.cpp).
"""

from __future__ import annotations

from ..data.graph import Atoms
from .mdbrick import BrickMolecularDynamics


class ParallelMolecularDynamics(BrickMolecularDynamics):
    """NVE / NVT MD over an n-slab ring along ``axis`` (n >= 2; one slab
    is ``md.engine.MolecularDynamics``)."""

    def __init__(self, model, atoms: Atoms, n_devices: int = 2,
                 axis: int = 0, **kwargs):
        """kwargs: ``BrickMolecularDynamics``'s (dt_fs, temperature_K,
        ensemble, skin, rebuild_every, seed, devices, ...)."""
        if n_devices < 2:
            raise ValueError('a ring of one slab: use '
                             'md.engine.MolecularDynamics')
        super().__init__(model, atoms, mesh_shape=(n_devices,),
                         axes=(axis,), **kwargs)
