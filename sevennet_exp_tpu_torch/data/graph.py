"""Structure container, Atoms -> graph dicts and static-shape padded
batching, numpy on the host.

Counterpart of ``sevennet_exp_tpu/data/graph.py``: ``Atoms`` (with
optional energy, force and stress labels), ``unlabeled_atoms_to_graph``,
``atoms_to_graph``, ``pad_cap`` and ``collate_graphs``. A graph is a dict
of numpy arrays under the reference's key names; a batch is one
concatenated graph padded to fixed (n_node, n_edge, n_graph) capacities
with NODE_MASK / EDGE_MASK / GRAPH_MASK, and with the labels (NaN where a
label is missing or the slot is a pad) when its graphs carry them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from .. import _keys as KEY
from .neighborlist import neighbor_list


@dataclass
class Atoms:
    """ASE-free structure: numbers, Cartesian positions (Angstrom), cell
    rows as lattice vectors, periodic flags, and optional labels."""
    atomic_numbers: np.ndarray      # (N,) int
    pos: np.ndarray                 # (N, 3)
    cell: np.ndarray                # (3, 3)
    pbc: np.ndarray                 # (3,) bool
    energy: Optional[float] = None          # eV
    forces: Optional[np.ndarray] = None     # (N, 3) eV/A
    stress: Optional[np.ndarray] = None     # (6,) xx yy zz xy yz zx, eV/A^3
    info: Optional[Dict] = None

    def __len__(self):
        return len(self.atomic_numbers)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))


def build_nacl(n_target: int, rattle: float = 0.02, seed: int = 0) -> Atoms:
    """NaCl rocksalt supercell of ~n_target atoms (a = 5.63 A, rattled
    by ``rattle`` A from ``default_rng(seed)``). Counterpart of
    ``bench.py::build_nacl``."""
    a = 5.63
    reps = max(2, round((n_target / 8) ** (1 / 3)))
    rng = np.random.default_rng(seed)
    base = np.array([
        [0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
        [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5],
    ])
    zs = [11, 11, 11, 11, 17, 17, 17, 17]
    fracs, zlist = [], []
    for i in range(reps):
        for j in range(reps):
            for k in range(reps):
                for b, z in zip(base, zs):
                    fracs.append((b + [i, j, k]) / reps)
                    zlist.append(z)
    cell = np.eye(3) * a * reps
    pos = np.array(fracs) @ cell
    pos += rng.normal(scale=rattle, size=pos.shape)
    return Atoms(atomic_numbers=np.array(zlist), pos=pos, cell=cell,
                 pbc=np.array([True] * 3))


def unlabeled_atoms_to_graph(atoms: Atoms, cutoff: float) -> Dict:
    """Reference dataload.py:102-130."""
    ei, ej, evec, shift = neighbor_list(atoms.pos, atoms.cell, atoms.pbc,
                                        cutoff)
    vol = atoms.volume
    if vol == 0.0:
        vol = float(np.finfo(float).eps)
    return {
        KEY.ATOMIC_NUMBERS: atoms.atomic_numbers.astype(np.int64),
        KEY.POS: atoms.pos.astype(np.float64),
        KEY.EDGE_IDX: np.stack([ei, ej]).astype(np.int64),
        KEY.EDGE_VEC: evec.astype(np.float64),
        KEY.CELL: atoms.cell.astype(np.float64),
        KEY.CELL_SHIFT: shift.astype(np.float64),
        KEY.CELL_VOLUME: np.float64(vol),
        KEY.NUM_ATOMS: np.int64(len(atoms)),
        KEY.INFO: dict(atoms.info or {}),
    }


def atoms_to_graph(atoms: Atoms, cutoff: float, transfer_info: bool = True,
                   allow_unlabeled: bool = False) -> Dict:
    """Labeled variant (reference dataload.py:133-226). Missing labels are
    NaN (the losses mask them)."""
    g = unlabeled_atoms_to_graph(atoms, cutoff)
    n = len(atoms)
    y_energy = np.nan if atoms.energy is None else float(atoms.energy)
    y_force = (np.full((n, 3), np.nan) if atoms.forces is None
               else np.asarray(atoms.forces, dtype=np.float64))
    y_stress = (np.full((6,), np.nan) if atoms.stress is None
                else np.asarray(atoms.stress, dtype=np.float64).reshape(6))
    if not allow_unlabeled and (np.isnan(y_energy)
                                or np.isnan(y_force).any()):
        raise ValueError('Unlabeled E or F found, set allow_unlabeled True')
    g[KEY.ENERGY] = np.float64(y_energy)
    g[KEY.FORCE] = y_force
    g[KEY.STRESS] = y_stress.reshape(1, 6)
    g[KEY.PER_ATOM_ENERGY] = np.float64(y_energy / n)
    if not transfer_info:
        g[KEY.INFO] = {}
    return g


def pad_cap(n: int, multiple: int = 8, margin: float = 1.0) -> int:
    """Round a capacity up to a multiple, after a growth margin."""
    n = int(np.ceil(n * margin))
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def collate_graphs(graphs: Sequence[Dict], n_node: Optional[int] = None,
                   n_edge: Optional[int] = None,
                   n_graph: Optional[int] = None,
                   dtype=np.float32) -> Dict[str, np.ndarray]:
    """Concatenate graphs and pad to capacities -> static-shape batch.
    Pad atoms belong to the last graph with NODE_MASK 0; pad edges are
    self-edges of the last atom slot with EDGE_MASK 0 and the unit vector
    (1, 0, 0), which keeps their norms finite. Labeled graphs add ENERGY,
    FORCE, STRESS (NaN on pads) and the per-graph data weights; graphs
    tagged with MODAL_TYPE add it per graph."""
    n_graphs = len(graphs)
    tot_nodes = int(sum(int(g[KEY.NUM_ATOMS]) for g in graphs))
    tot_edges = int(sum(g[KEY.EDGE_IDX].shape[1] for g in graphs))
    n_node = n_node or tot_nodes
    n_edge = n_edge or tot_edges
    n_graph = n_graph or n_graphs
    if tot_nodes > n_node or tot_edges > n_edge or n_graphs > n_graph:
        raise ValueError(
            f'batch overflow: nodes {tot_nodes}/{n_node}, '
            f'edges {tot_edges}/{n_edge}, graphs {n_graphs}/{n_graph}')

    z = np.zeros(n_node, dtype=np.int64)
    pos = np.zeros((n_node, 3), dtype=dtype)
    batch = np.full(n_node, max(n_graph - 1, 0), dtype=np.int32)
    edge_idx = np.full((2, n_edge), max(n_node - 1, 0), dtype=np.int32)
    edge_vec = np.zeros((n_edge, 3), dtype=dtype)
    edge_vec[:, 0] = 1.0
    cell_shift = np.zeros((n_edge, 3), dtype=dtype)
    cell = np.zeros((n_graph, 3, 3), dtype=dtype)
    vol = np.ones(n_graph, dtype=dtype)
    num_atoms = np.zeros(n_graph, dtype=np.int32)
    node_mask = np.zeros(n_node, dtype=dtype)
    edge_mask = np.zeros(n_edge, dtype=dtype)
    graph_mask = np.zeros(n_graph, dtype=dtype)

    has_labels = KEY.ENERGY in graphs[0] if graphs else False
    if has_labels:
        y_e = np.full(n_graph, np.nan, dtype=dtype)
        y_f = np.full((n_node, 3), np.nan, dtype=dtype)
        y_s = np.full((n_graph, 6), np.nan, dtype=dtype)
        w_e = np.ones(n_graph, dtype=dtype)
        w_f = np.ones(n_graph, dtype=dtype)
        w_s = np.ones(n_graph, dtype=dtype)

    no, eo = 0, 0
    for gi, g in enumerate(graphs):
        n = int(g[KEY.NUM_ATOMS])
        e = g[KEY.EDGE_IDX].shape[1]
        z[no:no + n] = g[KEY.ATOMIC_NUMBERS]
        pos[no:no + n] = g[KEY.POS]
        batch[no:no + n] = gi
        edge_idx[:, eo:eo + e] = g[KEY.EDGE_IDX] + no
        edge_vec[eo:eo + e] = g[KEY.EDGE_VEC]
        cell_shift[eo:eo + e] = g[KEY.CELL_SHIFT]
        cell[gi] = g[KEY.CELL]
        vol[gi] = g[KEY.CELL_VOLUME]
        num_atoms[gi] = n
        node_mask[no:no + n] = 1.0
        edge_mask[eo:eo + e] = 1.0
        graph_mask[gi] = 1.0
        if has_labels:
            y_e[gi] = g[KEY.ENERGY]
            y_f[no:no + n] = g[KEY.FORCE]
            y_s[gi] = g[KEY.STRESS].reshape(6)
            dw = g.get(KEY.DATA_WEIGHT)
            if dw is not None:
                w_e[gi] = dw.get('energy', 1.0)
                w_f[gi] = dw.get('force', 1.0)
                w_s[gi] = dw.get('stress', 1.0)
        no += n
        eo += e

    out = {
        KEY.ATOMIC_NUMBERS: z,
        KEY.POS: pos,
        KEY.BATCH: batch,
        KEY.EDGE_IDX: edge_idx,
        KEY.EDGE_VEC: edge_vec,
        KEY.CELL_SHIFT: cell_shift,
        KEY.CELL: cell,
        KEY.CELL_VOLUME: vol,
        KEY.NUM_ATOMS: num_atoms,
        KEY.NODE_MASK: node_mask,
        KEY.EDGE_MASK: edge_mask,
        KEY.GRAPH_MASK: graph_mask,
    }
    if has_labels:
        out[KEY.ENERGY] = y_e
        out[KEY.FORCE] = y_f
        out[KEY.STRESS] = y_s
        out['data_weight_energy'] = w_e
        out['data_weight_force'] = w_f
        out['data_weight_stress'] = w_s
    if graphs and KEY.MODAL_TYPE in graphs[0]:
        # the modality of each graph (a multi-modal model's input); pad
        # graphs take modality 0
        mt = np.zeros(n_graph, dtype=np.int32)
        for gi, g in enumerate(graphs):
            mt[gi] = int(g[KEY.MODAL_TYPE])
        out[KEY.MODAL_TYPE] = mt
    return out
