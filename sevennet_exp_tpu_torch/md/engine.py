"""MD driver on one device: two-tier Verlet list + dense neighbor grid.

Counterpart of ``sevennet_exp_tpu/md/engine.py::MolecularDynamics`` for
the ``nve``/``nvt`` ensembles on the whole-array dense grid. A Verlet
list is built at cutoff + skin and reused while no atom has moved more
than (skin - md_buffer)/2 since its build; every ``rebuild_every`` steps
it is compacted (``_compact_nl``) into the dense per-atom grid the model
reads: row ``i*deg_cap + k`` is atom i's k-th neighbor inside
cutoff + md_buffer, pad rows are masked self-edges and ``rev`` pairs
each row with its reverse. Capacities (``e_cap``, ``deg_cap``,
``cell_cap``) are sized from the t=0 structure; an overflow, checked on
the host once per compaction, grows them and rebuilds. The loop is
plain Python (eager PyTorch); the grid's staleness bound (md_buffer/2)
is checked after each chunk and a stale chunk is re-run at half the
cadence.

Above ``CHUNK_SWITCH_ROWS`` grid rows (or with ``conv_chunk_atoms``) the
convolutions run chunk by chunk over the grid (``conv_chunk_rows``), so
only one chunk's gathered neighbor features exist at a time, and by
default geometry-fused: the model gets the raw edge vectors and the conv
kernels compute Bessel, cutoff and SH themselves
(``model/layers.py::_ChunkedConvFn``).

With ``half_mlp`` the whole-array path runs the radial MLP once per edge
pair: each compaction also builds the grid's half list (``half``, ``pair``
on the grid state; built at static sizes without a host synchronisation,
after one read of the degree-overflow flag, since a grid that overflowed
must not carry one), and the convolutions take their per-edge weights
ready-made (``model/layers.py::_half_mlp_w``). Off by default.

Needs every cell width >= 2 * (cutoff + skin) (minimum image).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _keys as KEY
from ..data.graph import Atoms
from ..data.periodic import atomic_masses
from ..model.layers import geom_packed_ok
from ..model.model import SevenNetModel
from ..ops.scatter import (
    gather_pair,
    half_pair_indices,
    reverse_permutation,
)
from . import integrate
from .integrate import MDState
from .neighbor import (
    NeighborState,
    cell_list_neighbor_list,
    choose_grid,
    dense_neighbor_list,
    mic_displacements,
)
from .units import fs as FS


# more grid rows than this and the convolutions run chunked (the JAX
# engine's switch point, so the same systems chunk in both packages)
CHUNK_SWITCH_ROWS = 524288
# grid rows per chunk past the switch: the gathered neighbor features of
# one mid layer (480 columns) then take 1.0 GB per chunk. Measured at
# 97,336 atoms (tools/large_system.py, NVIDIA H100 80GB HBM3, 700 W):
# 32,768 to 1,048,576 rows per chunk take 969 to 904 ms per force call and
# 8.7 to 12.5 GB; this size is within 0.5 % of the fastest at 2 GB less
CHUNK_ROWS = 524288


def _cell_widths(cell) -> np.ndarray:
    cell = np.asarray(cell, np.float64)
    vol = abs(np.linalg.det(cell))
    return np.array([
        vol / np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        for i in range(3)
    ])


class MolecularDynamics:
    """MD on one device. ensemble: 'nve' | 'nvt' (Nose-Hoover)."""

    def __init__(
        self,
        model: SevenNetModel,
        atoms: Atoms,
        dt_fs: float = 2.0,
        temperature_K: float = 300.0,
        ensemble: str = 'nvt',
        tdamp_fs: Optional[float] = None,
        skin: float = 2.0,
        rebuild_every: int = 10,
        seed: int = 0,
        device='cuda',
        velocities: Optional[np.ndarray] = None,
        conv_chunk_atoms: int = 0,
        geom_fused: bool = True,
        geom_dense: bool = False,
        half_mlp: bool = False,
    ):
        """velocities: initial (N, 3) velocities in internal units; drawn
        from Maxwell-Boltzmann on a ``torch.Generator(seed)`` if None.
        conv_chunk_atoms: atoms per convolution chunk; 0 chunks only
        above ``CHUNK_SWITCH_ROWS`` grid rows, at ``CHUNK_ROWS``.
        geom_fused: the chunked path runs the geometry-fused conv (off:
        shared sh/emb arrays and the plain fused conv per chunk).
        geom_dense: the whole-array path runs geometry-fused too.
        half_mlp: the whole-array path runs the radial MLP on the half
        list (one row per edge pair) and the external-weight fused conv;
        ``geom_dense`` goes first, the chunked path does not consult it,
        and a grid with a degree overflow never feeds it."""
        if ensemble not in ('nve', 'nvt'):
            raise ValueError(f'ensemble {ensemble!r}: the port runs nve '
                             'and nvt')
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.dtype = torch.float32
        self.conv_chunk_atoms = int(conv_chunk_atoms)
        self.geom_fused, self.geom_dense = bool(geom_fused), bool(geom_dense)
        self.half_mlp = bool(half_mlp)
        self._geom_ok: Optional[bool] = None
        n = len(atoms)
        self.n = n
        dev, f32 = self.device, self.dtype
        self.Z = torch.as_tensor(np.asarray(atoms.atomic_numbers),
                                 dtype=torch.long, device=dev)
        cell_np = np.asarray(atoms.cell, np.float64)
        self.cell = torch.as_tensor(cell_np, dtype=f32, device=dev)
        self.inv_cell = torch.linalg.inv(self.cell)
        self.masses = torch.as_tensor(
            np.asarray(atomic_masses)[np.asarray(atoms.atomic_numbers)],
            dtype=f32, device=dev)
        self.cutoff = float(model.cutoff)
        widths = _cell_widths(cell_np)
        max_skin = float(widths.min()) / 2.0 - self.cutoff - 1e-6
        self.skin = min(skin, max(0.25, max_skin))
        self.build_cutoff = self.cutoff + self.skin
        if np.any(widths < 2 * self.build_cutoff):
            raise ValueError('cell too small for minimum-image MD')
        self.md_buffer = min(0.5, self.skin)
        self.rebuild_every = rebuild_every
        self.dt = dt_fs * FS
        self.temperature_K = temperature_K
        self.ensemble = ensemble
        self.grid = choose_grid(cell_np, self.build_cutoff)
        self.use_cell_list = all(g >= 3 for g in self.grid) and n > 512
        self._size_capacities(np.asarray(atoms.pos, np.float64), cell_np)

        self.generator = torch.Generator(device=dev).manual_seed(seed)
        if velocities is None:
            vel = integrate.maxwell_boltzmann(self.generator, self.masses,
                                              temperature_K)
        else:
            vel = torch.tensor(np.array(velocities), dtype=f32,
                               device=dev)
        self.state = MDState(
            pos=torch.as_tensor(np.asarray(atoms.pos), dtype=f32,
                                device=dev),
            vel=vel, forces=torch.zeros((n, 3), dtype=f32, device=dev),
            energy=torch.zeros((), dtype=f32, device=dev),
            xi=torch.zeros((), dtype=f32, device=dev),
        )
        if tdamp_fs is None:
            tdamp_fs = 100.0 * dt_fs / 2.0
        self.tdamp = tdamp_fs * FS
        self._verlet: Optional[NeighborState] = None
        self._primed = False
        self._const = {
            KEY.ATOMIC_NUMBERS: self.Z,
            KEY.BATCH: torch.zeros(n, dtype=torch.long, device=dev),
            KEY.NUM_ATOMS: torch.tensor([n], device=dev),
            KEY.NODE_MASK: torch.ones(n, dtype=f32, device=dev),
        }

    # -- capacities ----------------------------------------------------
    def _size_capacities(self, pos: np.ndarray, cell: np.ndarray):
        """Measured-count sizing at t=0 (as the JAX engine): the Verlet
        capacity from the pairs inside cutoff+skin, the grid degree from
        the largest degree inside cutoff+md_buffer, the bin capacity
        from the fullest bin."""
        if self.use_cell_list:
            frac = (pos @ np.linalg.inv(cell)) % 1.0
            g = np.asarray(self.grid)
            b = np.minimum((frac * g).astype(np.int64), g - 1)
            bid = (b[:, 0] * g[1] + b[:, 1]) * g[2] + b[:, 2]
            max_occ = int(np.bincount(bid, minlength=int(np.prod(g))).max())
            self.cell_cap = int(np.ceil(max_occ * 1.3 + 4))
        else:
            self.cell_cap = 0
        # count in float64 with the port's own builders, on the engine's
        # device (at 97k atoms the cell list forms ~80 M candidate pairs)
        pos_t = torch.as_tensor(pos, dtype=torch.float64, device=self.device)
        cell_t = torch.as_tensor(cell, dtype=torch.float64,
                                 device=self.device)
        cap = max(64, self.n * 64)
        while True:
            nl = self._build(pos_t, cell_t, cap)
            if not bool(nl.overflow) and not bool(nl.overflow_bin):
                break
            if bool(nl.overflow_bin):
                self.cell_cap = int(self.cell_cap * 1.5 + 4)
            cap *= 2
        valid = nl.valid
        ei, ej = nl.edge_idx[0][valid], nl.edge_idx[1][valid]
        vec = mic_displacements(pos_t[ei], pos_t[ej], cell_t,
                                torch.linalg.inv(cell_t))
        r = torch.linalg.norm(vec, dim=-1)
        self.e_cap = int(np.ceil(int(r.numel()) * 1.12 + 128))
        close = ei[r < self.cutoff + self.md_buffer]
        deg_max = int(torch.bincount(close, minlength=self.n).max())
        self.deg_cap = int(np.ceil((deg_max * 1.15 + 2) / 4.0) * 4)

    def _build(self, pos, cell, e_cap) -> NeighborState:
        if self.use_cell_list:
            return cell_list_neighbor_list(pos, cell, self.build_cutoff,
                                           e_cap, self.grid, self.cell_cap)
        return dense_neighbor_list(pos, cell, self.build_cutoff, e_cap)

    # -- neighbor lists ------------------------------------------------
    def _build_nl(self, pos) -> NeighborState:
        nl = self._build(pos, self.cell, self.e_cap)
        return nl._replace(
            build_rev=reverse_permutation(nl.edge_idx, self.n))

    @property
    def e_cap_model(self) -> int:
        """Rows of the model-facing dense grid: n * deg_cap."""
        return self.n * self.deg_cap

    def _geom_packed_ok(self) -> bool:
        """Whether the model can run geometry-fused (every convolution
        carries a GeomSpec and takes the fused conv); decided once per
        engine."""
        if self._geom_ok is None:
            self._geom_ok = geom_packed_ok(self.model)
        return self._geom_ok

    @property
    def conv_chunk_rows(self) -> int:
        """0 = whole-array convolution; else the grid rows per chunk, a
        whole number of atoms."""
        if self.conv_chunk_atoms:
            return self.conv_chunk_atoms * self.deg_cap
        if self.e_cap_model > CHUNK_SWITCH_ROWS:
            return max(1, CHUNK_ROWS // self.deg_cap) * self.deg_cap
        return 0

    def _compact_nl(self, nl: NeighborState, pos) -> NeighborState:
        """Re-lay the Verlet list out as the dense per-atom grid (JAX
        ``_compact_nl``): rank each kept edge within its center's
        segment, drop ranks >= deg_cap (flagging overflow_deg), fill the
        rest with masked self-edges, and derive the grid's reverse
        permutation from the build list's one by O(E) gathers."""
        D = self.deg_cap
        dst, src = nl.edge_idx[0], nl.edge_idx[1]
        vec = mic_displacements(pos[dst], pos[src], self.cell,
                                self.inv_cell)
        r2 = torch.sum(vec * vec, dim=-1)
        keep = nl.valid & (r2 < (self.cutoff + self.md_buffer) ** 2)
        ckeep = torch.cumsum(keep.long(), 0)
        starts = torch.searchsorted(
            dst, torch.arange(self.n, device=dst.device))
        pref = torch.where(starts > 0,
                           ckeep[torch.clamp(starts - 1, min=0)],
                           torch.zeros_like(starts))
        rank = (ckeep - 1) - pref[dst]
        ok = keep & (rank < D)
        e_model = self.e_cap_model
        row = torch.where(ok, dst * D + rank,
                          torch.full_like(dst, e_model))
        base = torch.clamp(torch.arange(e_model, device=dst.device) // D,
                           max=self.n - 1)
        rows_ok = row[ok]
        src_p = base.clone()
        src_p[rows_ok] = src[ok]
        valid = torch.zeros(e_model, dtype=torch.bool, device=dst.device)
        valid[rows_ok] = True
        rev_rows = row[nl.build_rev]
        rev_rows = torch.where(rev_rows < e_model, rev_rows, row)
        rev = torch.arange(e_model, device=dst.device)
        rev[rows_ok] = rev_rows[ok]
        overflow_deg = torch.any(keep & (rank >= D))
        half = pair = None
        # a dropped edge leaves its reverse paired with itself: a real row
        # that is a fixed point of rev, which the half list would read as a
        # pad. Such a grid never carries a half list (one host read per
        # compaction, only with the option on)
        if (self.half_mlp and not self.conv_chunk_rows
                and not bool(overflow_deg)):
            half, pair = half_pair_indices(rev)
        return NeighborState(
            edge_idx=torch.stack([base, src_p]), valid=valid,
            overflow=nl.overflow, overflow_deg=overflow_deg,
            overflow_bin=nl.overflow_bin, ref_pos=pos, rev=rev,
            half=half, pair=pair)

    # -- potential -----------------------------------------------------
    def _graph(self, pos, nl: NeighborState):
        """Model inputs on the dense grid; the pair gather carries the
        scatter-free backward that assembles the forces."""
        pi, pj = gather_pair(pos, nl.edge_idx, nl.rev, self.deg_cap)
        vec = mic_displacements(pi, pj, self.cell, self.inv_cell)
        r2 = torch.sum(vec * vec, dim=-1)
        mask = nl.valid & (r2 < self.cutoff ** 2)
        unit_x = vec.new_tensor([1.0, 0.0, 0.0])
        safe = torch.where(mask[:, None], vec, unit_x)
        chunk_rows = self.conv_chunk_rows
        geom = ((self.geom_fused if chunk_rows else self.geom_dense)
                and self._geom_packed_ok())
        half = {}
        if nl.half is not None and not chunk_rows and not geom:
            half = {KEY.EDGE_HALF: nl.half, KEY.EDGE_PAIR: nl.pair}
        return dict(self._const, **half, **{
            KEY.EDGE_IDX: nl.edge_idx,
            KEY.EDGE_VEC: safe,
            KEY.EDGE_MASK: mask.to(safe.dtype),
            KEY.EDGE_REV: nl.rev,
            KEY.EDGE_DENSE_D: self.deg_cap,
            KEY.CONV_CHUNK_ROWS: chunk_rows,
            KEY.EDGE_GEOM_PACKED: geom,
        })

    def _energy_fn(self, pos, nl: NeighborState):
        return self.model.energy(self._graph(pos, nl))

    def _ef_fn(self, pos, nl: NeighborState):
        return self.model.energy_and_forces(
            pos, lambda p: self._graph(p, nl))

    def _make_step(self):
        if self.ensemble == 'nve':
            return integrate.make_nve_step(self._ef_fn, self.masses, self.dt)
        return integrate.make_nose_hoover_step(
            self._ef_fn, self.masses, self.dt, self.temperature_K,
            self.tdamp)

    # -- run loop ------------------------------------------------------
    @property
    def _verlet_thresh(self) -> float:
        return 0.5 * (self.skin - self.md_buffer)

    def _max_disp(self, ref, pos) -> torch.Tensor:
        d = mic_displacements(ref, pos, self.cell, self.inv_cell)
        return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))

    def _grid(self) -> NeighborState:
        """Compacted grid at the current positions; rebuilds the Verlet
        list when stale and regrows capacities on overflow (host checks,
        once per compaction)."""
        pos = self.state.pos
        while True:
            if (self._verlet is None or float(self._max_disp(
                    self._verlet.ref_pos, pos)) > self._verlet_thresh):
                self._verlet = self._build_nl(pos)
            nl = self._compact_nl(self._verlet, pos)
            over, over_deg, over_bin = torch.stack(
                [nl.overflow, nl.overflow_deg, nl.overflow_bin]).tolist()
            if not (over or over_deg or over_bin):
                return nl
            if over:
                self.e_cap = int(self.e_cap * 1.25) + 128
            if over_deg:
                self.deg_cap = int(np.ceil(self.deg_cap * 1.25 / 4.0) * 4)
            if over_bin:
                self.cell_cap = int(self.cell_cap * 1.5 + 4)
            self._verlet = None

    def prime(self):
        """Forces at the current positions (once before the first step)."""
        if self._primed:
            return
        e, f = self._ef_fn(self.state.pos, self._grid())
        self.state = self.state._replace(energy=e, forces=f)
        self._primed = True

    def run(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Advance n_steps; returns per-chunk energy and temperature."""
        self.prime()
        step = self._make_step()
        rows: List[Dict[str, float]] = []
        done = 0
        while done < n_steps:
            k = min(self.rebuild_every, n_steps - done)
            nl = self._grid()
            state = self.state
            for _ in range(k):
                state = step(state, nl)
            worst = float(self._max_disp(nl.ref_pos, state.pos))
            if worst > 0.5 * self.md_buffer and k > 1:
                # the grid went stale inside the chunk: redo it at half
                # the cadence from the chunk's start
                self.rebuild_every = max(1, k // 2)
                continue
            self.state = state
            done += k
            rows.append({
                'energy': float(state.energy),
                'temperature': float(integrate.temperature(state,
                                                           self.masses)),
                'max_disp': worst,
            })
        return {key: np.array([r[key] for r in rows]) for key in rows[0]} \
            if rows else {}
