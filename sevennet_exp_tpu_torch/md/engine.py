"""MD driver on one device: two-tier Verlet list + dense neighbor grid.

Counterpart of ``sevennet_exp_tpu/md/engine.py::MolecularDynamics`` with
its five ensembles (``nve``, ``langevin``, ``nvt``, ``npt``,
``npt_aniso``) on the dense grid. A Verlet
list is built at cutoff + skin and reused while no atom has moved more
than (skin - md_buffer)/2 since its build; every ``rebuild_every`` steps
it is compacted (``_compact_nl``) into the dense per-atom grid the model
reads: row ``i*deg_cap + k`` is atom i's k-th neighbor inside
cutoff + md_buffer, pad rows are masked self-edges and ``rev`` pairs
each row with its reverse. Capacities (``e_cap``, ``deg_cap``,
``cell_cap``) are sized from the t=0 structure; an overflow, checked on
the host once per compaction, grows them and rebuilds. The loop is
plain Python (eager PyTorch); the grid's staleness bound (md_buffer/2)
is checked after each chunk: a stale chunk drops the cadence onto a fixed
ladder and is re-run, a quiet one (under 0.35 of the bound) climbs the
ladder one rung back towards the configured cadence.

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

Under ``npt`` / ``npt_aniso`` the cell lives in the state and moves every
step: the potential returns the stress too (``_efs_fn``), every neighbor
routine takes the state's cell (the engine keeps no cached cell then), the
Verlet list is rebuilt at every chunk, and the grid's staleness inside a
chunk is measured in fractional coordinates plus a bound on what the
cell's strain alone does to a pair distance.

``cg_mode='terms'`` runs the convolutions through the independently derived
``terms`` kernels (``ops/fused_conv_terms.py``) instead of the default
ones: same numbers, a cross-check. It has no geometry-fused and no
half-list form.

With ``d3=`` (an ``ops/d3.D3Dispersion``) the Grimme D3 energy is added
to the model's before the one backward pass (the reference's LAMMPS
``pair_style hybrid/overlay e3gnn d3``), on positions wrapped into the
cell; under NPT the strain deforms positions and lattice, so D3 enters
the stress. The whole-array path sums replicas of the cell (the integer
range enumerated on the host; under NPT on a cell shrunk by
``d3_npt_margin`` and enumerated again when the barostat compresses past
it); the chunked path sweeps the minimum-image tiles
(``dispersion_energy_tiled``) and refuses at start-up a cell narrower
than twice the D3 cutoff.

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
from ..ops import d3 as d3mod
from ..ops.fused_conv import CG_MODE_KEY, CG_MODES, USE_KERNELS_KEY
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
    det3,
    inv3,
    mic_displacements,
)
from .units import fs as FS

ENSEMBLES = ('nve', 'langevin', 'nvt', 'npt', 'npt_aniso')
EV_A3_PER_GPA = 1.0 / 160.21766      # 1 GPa in eV/A^3


# more grid rows than this and the convolutions run chunked (the JAX
# engine's switch point, so the same systems chunk in both packages)
CHUNK_SWITCH_ROWS = 524288
# grid rows per chunk past the switch: the gathered neighbor features of
# one mid layer (480 columns) then take 1.0 GB per chunk. Measured at
# 97,336 atoms (tools/large_system.py, NVIDIA H100 80GB HBM3, 700 W):
# 32,768 to 1,048,576 rows per chunk take 969 to 904 ms per force call and
# 8.7 to 12.5 GB; this size is within 0.5 % of the fastest at 2 GB less
CHUNK_ROWS = 524288
# atoms per tile of the chunked path's D3 sweep: 64 MB a (B, B) fp32 plane
D3_TILE_BLOCK = 4096


def _cell_widths(cell) -> np.ndarray:
    cell = np.asarray(cell, np.float64)
    vol = abs(np.linalg.det(cell))
    return np.array([
        vol / np.linalg.norm(np.cross(cell[(i + 1) % 3], cell[(i + 2) % 3]))
        for i in range(3)
    ])


class MolecularDynamics:
    """MD on one device. ensemble: 'nve' | 'langevin' (BAOAB) | 'nvt'
    (Nose-Hoover) | 'npt' (Nose-Hoover + isotropic Berendsen barostat) |
    'npt_aniso' (full-cell tensor Berendsen barostat)."""

    def __init__(
        self,
        model: SevenNetModel,
        atoms: Atoms,
        dt_fs: float = 2.0,
        temperature_K: float = 300.0,
        ensemble: str = 'nvt',
        friction_per_fs: float = 0.002,
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
        pressure_gpa: float = 0.0,
        pdamp_fs: Optional[float] = None,
        cg_mode: str = 'cmshared',
        use_kernels: bool = True,
        d3: Optional[d3mod.D3Dispersion] = None,
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
        and a grid with a degree overflow never feeds it.
        friction_per_fs: Langevin friction. pressure_gpa, pdamp_fs: target
        pressure and barostat time of the NPT ensembles (default 1000 dt).
        cg_mode: 'cmshared' (default kernels) or 'terms' (the independent
        cross-check pair; not with ``geom_dense`` or ``half_mlp``; chunks
        then run with shared sh/emb whatever ``geom_fused`` says).
        use_kernels: False runs every convolution as the plain chain (JAX
        ``use_pallas=False``), whole-array or chunk by chunk; no geometry
        fusion and no half list.
        d3: a ``D3Dispersion`` whose damping, functional and thresholds
        are added to the potential (its tables are built on this engine's
        device); None for the model alone."""
        if ensemble not in ENSEMBLES:
            raise ValueError(f'ensemble {ensemble!r}: one of {ENSEMBLES}')
        if cg_mode not in CG_MODES:
            raise ValueError(f'cg_mode {cg_mode!r}: one of {CG_MODES}')
        if cg_mode == 'terms' and (geom_dense or half_mlp):
            raise ValueError("cg_mode 'terms' has no geometry-fused and no "
                             'external-weight kernels: not with geom_dense '
                             'or half_mlp')
        self.cg_mode = cg_mode
        self.use_kernels = bool(use_kernels)
        self.npt = ensemble.startswith('npt')
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
        self._rebuild_every0 = rebuild_every
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
            cell=self.cell if self.npt else None,
        )
        if self.npt:
            # the cell lives in the state from here on: a stale read of a
            # cached cell must fail, not pass
            self.cell = self.inv_cell = None
        if tdamp_fs is None:
            tdamp_fs = 100.0 * dt_fs / 2.0
        self.tdamp = tdamp_fs * FS
        self.friction = friction_per_fs / FS
        self.pressure = pressure_gpa * EV_A3_PER_GPA
        self.pdamp = (pdamp_fs or 1000.0 * dt_fs) * FS
        self._verlet: Optional[NeighborState] = None
        self._primed = False
        self._const = {
            KEY.ATOMIC_NUMBERS: self.Z,
            KEY.BATCH: torch.zeros(n, dtype=torch.long, device=dev),
            KEY.NUM_ATOMS: torch.tensor([n], device=dev),
            KEY.NODE_MASK: torch.ones(n, dtype=f32, device=dev),
        }
        self._d3: Optional[Dict] = None
        if d3 is not None:
            self._setup_d3(d3, np.asarray(atoms.atomic_numbers), cell_np)

    # -- D3 --------------------------------------------------------------
    def _setup_d3(self, d3, z: np.ndarray, cell: np.ndarray):
        """Host-side D3 set-up (JAX engine): per-type tables and type
        indices on the device, the replica shift ranges; on the chunked
        path the minimum-image guard."""
        z_unique, tidx = np.unique(z, return_inverse=True)
        self._d3 = dict(
            engine=d3,
            tables=d3mod.build_tables(z_unique, self.dtype, self.device),
            tidx=torch.as_tensor(tidx.reshape(-1), device=self.device))
        self.d3_npt_margin = 1.15
        self._d3_enumerate_shifts(cell)
        if self.conv_chunk_rows:
            r_vdw = float(np.sqrt(d3.rthr)) * d3mod.AU_TO_ANG
            if self.npt:
                r_vdw *= self.d3_npt_margin
            if not d3mod.mic_ok(cell, r_vdw):
                raise ValueError(
                    'D3 on the chunked large-system path uses minimum-image '
                    'convention: every cell width must be >= 2*r_vdw = '
                    f'{2 * r_vdw:.1f} A. Reduce D3Dispersion(rthr=...) '
                    '(forces beyond ~20 A are < 1e-6 eV/A) or enlarge the '
                    'cell.')

    def _d3_enumerate_shifts(self, cell: np.ndarray):
        """(Re)build the integer replica-shift ranges; under NPT on the
        cell shrunk by ``d3_npt_margin``, so that the range covers the
        barostat compressing every axis by that factor. The shift vectors
        follow the cell at run time (tau = tau_frac @ lat)."""
        d, eng = self._d3, self._d3['engine']
        enum_cell = np.asarray(cell, np.float64)
        if self.npt:
            enum_cell = enum_cell / self.d3_npt_margin
        lat = enum_cell / d3mod.AU_TO_ANG
        c, pbc = eng.shift_chunk, np.ones(3, bool)
        for key, r2 in (('shifts_vdw', eng.rthr), ('shifts_cn', eng.cn_thr)):
            d[key] = torch.as_tensor(
                d3mod.lattice_shifts(lat, pbc, np.sqrt(r2), c).reshape(
                    -1, c, 3), dtype=self.dtype, device=self.device)
        # the cell widths the enumeration covers
        self._d3_min_widths = _cell_widths(enum_cell)

    def _d3_follow_cell(self, cell):
        """NPT, once per accepted chunk (host): enumerate the shifts again
        when the barostat has compressed the cell past their coverage."""
        cell_np = cell.detach().cpu().numpy().astype(np.float64)
        if np.any(_cell_widths(cell_np) < self._d3_min_widths):
            self._d3_enumerate_shifts(cell_np)

    def _d3_energy(self, pos, cell=None, strain=None):
        """D3 energy (eV) at unwrapped positions ``pos``: wrapped into the
        cell (the gradient of the wrap is the identity), then, with a
        ``strain``, positions and lattice deformed by it; the replica sum
        on the whole-array path, the tiled minimum-image sweep on the
        chunked path."""
        d, eng = self._d3, self._d3['engine']
        cell_m, inv = self._cell_pair(cell)
        pos_w = torch.remainder(pos @ inv, 1.0) @ cell_m
        lat = cell_m
        if strain is not None:
            pos_w = pos_w + pos_w @ strain
            lat = cell_m + cell_m @ strain
        au = d3mod.AU_TO_ANG
        if self.conv_chunk_rows:
            block = min(D3_TILE_BLOCK, -(-self.n // 64) * 64)
            e = d3mod.dispersion_energy_tiled(
                pos_w / au, lat / au, d['tidx'], d['tables'], eng.damping,
                eng.rthr, eng.cn_thr, block=block)
        else:
            e = d3mod.dispersion_energy(
                pos_w / au, lat / au, d['tidx'], d['tables'], eng.damping,
                d['shifts_vdw'], d['shifts_cn'], eng.rthr, eng.cn_thr)
        return e * d3mod.AU_TO_EV

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
    def _cell_pair(self, cell=None):
        """(cell, inverse): the given (state's) cell, or the engine's static
        one outside NPT."""
        if cell is None:
            return self.cell, self.inv_cell
        return cell, inv3(cell)

    def _build_nl(self, pos, cell=None) -> NeighborState:
        nl = self._build(pos, self._cell_pair(cell)[0], self.e_cap)
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

    def _compact_nl(self, nl: NeighborState, pos,
                    cell=None) -> NeighborState:
        """Re-lay the Verlet list out as the dense per-atom grid (JAX
        ``_compact_nl``): rank each kept edge within its center's
        segment, drop ranks >= deg_cap (flagging overflow_deg), fill the
        rest with masked self-edges, and derive the grid's reverse
        permutation from the build list's one by O(E) gathers."""
        D = self.deg_cap
        dst, src = nl.edge_idx[0], nl.edge_idx[1]
        vec = mic_displacements(pos[dst], pos[src], *self._cell_pair(cell))
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
        if (self.half_mlp and self.use_kernels and not self.conv_chunk_rows
                and not bool(overflow_deg)):
            half, pair = half_pair_indices(rev)
        return NeighborState(
            edge_idx=torch.stack([base, src_p]), valid=valid,
            overflow=nl.overflow, overflow_deg=overflow_deg,
            overflow_bin=nl.overflow_bin, ref_pos=pos, rev=rev,
            half=half, pair=pair, ref_cell=cell)

    # -- potential -----------------------------------------------------
    def _graph(self, pos, nl: NeighborState, cell=None, strain=None):
        """Model inputs on the dense grid; the pair gather carries the
        scatter-free backward that assembles the forces. cell: the state's
        cell under NPT. strain: a (3, 3) strain applied to the edge vectors
        as ``vec + vec @ strain`` (``_efs_fn`` needs none: the model takes
        the strain gradient in closed form)."""
        pi, pj = gather_pair(pos, nl.edge_idx, nl.rev, self.deg_cap)
        vec = mic_displacements(pi, pj, *self._cell_pair(cell))
        r2 = torch.sum(vec * vec, dim=-1)
        mask = nl.valid & (r2 < self.cutoff ** 2)
        unit_x = vec.new_tensor([1.0, 0.0, 0.0])
        safe = torch.where(mask[:, None], vec, unit_x)
        if strain is not None:
            safe = safe + safe @ strain
        chunk_rows = self.conv_chunk_rows
        geom = ((self.geom_fused if chunk_rows else self.geom_dense)
                and self.cg_mode != 'terms' and self.use_kernels
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
            CG_MODE_KEY: self.cg_mode,
            USE_KERNELS_KEY: self.use_kernels,
        })

    def _energy_fn(self, pos, nl: NeighborState):
        e = self.model.energy(self._graph(pos, nl))
        if self._d3 is not None:
            e = e + self._d3_energy(pos)
        return e

    def _ef_fn(self, pos, nl: NeighborState):
        extra = None if self._d3 is None else self._d3_energy
        return self.model.energy_and_forces(
            pos, lambda p: self._graph(p, nl), extra=extra)

    def _efs_fn(self, pos, nl: NeighborState, cell):
        """(energy, forces, stress Voigt) on an explicit cell (the NPT
        path); stress = -virial/V in the model convention."""
        extra = (None if self._d3 is None else
                 lambda p, strain: self._d3_energy(p, cell, strain))
        return self.model.energy_forces_stress(
            pos, cell, lambda p: self._graph(p, nl, cell), extra=extra)

    def _make_step(self):
        if self.ensemble == 'nve':
            return integrate.make_nve_step(self._ef_fn, self.masses, self.dt)
        if self.ensemble == 'langevin':
            return integrate.make_langevin_step(
                self._ef_fn, self.masses, self.dt, self.temperature_K,
                self.friction, self.generator)
        if self.ensemble == 'nvt':
            return integrate.make_nose_hoover_step(
                self._ef_fn, self.masses, self.dt, self.temperature_K,
                self.tdamp)
        make = (integrate.make_npt_berendsen_step if self.ensemble == 'npt'
                else integrate.make_npt_berendsen_aniso_step)
        return make(self._efs_fn, self.masses, self.dt, self.temperature_K,
                    self.tdamp, self.pressure, self.pdamp)

    # -- run loop ------------------------------------------------------
    @property
    def _verlet_thresh(self) -> float:
        return 0.5 * (self.skin - self.md_buffer)

    def _max_disp(self, ref, pos, ref_cell=None, cell=None) -> torch.Tensor:
        """Largest displacement of an atom since ``ref``. Under NPT (cells
        given) the displacement is taken in fractional coordinates and
        mapped by the current cell, so the barostat's scaling of all
        positions does not count as motion; what the strain alone does to a
        pair at the grid's radius is added as a bound."""
        if cell is None:
            d = mic_displacements(ref, pos, self.cell, self.inv_cell)
            return torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
        inv_ref = inv3(ref_cell)
        frac = pos @ inv3(cell) - ref @ inv_ref
        d = (frac - torch.round(frac)) @ cell
        strain = inv_ref @ cell - torch.eye(
            3, dtype=cell.dtype, device=cell.device)
        return (torch.sqrt(torch.max(torch.sum(d * d, dim=-1)))
                + 0.5 * (self.cutoff + self.md_buffer)
                * torch.linalg.norm(strain))

    def _follow_cell(self, cell):
        """NPT, once per compaction (host): the moved cell must still hold
        the minimum image -- the skin is clamped on it as at start-up, and a
        cell too small for the smallest skin raises -- and the bin grid is
        re-chosen when the barostat has made a bin thinner than the build
        cutoff."""
        cell_np = cell.detach().cpu().numpy().astype(np.float64)
        widths = _cell_widths(cell_np)
        if np.any(widths < 2 * self.build_cutoff):
            self.skin = float(widths.min()) / 2.0 - self.cutoff - 1e-6
            if self.skin < 0.25:
                raise ValueError(
                    'the cell shrank below the minimum-image width '
                    f'2 * (cutoff + 0.25) = {2 * (self.cutoff + 0.25)}')
            self.build_cutoff = self.cutoff + self.skin
            self.md_buffer = min(0.5, self.skin)
        if self.use_cell_list and np.any(
                widths / np.asarray(self.grid) < self.build_cutoff):
            self.grid = choose_grid(cell_np, self.build_cutoff)
            self.use_cell_list = (all(g >= 3 for g in self.grid)
                                  and self.n > 512)

    def _grid(self) -> NeighborState:
        """Compacted grid at the current positions; rebuilds the Verlet
        list when stale (under NPT always: staleness against an old cell is
        ill-defined) and regrows capacities on overflow (host checks, once
        per compaction)."""
        pos, cell = self.state.pos, self.state.cell
        if self.npt:
            self._follow_cell(cell)
            self._verlet = None
        while True:
            if (self._verlet is None or float(self._max_disp(
                    self._verlet.ref_pos, pos)) > self._verlet_thresh):
                self._verlet = self._build_nl(pos, cell)
            nl = self._compact_nl(self._verlet, pos, cell)
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
        if self.npt:
            e, f, _ = self._efs_fn(self.state.pos, self._grid(),
                                   self.state.cell)
        else:
            e, f = self._ef_fn(self.state.pos, self._grid())
        self.state = self.state._replace(energy=e, forces=f)
        self._primed = True

    def _cadence_ladder(self) -> List[int]:
        """The cadences the engine may take: a fixed ladder below the
        configured one, and the configured one (as the JAX engine's)."""
        k0 = self._rebuild_every0
        base = [1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 25, 32, 40, 50]
        return sorted({k for k in base if k < k0} | {k0})

    def _snap_cadence(self, k: int) -> int:
        downs = [v for v in self._cadence_ladder() if v <= max(1, k)]
        return downs[-1] if downs else 1

    def _adjust_cadence(self, worst: float) -> bool:
        """Moves ``rebuild_every`` after a chunk whose largest displacement
        since the grid's compaction was ``worst``; True when the chunk went
        stale and must be re-run. Stale (over md_buffer/2): straight to the
        rung under a cadence that keeps the chunk at ~70 % of the bound.
        Quiet (under 0.35 of it): one rung up, to the configured cadence at
        most; the gap between the two is the hysteresis."""
        bound = 0.5 * self.md_buffer
        if worst > bound:
            k_new = max(1, int(self.rebuild_every * 0.7 * bound / worst))
            self.rebuild_every = self._snap_cadence(
                min(k_new, max(1, self.rebuild_every - 1)))
            return True
        if worst < 0.35 * bound and self.rebuild_every < self._rebuild_every0:
            self.rebuild_every = next(
                k for k in self._cadence_ladder() if k > self.rebuild_every)
        return False

    def run(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Advance n_steps; returns per-chunk energy, temperature, largest
        displacement and steps (and the volume under NPT)."""
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
            worst = float(self._max_disp(nl.ref_pos, state.pos, nl.ref_cell,
                                         state.cell))
            if self._adjust_cadence(worst) and k > 1:
                # the grid went stale inside the chunk: redo it from the
                # chunk's start at the shorter cadence (a one-step chunk
                # cannot be shortened and is kept)
                continue
            self.state = state
            done += k
            if self.npt and self._d3 is not None:
                self._d3_follow_cell(state.cell)
            rows.append({
                'energy': float(state.energy),
                'temperature': float(integrate.temperature(state,
                                                           self.masses)),
                'max_disp': worst,
                'steps': k,
            })
            if self.npt:
                rows[-1]['volume'] = float(
                    torch.abs(det3(state.cell)))
        return {key: np.array([r[key] for r in rows]) for key in rows[0]} \
            if rows else {}
