"""Domain-decomposed MD on a K-axis brick mesh (K = 1, 2 or 3).

Counterpart of ``sevennet_exp_tpu/parallel/mdbrick.py``: the one engine
behind the slab ring (``md.py``), pencils (``md2d.py``) and full 3-D
bricks, with K staged halo phases before every convolution (the analog of
comm_brick.cpp's per-dimension swaps and pair_e3gnn_parallel.cpp:355-387's
per-segment forward_comm).

One controller. The JAX engine is a single program over a device mesh
(``shard_map``, ``ppermute`` halos whose transpose is the reverse
exchange); the port keeps that design in one process: it holds one state
per mesh position ("brick"), brick b on ``devices[b % len(devices)]``.
Phase k's halo is an ``index_select`` of the sending brick's view (plus
the image shift for positions), moved with ``.to(receiver's device)`` and
concatenated onto the receiver's view; autograd of those copies is the
reverse exchange, so ghost forces accumulate on their owners with no
hand-written backward. The model runs as one layer walk per brick in
lockstep (``SevenNetModel.walk``): before every convolution all bricks'
node features are refreshed together. So every mesh shape runs on one
card, and on the CPU in-process.

Per brick the model runs the serial engine's dense-grid path: the
symmetric grid of ``parallel/brick.py`` (EDGE_REV + the grid degree), the
fused conv's dense-grid kernels on the whole array (kernels 1-2), or,
above ``md.engine.CHUNK_SWITCH_ROWS`` grid rows, chunk by chunk and
geometry-fused (the geom pair, ``_ChunkedConvFn``) when every
convolution can. A layer the kernels refuse runs the plain chain
(``conv_routes``); ``use_kernels=False`` runs every layer so. A brick's
kernels launch under ``torch.cuda.device(its device)``.

Physics as the JAX engine: one global Nose-Hoover thermostat (kinetic
energy summed over the bricks, degrees of freedom of the real atoms), the
stress as the strain derivative of the energy summed over the bricks
(``-virial / V``, Voigt xx yy zz xy yz zx, reference
pair_e3gnn_parallel.cpp:479-503); the energy and the virial are summed in
float64. Edge vectors along axes the mesh does not decompose take the
minimum image (``BrickSpec.mic_axes``).

``device_rebuild`` migrates atoms and rebuilds halos and grids on the
devices at every chunk (``devrebuild.py``); a capacity overflow falls back
to one host re-decomposition with fresh margins and retries the chunk
(``comm_stats()['host_redecompositions']``).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _keys as KEY
from ..data.graph import Atoms
from ..data.periodic import atomic_masses
from ..md.engine import CHUNK_ROWS, CHUNK_SWITCH_ROWS
from ..md.units import fs as FS
from ..md.units import kB
from ..model.layers import IrrepsConvolution, geom_packed_ok
from ..ops.fused_conv import USE_KERNELS_KEY
from ..ops.scatter import gather_pair
from .brick import check_mic_width, decompose_brick
from .devrebuild import (
    BrickView,
    LocalState,
    _mesh_index,
    device_rebuild,
    make_geom,
)

Tensor = torch.Tensor
ENSEMBLES = ('nve', 'nvt')


class BrickMolecularDynamics:
    """NVE / NVT MD over a K-axis brick mesh with staged halos and the
    dense-grid path per brick. mesh_shape: (P0[, P1[, P2]])."""

    def __init__(
        self,
        model,
        atoms: Atoms,
        mesh_shape: Tuple[int, ...],
        axes: Optional[Tuple[int, ...]] = None,
        dt_fs: float = 2.0,
        temperature_K: float = 300.0,
        ensemble: str = 'nvt',
        tdamp_fs: Optional[float] = None,
        skin: float = 1.0,
        rebuild_every: int = 10,
        seed: int = 0,
        device_rebuild: bool = True,
        cap_margin: float = 1.25,
        conv_chunk_rows: Optional[int] = None,
        devices=None,
        use_kernels: bool = True,
    ):
        """device_rebuild: migrate atoms and rebuild halos and grids on the
        devices at every chunk (the LAMMPS exchange()/borders() analog);
        False re-decomposes on the host between chunks (also the fallback
        when a capacity overflows). cap_margin: the capacities' headroom.
        conv_chunk_rows: grid rows per convolution chunk (None: chunked
        above ``CHUNK_SWITCH_ROWS`` rows, 0: never), rounded down to whole
        atoms. devices: the torch devices of the bricks (brick b on
        ``devices[b % len(devices)]``); None is the current card and raises
        without one. use_kernels: False runs every convolution as the plain
        chain (the serial engine's switch)."""
        if ensemble not in ENSEMBLES:
            raise ValueError(f'ensemble {ensemble!r}: one of {ENSEMBLES}')
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError('BrickMolecularDynamics: no CUDA device; '
                                   "pass devices=['cpu'] for the CPU")
            devices = [torch.device('cuda', torch.cuda.current_device())]
        devices = [torch.device(d) for d in devices]
        self.mesh_shape = tuple(int(p) for p in mesh_shape)
        K = len(self.mesh_shape)
        self.n_dev = int(np.prod(self.mesh_shape))
        self.brick_device = [devices[b % len(devices)]
                             for b in range(self.n_dev)]
        self._models = {}
        for d in self.brick_device:
            if d not in self._models:
                self._models[d] = (model.to(d) if not self._models
                                   else copy.deepcopy(model).to(d))
        self.model = self._models[self.brick_device[0]]
        self.device = self.brick_device[0]
        self.dtype = torch.float32
        self.use_kernels = bool(use_kernels)
        self.atoms = atoms
        self.cutoff = float(model.cutoff)
        self.build_cutoff = self.cutoff + skin
        self.dt = dt_fs * FS
        self.temperature_K = temperature_K
        self.ensemble = ensemble
        self.tdamp = (tdamp_fs or 50.0 * dt_fs) * FS
        self.rebuild_every = rebuild_every
        self.seed = seed
        self.axes = tuple(axes) if axes is not None else tuple(range(K))
        self.time_steps = 0
        cell = np.asarray(atoms.cell, np.float64)
        self.volume = float(abs(np.linalg.det(cell)))
        self.n_dof = 3 * len(atoms)
        self.device_rebuild = bool(device_rebuild)
        self._conv_chunk_rows_arg = conv_chunk_rows
        self.cap_margin = float(cap_margin)
        self.host_rebuilds = 0           # host re-decompositions between
        self.host_redecompositions = 0   # chunks / after an overflow
        self._geom_ok = geom_packed_ok(self.model)
        # the bricks above and below each brick along each mesh dim
        self._nbr = [[self._flat_nbrs(b, k) for b in range(self.n_dev)]
                     for k in range(K)]
        self._xi = torch.zeros((), dtype=self.dtype, device=self.device)
        check_mic_width(cell, self.mesh_shape, self.axes, self.build_cutoff)
        self.spec = decompose_brick(atoms, self.mesh_shape,
                                    self.build_cutoff, axes=self.axes,
                                    cap_margin=self.cap_margin)
        # per brick (cell, inverse, axis mask) of the minimum image along
        # the undecomposed axes; None when the mesh decomposes all three
        self._mic = None
        if self.spec.mic_axes:
            m = np.zeros(3)
            m[list(self.spec.mic_axes)] = 1.0
            self._mic = [tuple(torch.as_tensor(a, dtype=self.dtype, device=d)
                               for a in (cell, np.linalg.inv(cell), m))
                         for d in self.brick_device]
        self._push_state(init_velocities=True)

    # -- mesh ------------------------------------------------------------
    def _flat_nbrs(self, b: int, k: int) -> Tuple[int, int]:
        mesh = self.mesh_shape
        coords = [_mesh_index(b, kk, mesh) for kk in range(len(mesh))]

        def flat(ik):
            c = list(coords)
            c[k] = ik % mesh[k]
            f = 0
            for ci, P in zip(c, mesh):
                f = f * P + ci
            return f

        return flat(coords[k] + 1), flat(coords[k] - 1)

    def _ctx(self, b: int):
        """Brick b's device as the current one (its kernels launch there)."""
        d = self.brick_device[b]
        return (torch.cuda.device(d) if d.type == 'cuda'
                else contextlib.nullcontext())

    # -- host <-> device -------------------------------------------------
    def _push_state(self, init_velocities=False, vel_global=None):
        """Bricks' tensors from ``self.spec`` (velocities drawn as the JAX
        engine draws them, or taken from vel_global by atom id)."""
        spec, f32 = self.spec, self.dtype
        masses = np.asarray(atomic_masses)[spec.z] * (spec.loc_mask > 0)
        masses = masses + (spec.loc_mask == 0)
        ids = np.full((self.n_dev, spec.cap_loc), -1, dtype=np.int64)
        off = 0
        for d in range(self.n_dev):
            m = int(spec.n_loc[d])
            ids[d, :m] = spec.owner_perm[off:off + m]
            off += m
        if init_velocities:
            rng = np.random.default_rng(self.seed)
            vel = rng.normal(size=spec.pos.shape) * np.sqrt(
                kB * self.temperature_K / masses)[..., None]
            vel = vel * spec.loc_mask[..., None]
        else:
            vel = np.where((ids >= 0)[..., None],
                           np.asarray(vel_global)[np.maximum(ids, 0)], 0.0)

        def put(a, b, dtype=f32):
            return torch.as_tensor(a[b], dtype=dtype,
                                   device=self.brick_device[b])

        D = self.n_dev
        self.local = [LocalState(
            pos=put(spec.pos, b), vel=put(vel, b),
            forces=torch.zeros((spec.cap_loc, 3), dtype=f32,
                               device=self.brick_device[b]),
            z=put(spec.z, b, torch.long), ids=put(ids, b, torch.long),
            loc_mask=put(spec.loc_mask, b)) for b in range(D)]
        self._set_views([BrickView(
            send_idx=tuple(put(a, b, torch.long) for a in spec.send_idx),
            send_mask=tuple(put(a, b) for a in spec.send_mask),
            shift=tuple(put(a, b) for a in spec.shift),
            edge_idx=put(spec.edge_idx, b, torch.long),
            edge_mask=put(spec.edge_mask, b),
            edge_rev=put(spec.edge_rev, b, torch.long)) for b in range(D)])
        self._initialized = False
        self._dev_dirty = False

    def _set_views(self, views: List[BrickView]):
        """Install the bricks' views and what follows from them alone:
        the view's atomic numbers, node masks, masses."""
        self.views = views
        z_all = self._refresh([s.z.to(self.dtype)[:, None]
                               for s in self.local])
        self._z_all = [torch.round(z[:, 0]).long() for z in z_all]
        cap_g = self.spec.cap_all - self.spec.cap_loc
        self._node_mask = [torch.cat([s.loc_mask, s.loc_mask.new_zeros(
            cap_g)]) for s in self.local]
        am = torch.as_tensor(np.asarray(atomic_masses), dtype=self.dtype)
        self.masses = [am.to(s.z.device)[s.z] * s.loc_mask
                       + (1.0 - s.loc_mask) for s in self.local]

    @property
    def pos(self) -> List[Tensor]:
        return [s.pos for s in self.local]

    @property
    def vel(self) -> List[Tensor]:
        return [s.vel for s in self.local]

    @property
    def ids(self) -> List[Tensor]:
        return [s.ids for s in self.local]

    @property
    def loc_mask(self) -> List[Tensor]:
        return [s.loc_mask for s in self.local]

    def gather_global(self):
        """(pos, vel) in the original atom order, by the atom ids each
        brick carries (valid after on-device migration)."""
        n = len(self.atoms)
        gp, gv = np.zeros((n, 3)), np.zeros((n, 3))
        for s in self.local:
            ok = (s.loc_mask > 0).cpu().numpy()
            ids = s.ids.cpu().numpy()[ok]
            gp[ids] = s.pos.detach().cpu().numpy()[ok]
            gv[ids] = s.vel.detach().cpu().numpy()[ok]
        return gp, gv

    # -- halo ------------------------------------------------------------
    def _refresh(self, xs: List[Tensor], shifts: bool = False) -> List[Tensor]:
        """Every brick's view from its first cap_loc rows: K phases, phase
        k's lo slots from the brick above's side-0 sends, its hi slots from
        the brick below's side-1 sends (the JAX ``_staged_refresh_fn``).
        shifts: add the image shifts (positions). Autograd of the copies is
        the reverse exchange."""
        cap_loc = self.spec.cap_loc
        cur = [x[:cap_loc] for x in xs]
        for k in range(len(self.mesh_shape)):
            sends = []
            for b, v in enumerate(self.views):
                si, sm = v.send_idx[k], v.send_mask[k]
                s = cur[b][si.reshape(-1)] * sm.reshape(-1, 1)
                if shifts:
                    s = s + (v.shift[k] * sm[..., None]).reshape(-1, 3)
                sends.append(s.reshape((2, si.shape[1]) + s.shape[1:]))
            new = []
            for b in range(self.n_dev):
                dev = self.brick_device[b]
                hi, lo = self._nbr[k][b]
                new.append(torch.cat([cur[b], sends[hi][0].to(dev),
                                      sends[lo][1].to(dev)]))
            cur = new
        return cur

    # -- energy, forces, stress --------------------------------------------
    @property
    def conv_chunk_rows(self) -> int:
        """0 = whole-array convolution per brick; else the grid rows per
        chunk, whole atoms (the serial engine's switch and chunk size)."""
        deg = self.spec.deg_cap
        if self._conv_chunk_rows_arg is not None:
            rows = int(self._conv_chunk_rows_arg)
            if rows <= 0:
                return 0
        elif self.spec.rows > CHUNK_SWITCH_ROWS:
            rows = CHUNK_ROWS
        else:
            return 0
        return max(1, rows // deg) * deg

    def conv_routes(self) -> List[Dict]:
        """Each convolution's route on the bricks' grid (``SevenNetModel.
        conv_routes`` at the grid degree)."""
        return self.model.conv_routes(self.spec.deg_cap, self.use_kernels)

    def _brick_data(self, b: int, pos_all: Tensor, strain) -> Dict:
        spec, v = self.spec, self.views[b]
        deg = spec.deg_cap
        pi, pj = gather_pair(pos_all, v.edge_idx, v.edge_rev, deg)
        vec = pj - pi
        if self._mic is not None:
            cell, inv, m = self._mic[b]
            g = vec @ inv
            vec = (g - torch.round(g) * m) @ cell
        r2 = torch.sum(vec * vec, dim=-1)
        mask = (v.edge_mask > 0) & (r2 < self.cutoff ** 2)
        safe = torch.where(mask[:, None], vec, vec.new_tensor([1.0, 0.0,
                                                                0.0]))
        if strain is not None:
            safe = safe + safe @ strain
        chunk_rows = self.conv_chunk_rows
        cap_all = spec.cap_all
        dev = pos_all.device
        return {
            KEY.ATOMIC_NUMBERS: self._z_all[b],
            KEY.EDGE_IDX: v.edge_idx,
            KEY.EDGE_REV: v.edge_rev,
            KEY.EDGE_DENSE_D: deg,
            KEY.BATCH: torch.zeros(cap_all, dtype=torch.long, device=dev),
            KEY.NUM_ATOMS: torch.tensor([cap_all], device=dev),
            KEY.NODE_MASK: self._node_mask[b],
            KEY.EDGE_VEC: safe,
            KEY.EDGE_MASK: mask.to(safe.dtype),
            KEY.CONV_CHUNK_ROWS: chunk_rows,
            KEY.EDGE_GEOM_PACKED: bool(chunk_rows) and self.use_kernels
            and self._geom_ok,
            USE_KERNELS_KEY: self.use_kernels,
        }

    def _energy(self, pos_loc: List[Tensor], strains) -> Tensor:
        """The total energy (float64, on brick 0's device): positions
        refreshed, then one model walk a brick in lockstep, the node
        features refreshed before every convolution."""
        pos_all = self._refresh(pos_loc, shifts=True)
        walks, xs = [], []
        for b in range(self.n_dev):
            with self._ctx(b):
                data = self._brick_data(b, pos_all[b],
                                        None if strains is None
                                        else strains[b])
                walk = self._models[self.brick_device[b]].walk(data)
                walks.append(walk)
        outs = [None] * self.n_dev
        while True:
            nxt = []
            for b, walk in enumerate(walks):
                with self._ctx(b):
                    try:
                        nxt.append(walk.send(xs[b] if xs else None))
                    except StopIteration as done:
                        outs[b] = done.value
            if outs[0] is not None:
                break
            xs = self._refresh(nxt)
        e = 0.0
        for b, out in enumerate(outs):
            e_b = (out[KEY.ATOMIC_ENERGY][..., 0].double()
                   * self._node_mask[b].double()).sum()
            e = e + e_b.to(self.device)
        return e

    def _efs(self, pos_loc: List[Tensor], stress: bool = False):
        """(E float64, forces per brick (pad rows zero), stress Voigt or
        None)."""
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in pos_loc]
            strains = None
            if stress:
                strains = [torch.zeros((3, 3), dtype=self.dtype, device=d,
                                       requires_grad=True)
                           for d in self.brick_device]
            e = self._energy(leaves, strains)
            grads = torch.autograd.grad(e, leaves + (strains or []))
        forces = [-g * s.loc_mask[:, None]
                  for g, s in zip(grads, self.local)]
        s_out = None
        if stress:
            v = sum(g.double().to(self.device) for g in grads[self.n_dev:])
            s_out = -torch.stack([v[0, 0], v[1, 1], v[2, 2], v[0, 1],
                                  v[1, 2], v[2, 0]]) / self.volume
        return e.detach(), forces, s_out

    def energy_forces(self, return_stress: bool = False):
        """(E, F (n, 3) in the original atom order[, stress Voigt]) as
        numpy, at the current positions."""
        if self._dev_dirty:
            # the host spec is stale after on-device chunks
            self._rebuild()
        e, forces, s = self._efs(self.pos, return_stress)
        fg = np.zeros((len(self.atoms), 3))
        for f, st in zip(forces, self.local):
            ok = (st.loc_mask > 0).cpu().numpy()
            fg[st.ids.cpu().numpy()[ok]] = f.cpu().numpy()[ok]
        if return_stress:
            return float(e), fg, s.cpu().numpy()
        return float(e), fg

    # -- integrator --------------------------------------------------------
    def _kinetic2(self, vel: List[Tensor]) -> Tensor:
        """sum m v^2 over every brick (float32, as the JAX psum)."""
        return sum(torch.sum(m[:, None] * v * v).to(self.device)
                   for m, v in zip(self.masses, vel))

    def _thermo_half(self, vel, xi):
        """A half step of the one global Nose-Hoover thermostat."""
        q = self.n_dof * kB * self.temperature_K * self.tdamp ** 2
        xi_dot = (self._kinetic2(vel)
                  - self.n_dof * kB * self.temperature_K) / q
        xi = xi + 0.5 * self.dt * xi_dot
        return [v * torch.exp(-0.5 * self.dt * xi).to(v.device)
                for v in vel], xi

    def _step(self, forces, want_stress: bool):
        """One velocity-Verlet step of every brick (Nose-Hoover under
        'nvt'): (energy, stress or None); the local states advance."""
        dt = self.dt
        vel = self.vel
        xi = self._xi
        if self.ensemble == 'nvt':
            vel, xi = self._thermo_half(vel, xi)
        inv_m = [(1.0 / m)[:, None] for m in self.masses]
        v_half = [v + 0.5 * dt * f * im
                  for v, f, im in zip(vel, forces, inv_m)]
        pos = [p + dt * vh for p, vh in zip(self.pos, v_half)]
        e, forces, stress = self._efs(pos, want_stress)
        vel = [vh + 0.5 * dt * f * im
               for vh, f, im in zip(v_half, forces, inv_m)]
        if self.ensemble == 'nvt':
            vel, xi = self._thermo_half(vel, xi)
        self._xi = xi
        self.local = [s._replace(pos=p, vel=v * s.loc_mask[:, None],
                                 forces=f)
                      for s, p, v, f in zip(self.local, pos, vel, forces)]
        return e, stress

    def _chunk(self, length: int) -> Dict[str, float]:
        """length steps from the local states' forces; the last step also
        takes the stress (the JAX chunk's closing force call)."""
        e = stress = None
        for i in range(length):
            e, stress = self._step(self.forces, i == length - 1)
        temp = self._kinetic2(self.vel) / (self.n_dof * kB)
        return {'energy': float(e), 'temperature': float(temp),
                'stress': stress.cpu().numpy(), 'steps': length}

    @property
    def forces(self) -> List[Tensor]:
        return [s.forces for s in self.local]

    def _prime(self):
        """Forces at the current positions into the local states."""
        _, forces, _ = self._efs(self.pos)
        self.local = [s._replace(forces=f)
                      for s, f in zip(self.local, forces)]
        self._initialized = True

    def run(self, n_steps: int) -> Dict[str, np.ndarray]:
        """Advance exactly n_steps; per chunk: energy, temperature, stress
        (Voigt, eV/A^3) and steps."""
        rows = []
        done = retries = 0
        while done < n_steps:
            length = min(self.rebuild_every, n_steps - done)
            if self.device_rebuild:
                if not self._initialized:
                    self._prime()
                if not self._device_rebuild():
                    retries += 1
                    if retries > 8:
                        raise RuntimeError(
                            'device rebuild: capacity overflow persists '
                            'after repeated host re-decompositions')
                    self._rebuild(fresh=True)
                    continue
                retries = 0
                self._dev_dirty = True
            else:
                # the host path re-primes every chunk (its spec is new)
                self._prime()
            rows.append(self._chunk(length))
            done += length
            self.time_steps += length
            if not self.device_rebuild and done < n_steps:
                self._rebuild()
        return {k: np.array([r[k] for r in rows]) for k in
                ('energy', 'temperature', 'stress', 'steps')} if rows else {}

    def _device_rebuild(self) -> bool:
        """Migrate and rebuild on the devices; False (state untouched) on a
        capacity overflow. The one host read of a chunk: the flag."""
        geom = getattr(self, '_geom', None)
        if geom is None or geom[0] is not self.spec:
            self._geom = geom = (self.spec, make_geom(
                self.spec, np.asarray(self.spec.cell), self.build_cutoff))
        local, views, overflow = device_rebuild(
            geom[1], np.asarray(self.spec.cell), self.build_cutoff,
            self.local, self._nbr, self.brick_device)
        if bool(overflow):
            return False
        self.local = local
        self._set_views(views)
        return True

    def _rebuild(self, fresh: bool = False):
        """Host rebin and fresh index maps, capacities kept while they fit;
        fresh=True derives every capacity anew with margins (the overflow
        fallback). Forces are primed again before the next step."""
        gp, gv = self.gather_global()
        self.atoms = Atoms(atomic_numbers=self.atoms.atomic_numbers, pos=gp,
                           cell=self.atoms.cell, pbc=self.atoms.pbc)
        self.spec = decompose_brick(
            self.atoms, self.mesh_shape, self.build_cutoff, axes=self.axes,
            prev=None if fresh else self.spec,
            cap_margin=(max(self.cap_margin, 1.25) if fresh
                        else self.cap_margin))
        if fresh:
            self.host_redecompositions += 1
        else:
            self.host_rebuilds += 1
        self._push_state(vel_global=gv)

    # -- accounting ------------------------------------------------------
    def comm_stats(self) -> Dict:
        """Halo accounting (the reference's SEVENN_PRINT_INFO comm dumps,
        pair_e3gnn_parallel.cpp:87-93,441-455,807-815): occupancy, send
        counts per phase and side, the capacity-padded payload of each
        refresh, and the host re-decompositions.

        A force call refreshes positions once and each convolution's
        features once forward; the backward replays the feature exchanges
        in reverse, so a force call (one MD step) moves ``bytes_force_call``
        per brick, ``bytes_step`` over all bricks."""
        spec = self.spec
        widths = [int(layer.tp.irreps_in1.dim)
                  for layer in self.model.layers.values()
                  if isinstance(layer, IrrepsConvolution)]
        sends = [[[int(s) for s in v.send_mask[k].sum(1).tolist()]
                  for v in self.views] for k in range(len(self.mesh_shape))]
        item = 4
        per_phase_pos = [2 * cg * 3 * item for cg in spec.cap_g]
        per_phase_feat = [[2 * cg * w * item for w in widths]
                          for cg in spec.cap_g]
        bytes_pos = sum(per_phase_pos)
        bytes_feat = sum(sum(p) for p in per_phase_feat)
        n_loc = [int(s.loc_mask.sum()) for s in self.local]
        return dict(
            mesh=list(self.mesh_shape), n_devices=self.n_dev,
            devices=[str(d) for d in self.brick_device],
            cap_loc=int(spec.cap_loc), cap_g=[int(c) for c in spec.cap_g],
            cap_all=int(spec.cap_all), deg_cap=int(spec.deg_cap),
            rows=int(spec.rows), n_loc=n_loc, sends_per_phase=sends,
            layer_widths=widths, bytes_per_phase_feat=per_phase_feat,
            bytes_pos_refresh=bytes_pos, bytes_feat_refresh_fwd=bytes_feat,
            bytes_force_call=bytes_pos + 2 * bytes_feat,
            bytes_step=self.n_dev * (bytes_pos + 2 * bytes_feat),
            host_rebuilds=self.host_rebuilds,
            host_redecompositions=self.host_redecompositions)
