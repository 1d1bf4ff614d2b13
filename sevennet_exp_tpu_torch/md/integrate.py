"""Integrators in torch: NVE velocity Verlet, Langevin BAOAB, Nose-Hoover
NVT, and NPT (Nose-Hoover + Berendsen barostat, isotropic and full-cell).

Counterpart of ``sevennet_exp_tpu/md/integrate.py`` (``MDState``,
``maxwell_boltzmann``, ``make_nve_step``, ``make_langevin_step``,
``make_nose_hoover_step``, ``make_npt_berendsen_step``,
``voigt_to_tensor``, ``make_npt_berendsen_aniso_step``).
Units: eV / Angstrom / amu; dt in internal units (md/units.py).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from .neighbor import det3
from .units import kB

Tensor = torch.Tensor


class MDState(NamedTuple):
    pos: Tensor      # (N, 3)
    vel: Tensor      # (N, 3) internal units
    forces: Tensor   # (N, 3) eV/A
    energy: Tensor   # () eV
    xi: Tensor       # () thermostat friction (Nose-Hoover)
    cell: Optional[Tensor] = None   # (3, 3) evolving cell (NPT only; None =
    #                                 the engine's static cell)


def kinetic_energy(state: MDState, masses: Tensor) -> Tensor:
    return 0.5 * torch.sum(masses[:, None] * state.vel ** 2)


def temperature(state: MDState, masses: Tensor) -> Tensor:
    n_dof = 3 * state.pos.shape[0]
    return 2.0 * kinetic_energy(state, masses) / (n_dof * kB)


def maxwell_boltzmann(generator: torch.Generator, masses: Tensor,
                      temp_K: float) -> Tensor:
    """Velocities at temp_K with zero total momentum; drawn on the
    generator's device."""
    n = masses.shape[0]
    v = torch.randn((n, 3), generator=generator, dtype=masses.dtype,
                    device=masses.device)
    v = v * torch.sqrt(kB * temp_K / masses)[:, None]
    return v - torch.mean(v * masses[:, None], dim=0) / torch.mean(masses)


def make_nve_step(ef_fn: Callable, masses: Tensor, dt: float):
    """ef_fn(pos, nl) -> (energy, forces)."""
    inv_m = (1.0 / masses)[:, None]

    def step(state: MDState, nl) -> MDState:
        v_half = state.vel + 0.5 * dt * state.forces * inv_m
        pos = state.pos + dt * v_half
        energy, forces = ef_fn(pos, nl)
        vel = v_half + 0.5 * dt * forces * inv_m
        return state._replace(pos=pos, vel=vel, forces=forces,
                              energy=energy)

    return step


def make_langevin_step(ef_fn: Callable, masses: Tensor, dt: float,
                       temp_K: float, friction: float,
                       generator: torch.Generator):
    """BAOAB Langevin; friction in 1/internal-time. The noise comes from
    ``generator`` (on the state's device), never from the global RNG."""
    inv_m = (1.0 / masses)[:, None]
    c1 = math.exp(-friction * dt)
    sigma = torch.sqrt(kB * temp_K * (1 - c1 ** 2) / masses)[:, None]

    def step(state: MDState, nl) -> MDState:
        v = state.vel + 0.5 * dt * state.forces * inv_m          # B
        pos = state.pos + 0.5 * dt * v                           # A
        noise = torch.randn(v.shape, generator=generator, dtype=v.dtype,
                            device=v.device)
        v = c1 * v + sigma.to(v.dtype) * noise                   # O
        pos = pos + 0.5 * dt * v                                 # A
        energy, forces = ef_fn(pos, nl)
        v = v + 0.5 * dt * forces * inv_m                        # B
        return state._replace(pos=pos, vel=v, forces=forces, energy=energy)

    return step


def _thermo_half(masses: Tensor, dt: float, temp_K: float, tdamp: float):
    """Half step of a single Nose-Hoover thermostat: (vel, xi) ->
    (vel, xi)."""
    n_dof = 3 * masses.shape[0]
    Q = n_dof * kB * temp_K * tdamp ** 2

    def thermo_half(vel, xi):
        ke2 = torch.sum(masses[:, None] * vel ** 2)
        xi_dot = (ke2 - n_dof * kB * temp_K) / Q
        xi = xi + 0.5 * dt * xi_dot
        return vel * torch.exp(-0.5 * dt * xi), xi

    return thermo_half


def make_nose_hoover_step(ef_fn: Callable, masses: Tensor, dt: float,
                          temp_K: float, tdamp: float):
    """Single Nose-Hoover thermostat (LAMMPS ``fix nvt``, chain of 1)."""
    inv_m = (1.0 / masses)[:, None]
    thermo_half = _thermo_half(masses, dt, temp_K, tdamp)

    def step(state: MDState, nl) -> MDState:
        vel, xi = thermo_half(state.vel, state.xi)
        v_half = vel + 0.5 * dt * state.forces * inv_m
        pos = state.pos + dt * v_half
        energy, forces = ef_fn(pos, nl)
        vel = v_half + 0.5 * dt * forces * inv_m
        vel, xi = thermo_half(vel, xi)
        return state._replace(pos=pos, vel=vel, forces=forces,
                              energy=energy, xi=xi)

    return step


def make_npt_berendsen_step(efs_fn: Callable, masses: Tensor, dt: float,
                            temp_K: float, tdamp: float,
                            press_target: float, pdamp: float,
                            compressibility: float = 4.57e-5):
    """Isotropic NPT: Nose-Hoover thermostat + Berendsen barostat (the
    LAMMPS ``fix nvt`` + ``fix press/berendsen`` recipe).

    efs_fn(pos, nl, cell) -> (energy, forces, stress_voigt), the stress in
    the model convention (-virial/V, eV/A^3). press_target in eV/A^3; only
    the ratio dt * compressibility / pdamp sets the relaxation rate.
    Internal pressure: P = 2 KE / (3 V) + trace(stress) / 3 (the model
    stress already carries -virial/V, so its trace/3 is the potential
    pressure)."""
    inv_m = (1.0 / masses)[:, None]
    thermo_half = _thermo_half(masses, dt, temp_K, tdamp)

    def step(state: MDState, nl) -> MDState:
        vel, xi = thermo_half(state.vel, state.xi)
        v_half = vel + 0.5 * dt * state.forces * inv_m
        pos = state.pos + dt * v_half
        energy, forces, stress = efs_fn(pos, nl, state.cell)
        vel = v_half + 0.5 * dt * forces * inv_m
        vel, xi = thermo_half(vel, xi)
        vol = torch.abs(det3(state.cell))
        ke2 = torch.sum(masses[:, None] * vel ** 2)
        p_int = ke2 / (3.0 * vol) + (stress[0] + stress[1] + stress[2]) / 3.0
        mu = (1.0 - dt / pdamp * compressibility
              * (press_target - p_int)) ** (1.0 / 3.0)
        return state._replace(pos=pos * mu, vel=vel, forces=forces,
                              energy=energy, xi=xi, cell=state.cell * mu)

    return step


def voigt_to_tensor(s: Tensor) -> Tensor:
    """(6,) Voigt xx yy zz xy yz zx (model convention) -> symmetric
    (3, 3)."""
    return torch.stack([
        torch.stack([s[0], s[3], s[5]]),
        torch.stack([s[3], s[1], s[4]]),
        torch.stack([s[5], s[4], s[2]]),
    ])


def make_npt_berendsen_aniso_step(efs_fn: Callable, masses: Tensor,
                                  dt: float, temp_K: float, tdamp: float,
                                  press_target, pdamp: float,
                                  compressibility: float = 4.57e-5):
    """Anisotropic (full-cell / triclinic) NPT: Nose-Hoover thermostat +
    tensor Berendsen barostat (LAMMPS ``fix press/berendsen`` with
    ``couple none`` + tilt semantics). Each step applies the symmetric strain

        mu = I - dt * compressibility / (3 * pdamp) * (P_t - P_int)

    to cell rows and positions (rows @ mu): the linearisation of the
    isotropic formula, so on an isotropically stressed cubic cell the two
    ensembles agree to O(dP^2). press_target: scalar (hydrostatic) or
    (3, 3) tensor in eV/A^3. P_int = sum(m v (x) v) / V + the model stress
    tensor."""
    inv_m = (1.0 / masses)[:, None]
    thermo_half = _thermo_half(masses, dt, temp_K, tdamp)
    p_t = torch.as_tensor(press_target, dtype=masses.dtype,
                          device=masses.device)
    if p_t.ndim == 0:
        p_t = p_t * torch.eye(3, dtype=masses.dtype, device=masses.device)

    def step(state: MDState, nl) -> MDState:
        vel, xi = thermo_half(state.vel, state.xi)
        v_half = vel + 0.5 * dt * state.forces * inv_m
        pos = state.pos + dt * v_half
        energy, forces, stress = efs_fn(pos, nl, state.cell)
        vel = v_half + 0.5 * dt * forces * inv_m
        vel, xi = thermo_half(vel, xi)
        vol = torch.abs(det3(state.cell))
        p_kin = torch.einsum('ni,n,nj->ij', vel, masses, vel) / vol
        p_int = p_kin + voigt_to_tensor(stress)
        eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
        mu = eye - (dt * compressibility / (3.0 * pdamp)) * (
            p_t - p_int).to(pos.dtype)
        mu = 0.5 * (mu + mu.T)     # keep the strain exactly symmetric
        return state._replace(pos=pos @ mu, vel=vel, forces=forces,
                              energy=energy, xi=xi, cell=state.cell @ mu)

    return step
