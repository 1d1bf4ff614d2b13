"""One Nose-Hoover NVT step (a single thermostat, LAMMPS ``fix nvt`` with a
chain of one) in eV / Angstrom / amu, the internal time unit being
Angstrom sqrt(amu / eV)."""

from __future__ import annotations

import torch

KB = 8.617330337217213e-05      # eV / K
FS = 0.09822694750253721        # internal time units per femtosecond
# atomic masses (amu) by atomic number, of the elements the cells use
MASSES = {11: 22.98976928, 17: 35.45}


def masses(z, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor([MASSES[int(v)] for v in z], dtype=dtype,
                           device=device)


def nose_hoover_step(pos, vel, forces, xi, m, dt_fs: float, temp_K: float,
                     tdamp_fs: float, force_fn):
    """(pos, vel, xi, energy, forces) one step on from (pos, vel, forces,
    xi); force_fn(pos) -> (energy, forces) at the new positions."""
    dt, tdamp = dt_fs * FS, tdamp_fs * FS
    n_dof = 3 * m.shape[0]
    q = n_dof * KB * temp_K * tdamp ** 2
    inv_m = (1.0 / m)[:, None]

    def thermo_half(v, x):
        ke2 = torch.sum(m[:, None] * v ** 2)
        x = x + 0.5 * dt * (ke2 - n_dof * KB * temp_K) / q
        return v * torch.exp(-0.5 * dt * x), x

    v, xi = thermo_half(vel, xi)
    v_half = v + 0.5 * dt * forces * inv_m
    pos = pos + dt * v_half
    energy, f_new = force_fn(pos)
    v = v_half + 0.5 * dt * f_new * inv_m
    v, xi = thermo_half(v, xi)
    return pos, v, xi, energy, f_new
