"""The one generator of the benchmark's inputs. A traffic mix is a JSON
file of parameters (``portbench/traffic/<mix>.json``); from it and the
seed this module makes the structure and the initial velocities that the
program is handed. Every seed gets the same sizes: the seed moves the
rattle and the velocities, never the amount of work."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

import numpy as np

from ..reference.integrate import KB, MASSES

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# rocksalt NaCl: the conventional cell's eight sites (Na, then Cl)
_SITES = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5],
                   [0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [0.5, 0.5, 0.5]])
_Z = [11, 11, 11, 11, 17, 17, 17, 17]


def load(mix: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, 'traffic', f'{mix}.json')) as fh:
        return json.load(fh)


def rng(seed: int, stream: int) -> np.random.Generator:
    """Independent streams of one seed (any non-negative integer)."""
    return np.random.default_rng([int(seed), stream])


def rocksalt(reps: int, a: float, rattle: float, gen: np.random.Generator):
    """(Z, positions, cell) of reps^3 conventional cells of lattice
    constant ``a`` (Angstrom), every atom displaced by N(0, rattle^2) per
    axis (the program's ``build_nacl`` layout)."""
    fracs, z = [], []
    for i in range(reps):
        for j in range(reps):
            for k in range(reps):
                fracs.append((_SITES + [i, j, k]) / reps)
                z += _Z
    cell = np.eye(3) * reps * a
    pos = np.concatenate(fracs) @ cell
    pos = pos + gen.normal(scale=rattle, size=pos.shape)
    return np.asarray(z, np.int64), pos, cell


def maxwell_boltzmann(z: np.ndarray, temp_K: float,
                      gen: np.random.Generator) -> np.ndarray:
    """Velocities (Angstrom per internal time unit) at ``temp_K`` with no
    net momentum."""
    m = np.array([MASSES[int(v)] for v in z])
    v = gen.standard_normal((len(z), 3)) * np.sqrt(KB * temp_K / m)[:, None]
    return v - (v * m[:, None]).mean(0) / m.mean()


def md_inputs(mix: Dict[str, Any], seed: int) -> Dict[str, np.ndarray]:
    """The structure and velocities of an MD mix for one seed."""
    s = mix['structure']
    z, pos, cell = rocksalt(int(s['reps']), float(s['a_A']),
                            float(s['rattle_A']), rng(seed, 0))
    vel = maxwell_boltzmann(z, float(mix['temperature_K']), rng(seed, 1))
    return {'z': z, 'pos': pos, 'cell': cell, 'vel': vel}


def read_extxyz(path: str):
    """Structures of an extended-XYZ file with energy, forces and stress
    labels; the stress as the program takes it: the file's 3 x 3 negated
    into Voigt xx yy zz xy yz zx (eV/A^3)."""
    import shlex
    out = []
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i])
        info = dict(kv.split('=', 1) for kv in shlex.split(lines[i + 1]))
        rows = [ln.split() for ln in lines[i + 2:i + 2 + n]]
        i += 2 + n
        s = -np.array(info['stress'].split(), np.float64).reshape(3, 3)
        out.append({
            'z': np.array([{'Na': 11, 'Cl': 17}[r[0]] for r in rows]),
            'pos': np.array([r[1:4] for r in rows], np.float64),
            'forces': np.array([r[4:7] for r in rows], np.float64),
            'cell': np.array(info['Lattice'].split(),
                             np.float64).reshape(3, 3),
            'energy': float(info['energy']),
            'stress': np.array([s[0, 0], s[1, 1], s[2, 2], s[0, 1], s[1, 2],
                                s[2, 0]]),
        })
    return out


def train_inputs(mix: Dict[str, Any], seed: int, root: str):
    """The dataset's structures and the order the seed draws them in."""
    path = os.path.join(root, mix['dataset'])
    with open(path, 'rb') as fh:
        if hashlib.sha256(fh.read()).hexdigest() != mix['dataset_sha256']:
            raise RuntimeError(f"{mix['dataset']}: not the dataset this mix "
                               'names (sha256 differs)')
    structs = read_extxyz(path)
    order = rng(seed, 2).permutation(len(structs))
    return structs, order
