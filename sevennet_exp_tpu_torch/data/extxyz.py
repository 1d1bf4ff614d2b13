"""Extended-XYZ reader/writer (replaces ase.io for the common case).

Copy of ``sevennet_exp_tpu/data/extxyz.py`` on the port's ``Atoms``, kept
here so the PyTorch port imports nothing of the JAX package.

Supports the subset the reference datasets use (tests/data/systems/
hfo2.extxyz): Lattice, Properties=species/pos/forces, energy/free_energy,
stress (9 or 6 component), pbc. Energy/force/stress label conventions
follow reference sevenn/train/dataload.py:303-351 (_set_atoms_y):
free_energy preferred, stress negated into eV/A^3 Voigt
(xx, yy, zz, xy, yz, zx).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List

import numpy as np

from .graph import Atoms
from .periodic import atomic_numbers, chemical_symbols


def _parse_info_line(line: str) -> Dict[str, str]:
    out = {}
    for m in re.finditer(
        r'(\S+?)=(?:"([^"]*)"|(\S+))', line
    ):
        key = m.group(1)
        val = m.group(2) if m.group(2) is not None else m.group(3)
        out[key] = val
    return out


def _parse_properties(spec: str):
    """'species:S:1:pos:R:3:forces:R:3' -> [(name, kind, ncols), ...]"""
    parts = spec.split(':')
    props = []
    for i in range(0, len(parts), 3):
        props.append((parts[i], parts[i + 1], int(parts[i + 2])))
    return props


def _stress_to_voigt(vals: np.ndarray) -> np.ndarray:
    """9- or 6-component stress -> reference Voigt order, negated
    (dataload.py:296-297: y_stress = -1 * stress[[0,1,2,5,3,4]] for ASE
    Voigt (xx,yy,zz,yz,xz,xy) input; full 3x3 uses [00,11,22,01,12,20])."""
    vals = np.asarray(vals, dtype=np.float64)
    if vals.size == 9:
        s = vals.reshape(3, 3)
        return -np.array([s[0, 0], s[1, 1], s[2, 2],
                          s[0, 1], s[1, 2], s[2, 0]])
    if vals.size == 6:
        # ASE Voigt (xx, yy, zz, yz, xz, xy)
        return -vals[[0, 1, 2, 5, 3, 4]]
    raise ValueError(f'bad stress shape {vals.shape}')


def iread_extxyz(path: str) -> Iterator[Atoms]:
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                return
            if not line.strip():
                continue
            nat = int(line.strip())
            info = _parse_info_line(f.readline())
            props = _parse_properties(
                info.get('Properties', 'species:S:1:pos:R:3')
            )
            rows = [f.readline().split() for _ in range(nat)]

            col = 0
            data: Dict[str, List] = {}
            for name, kind, ncols in props:
                vals = [r[col:col + ncols] for r in rows]
                col += ncols
                data[name] = vals

            symbols = [v[0] for v in data['species']]
            zs = np.array([atomic_numbers[s] for s in symbols])
            pos = np.array(data['pos'], dtype=np.float64)

            cell = np.zeros((3, 3))
            if 'Lattice' in info:
                cell = np.array(
                    info['Lattice'].split(), dtype=np.float64
                ).reshape(3, 3)
            pbc = np.array([False] * 3)
            if 'pbc' in info:
                pbc = np.array(
                    [t in ('T', 'True', '1') for t in info['pbc'].split()]
                )
            elif np.abs(cell).sum() > 0:
                pbc = np.array([True] * 3)

            energy = None
            for key in ('free_energy', 'energy'):
                if key in info:
                    energy = float(info[key])
                    break
            forces = None
            if 'forces' in data:
                forces = np.array(data['forces'], dtype=np.float64)
            elif 'force' in data:
                forces = np.array(data['force'], dtype=np.float64)
            stress = None
            if 'stress' in info:
                stress = _stress_to_voigt(
                    np.array(info['stress'].split(), dtype=np.float64)
                )

            extra = {
                k: v for k, v in info.items()
                if k not in ('Lattice', 'Properties', 'pbc', 'stress',
                             'energy', 'free_energy')
            }
            yield Atoms(
                atomic_numbers=zs, pos=pos, cell=cell, pbc=pbc,
                energy=energy, forces=forces, stress=stress, info=extra,
            )


def read_extxyz(path: str, index=':') -> List[Atoms]:
    frames = list(iread_extxyz(path))
    if index == ':':
        return frames
    if isinstance(index, int):
        return [frames[index]]
    if isinstance(index, str):
        sl = slice(*[int(x) if x else None for x in index.split(':')])
        return frames[sl]
    return frames[index]


def write_extxyz(path: str, frames: List[Atoms], mode: str = 'w'):
    with open(path, mode) as f:
        for at in frames:
            n = len(at)
            f.write(f'{n}\n')
            parts = []
            if np.abs(at.cell).sum() > 0:
                lat = ' '.join(f'{v:.10g}' for v in at.cell.reshape(-1))
                parts.append(f'Lattice="{lat}"')
            props = 'species:S:1:pos:R:3'
            if at.forces is not None:
                props += ':forces:R:3'
            parts.append(f'Properties={props}')
            if at.energy is not None:
                parts.append(f'energy={at.energy:.10f}')
            if at.stress is not None:
                s = -at.stress  # back to ASE-like sign
                sv = np.array([s[0], s[3], s[5], s[3], s[1], s[4],
                               s[5], s[4], s[2]])
                parts.append(
                    'stress="' + ' '.join(f'{v:.10g}' for v in sv) + '"'
                )
            pbc = ' '.join('T' if b else 'F' for b in at.pbc)
            parts.append(f'pbc="{pbc}"')
            f.write(' '.join(parts) + '\n')
            for i in range(n):
                sym = chemical_symbols[at.atomic_numbers[i]]
                row = f'{sym:3s} ' + ' '.join(
                    f'{v:16.8f}' for v in at.pos[i]
                )
                if at.forces is not None:
                    row += ' ' + ' '.join(
                        f'{v:16.8f}' for v in at.forces[i]
                    )
                f.write(row + '\n')
