"""VASP OUTCAR ionic-step reader + ``structure_list`` ingestion (ASE-free).

Copy of ``sevennet_exp_tpu/data/vasp.py`` on the port's ``Atoms``.

Capability parity with the reference's `structure_list_reader`
(sevenn/train/dataload.py:373-478), which drives ASE's OUTCAR chunk
parser through braceexpand'ed file globs. Here both pieces are
implemented natively: a streaming OUTCAR parser yielding labeled
:class:`Atoms` per ionic step, plus brace expansion and ASE-style index
strings.

Label conventions match `_y_from_calc` (dataload.py:275-300):
energy = free energy TOTEN (force-consistent), forces in eV/Angstrom,
stress in eV/A^3, Voigt order (xx, yy, zz, xy, yz, zx) with VASP's sign
(the reference takes -1 * ASE stress, which round-trips to exactly the
"in kB" row scaled by 0.1/160.21766 — VASP prints XX YY ZZ XY YZ ZX).
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from .graph import Atoms

_KBAR_TO_EV_A3 = 0.1 / 160.21766208

# VASP fixed-width columns can fuse ("0.000000000-10.371119000"); split
# on the float pattern instead of whitespace
_FLOAT_RE = re.compile(r'[-+]?\d+\.\d+(?:[eE][-+]?\d+)?')


def _floats(line: str) -> List[float]:
    return [float(v) for v in _FLOAT_RE.findall(line)]

_SYMBOLS = (
    'H He Li Be B C N O F Ne Na Mg Al Si P S Cl Ar K Ca Sc Ti V Cr Mn Fe '
    'Co Ni Cu Zn Ga Ge As Se Br Kr Rb Sr Y Zr Nb Mo Tc Ru Rh Pd Ag Cd In '
    'Sn Sb Te I Xe Cs Ba La Ce Pr Nd Pm Sm Eu Gd Tb Dy Ho Er Tm Yb Lu Hf '
    'Ta W Re Os Ir Pt Au Hg Tl Pb Bi Po At Rn Fr Ra Ac Th Pa U Np Pu Am '
    'Cm Bk Cf Es Fm Md No Lr'
).split()
SYMBOL_TO_Z = {s: i + 1 for i, s in enumerate(_SYMBOLS)}


def braceexpand(expr: str) -> List[str]:
    """Bash-style brace expansion: ``{a,b}`` lists and ``{1..5}`` ranges.

    Covers the subset the reference exercises through the braceexpand
    package (example_inputs/training/structure_list uses ``{1..5}``).
    """
    m = re.search(r'\{([^{}]*)\}', expr)
    if m is None:
        return [expr]
    head, tail = expr[:m.start()], expr[m.end():]
    body = m.group(1)
    rng = re.fullmatch(r'(-?\d+)\.\.(-?\d+)(?:\.\.(-?\d+))?', body)
    if rng:
        a, b = int(rng.group(1)), int(rng.group(2))
        step = int(rng.group(3) or (1 if b >= a else -1))
        if step == 0:
            raise ValueError(f'zero step in brace range: {expr}')
        stop = b + (1 if step > 0 else -1)
        width = None
        if rng.group(1).lstrip('-').startswith('0') or \
                rng.group(2).lstrip('-').startswith('0'):
            width = max(len(rng.group(1)), len(rng.group(2)))
        items = [str(v).zfill(width) if width else str(v)
                 for v in range(a, stop, step)]
    elif ',' in body:
        items = body.split(',')
    else:
        return [head + body + t for t in braceexpand(tail)]
    out = []
    for item in items:
        out.extend(braceexpand(head + item + tail))
    return out


def string2index(s: str) -> Union[int, slice]:
    """ASE-style index string: ':', '::2', '-1', '0:10' ..."""
    s = s.strip()
    if ':' not in s:
        return int(s)
    parts = [int(p) if p.strip() else None for p in s.split(':')]
    while len(parts) < 3:
        parts.append(None)
    return slice(*parts[:3])


def _species_from_header(header_lines: List[str]) -> List[str]:
    """Element list from VRHFIN (one per POTCAR) or TITEL fallback."""
    species = []
    for line in header_lines:
        m = re.search(r'VRHFIN\s*=\s*([A-Za-z]{1,2})\s*:', line)
        if m:
            species.append(m.group(1))
    if species:
        return species
    for line in header_lines:
        m = re.search(r'TITEL\s*=\s*\S+\s+([A-Za-z]{1,2})', line)
        if m:
            species.append(m.group(1))
    return species


def iread_outcar(path: str) -> Iterator[Atoms]:
    """Yield one labeled Atoms per ionic step of an OUTCAR.

    Streaming, single pass; matches the data the reference pulls out of
    ASE's OutcarChunkParser with PositionsAndForces/Stress/Energy/Cell
    parsers (dataload.py:384-388).
    """
    header: List[str] = []
    species: List[str] = []
    counts: List[int] = []
    atomic_numbers: Optional[np.ndarray] = None
    cell = np.zeros((3, 3))
    pending_cell = np.zeros((3, 3))
    stress: Optional[np.ndarray] = None
    pos = forces = None

    with open(path, 'r', errors='replace') as f:
        it = iter(f)
        for line in it:
            if atomic_numbers is None:
                header.append(line)
                if 'ions per type' in line:
                    counts = [int(v) for v in line.split('=')[1].split()]
                    species = _species_from_header(header)
                    if len(species) < len(counts):
                        raise ValueError(
                            f'{path}: found {len(species)} species for '
                            f'{len(counts)} ion types')
                    z = []
                    for sym, cnt in zip(species, counts):
                        z.extend([SYMBOL_TO_Z[sym]] * cnt)
                    atomic_numbers = np.array(z, dtype=np.int64)

            if 'direct lattice vectors' in line:
                rows = []
                for _ in range(3):
                    rows.append(_floats(next(it))[:3])
                pending_cell = np.array(rows)

            elif 'in kB' in line:
                vals = _floats(line)[:6]
                # VASP order XX YY ZZ XY YZ ZX == sevenn Voigt order
                stress = np.array(vals) * _KBAR_TO_EV_A3

            elif line.startswith(' POSITION') and 'TOTAL-FORCE' in line:
                next(it)  # dashed separator
                n = int(sum(counts))
                rows = np.array([_floats(next(it))[:6] for _ in range(n)])
                pos, forces = rows[:, :3], rows[:, 3:]
                cell = pending_cell

            elif 'free  energy   TOTEN' in line:
                energy = float(line.split('=')[1].split()[0])
                if pos is None or atomic_numbers is None:
                    continue  # electronic-only block (no ionic step yet)
                yield Atoms(
                    atomic_numbers=atomic_numbers,
                    pos=pos, cell=cell, pbc=np.array([True] * 3),
                    energy=energy, forces=forces, stress=stress,
                    info={'data_from': 'user_OUTCAR',
                          'file': os.path.abspath(path)},
                )
                pos = forces = None
                stress = None


def read_outcar(path: str, index=':') -> List[Atoms]:
    idx = string2index(index) if isinstance(index, str) else index
    frames = iread_outcar(path)
    if isinstance(idx, int):
        if idx < 0:
            return [list(frames)[idx]]
        got = list(itertools.islice(frames, idx, idx + 1))
        if not got:
            raise IndexError(f'{path}: no ionic step {idx}')
        return got
    if (idx.start or 0) < 0 or (idx.stop or 0) < 0:
        return list(frames)[idx]
    return list(itertools.islice(frames, idx.start, idx.stop, idx.step))


def structure_list_reader(filename: str) -> Dict[str, List[Atoms]]:
    """Parse a `structure_list` file into {label: [Atoms, ...]}.

    Format (dataload.py:390-422): ``[label]`` section headers; data
    lines are ``file_glob [index]`` where file_glob supports brace
    expansion and index is an ASE slice string (defaults to ':').
    """
    sections: Dict[str, List[Tuple[str, str]]] = {}
    label = 'Default'
    with open(filename) as f:
        for raw in f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith('['):
                if not line.endswith(']'):
                    raise ValueError('wrong structure_list title format')
                label = line[1:-1]
                sections.setdefault(label, [])
                continue
            parts = line.split()
            if len(parts) == 1:
                parts.append(':')
            elif len(parts) != 2:
                raise ValueError('wrong structure_list format')
            if label not in sections:
                raise ValueError('wrong structure_list format')
            sections[label].append((parts[0], parts[1]))

    base = os.path.dirname(os.path.abspath(filename))
    out: Dict[str, List[Atoms]] = {}
    for title, entries in sections.items():
        frames: List[Atoms] = []
        for files_expr, index_expr in entries:
            for fname in braceexpand(files_expr):
                if not os.path.isabs(fname):
                    fname = os.path.join(base, fname)
                frames.extend(read_outcar(fname, index_expr))
        out[title] = frames
    return out
