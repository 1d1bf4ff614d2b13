"""Write ``csrc/cg_patterns.cuh``: the sparse Clebsch-Gordan term pattern of
every (l1, l2, l3) with l <= 3, for the geometry-fused conv kernels
(``csrc/fused_conv_geom.cu``), which unroll each instruction's CG at
compile time.

    python -m sevennet_exp_tpu_torch.tools.cg_patterns [--check]

The terms come from the port's own plan builder,
``ops/fused_conv.py::_tp_plan``, on a one-instruction tensor product
``1x{l1}e (x) 1x{l2}e -> 1x{l3}e``: coefficient = wigner_3j * sqrt(2 l3 + 1)
(the path normalisation of a fan-in of 1). A layer's instruction has fan-in
``fan`` and so the coefficients of this pattern times 1/sqrt(fan); the
kernel takes that factor from the layer's own table (its first term over
the pattern's ``c0``). Terms are listed p-major, in the order of the
p-sorted section of the kernel tables (``FusedConv._build_tables``), so
``c0`` is the coefficient of the instruction's first table term.

``--check`` exits 1 when the file on disk differs from what this script
writes (``tests/test_torch_geom_plan.py`` checks the same, byte for byte).
"""

from __future__ import annotations

import os
import sys
from typing import List, Tuple

import numpy as np

from ..ops.fused_conv import _tp_plan
from ..ops.tensor_product import UVUTensorProductSpec

LMAX = 3
HEADER = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'csrc', 'cg_patterns.cuh')


def shapes() -> List[Tuple[int, int, int]]:
    """Every (l1, l2, l3) with l <= LMAX that the triangle rule allows."""
    return [(l1, l2, l3) for l1 in range(LMAX + 1) for l2 in range(LMAX + 1)
            for l3 in range(abs(l1 - l2), min(l1 + l2, LMAX) + 1)]


def pattern(l1: int, l2: int, l3: int):
    """[(m, n, p, coefficient)] of one shape, p-major (stable in (m, n))."""
    spec = UVUTensorProductSpec(f'1x{l1}e', f'1x{l2}e', f'1x{l3}e')
    plan, _ = _tp_plan(spec)
    (ins,) = plan
    return sorted(ins['nz'], key=lambda t: t[2])


def _lit(c: float) -> str:
    return '%.9e' % float(np.float32(c)) + 'f'


def render() -> str:
    out = [
        '// Sparse Clebsch-Gordan term patterns of every (l1, l2, l3), l <= 3,',
        '// for csrc/fused_conv_geom.cu. Generated by',
        '// sevennet_exp_tpu_torch/tools/cg_patterns.py from',
        '// ops/fused_conv.py::_tp_plan; do not edit.',
        '//',
        '// CgPattern<l1, l2, l3>::each(f) calls f(m, n, p, c) once per',
        '// nonzero term, p-major, with m, n, p as compile-time constants',
        '// (Ix<k>) and c the coefficient at a fan-in of 1; c0 is the first',
        "// term's coefficient. CG_SHAPES(S) lists every shape as S(l1, l2, l3).",
        '',
        '#pragma once',
        '',
        'template <int K> struct Ix { static constexpr int value = K; };',
        '',
        'template <int L1, int L2, int L3> struct CgPattern;',
    ]
    for l1, l2, l3 in shapes():
        terms = pattern(l1, l2, l3)
        out += [
            '',
            f'template <> struct CgPattern<{l1}, {l2}, {l3}> {{',
            f'  static constexpr int n_terms = {len(terms)};',
            f'  static constexpr float c0 = {_lit(terms[0][3])};',
            '  template <class F>',
            '  __device__ __forceinline__ static void each(F&& f) {',
        ]
        out += [f'    f(Ix<{m}>{{}}, Ix<{n}>{{}}, Ix<{p}>{{}}, {_lit(c)});'
                for m, n, p, c in terms]
        out += ['  }', '};']
    body = ' \\\n'.join(f'  S({l1}, {l2}, {l3})'
                        for l1, l2, l3 in shapes())
    out += ['', '#define CG_SHAPES(S) \\', body, '']
    return '\n'.join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    text = render()
    if argv == ['--check']:
        with open(HEADER) as fh:
            same = fh.read() == text
        print(f'{HEADER}: {"up to date" if same else "DIFFERS"}')
        return 0 if same else 1
    with open(HEADER, 'w') as fh:
        fh.write(text)
    print(f'wrote {HEADER}: {len(shapes())} shapes')
    return 0


if __name__ == '__main__':
    sys.exit(main())
