"""Wigner 3j / Clebsch-Gordan coefficients in e3nn's real basis.

Copy of the numpy tables of ``sevennet_exp_tpu/ops/wigner.py``
(``wigner_3j`` and its helpers), kept here so the PyTorch port imports
nothing of the JAX package. e3nn>=0.5 conventions:

  1. su2 Clebsch-Gordan coefficients via the Racah formula
     (Condon-Shortley phase).
  2. change of basis complex->real with the (-1j)**l phase so the result
     is real.
  3. normalize the 3-tensor to unit Frobenius norm.

All results are float64 numpy arrays, cached per (l1, l2, l3).

Frozen copy of ``sevennet_exp_tpu_torch/ops/wigner.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

from fractions import Fraction
from functools import lru_cache
from math import factorial, sqrt

import numpy as np


@lru_cache(maxsize=None)
def _su2_cg_coeff(idx1, idx2, idx3) -> float:
    """<j1 m1; j2 m2 | j3 m3> via the Racah formula, exact rationals."""
    j1, m1 = idx1
    j2, m2 = idx2
    j3, m3 = idx3
    if m3 != m1 + m2:
        return 0.0

    vmin = int(max(-j1 + j2 + m3, -j1 + m1, 0))
    vmax = int(min(j2 + j3 + m1, j3 - j1 + j2, j3 + m3))

    def f(n):
        assert n == round(n), n
        return factorial(round(n))

    C = (
        (2.0 * j3 + 1.0)
        * Fraction(
            f(j3 + j1 - j2) * f(j3 - j1 + j2) * f(j1 + j2 - j3)
            * f(j3 + m3) * f(j3 - m3),
            f(j1 + j2 + j3 + 1) * f(j1 - m1) * f(j1 + m1)
            * f(j2 - m2) * f(j2 + m2),
        )
    )
    S = 0
    for v in range(vmin, vmax + 1):
        S += (-1) ** (v + j2 + m2) * Fraction(
            f(j2 + j3 + m1 - v) * f(j1 - m1 + v),
            f(v) * f(j3 - j1 + j2 - v) * f(j3 + m3 - v) * f(v + j1 - j2 - m3),
        )
    C = C * S ** 2
    return float(C) ** 0.5 * (1 if S >= 0 else -1)


@lru_cache(maxsize=None)
def su2_clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """Complex-basis CG tensor, shape (2j1+1, 2j2+1, 2j3+1)."""
    mat = np.zeros((2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1), dtype=np.float64)
    if abs(j1 - j2) <= j3 <= j1 + j2:
        for m1 in range(-j1, j1 + 1):
            for m2 in range(-j2, j2 + 1):
                m3 = m1 + m2
                if abs(m3) <= j3:
                    mat[j1 + m1, j2 + m2, j3 + m3] = _su2_cg_coeff(
                        (j1, m1), (j2, m2), (j3, m3)
                    )
    return mat


@lru_cache(maxsize=None)
def change_basis_real_to_complex(l: int) -> np.ndarray:
    """Unitary Q with rows=complex m index, cols=real m index (e3nn conv.)."""
    q = np.zeros((2 * l + 1, 2 * l + 1), dtype=np.complex128)
    inv_s2 = 1.0 / sqrt(2.0)
    for m in range(-l, 0):
        q[l + m, l + abs(m)] = inv_s2
        q[l + m, l - abs(m)] = -1j * inv_s2
    q[l, l] = 1.0
    for m in range(1, l + 1):
        q[l + m, l + abs(m)] = (-1) ** m * inv_s2
        q[l + m, l - abs(m)] = 1j * (-1) ** m * inv_s2
    return (-1j) ** l * q


@lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis Wigner 3j tensor, unit Frobenius norm (e3nn convention).

    C[a, b, c] = sum_{M1 M2 M3} Q1[M1,a] Q2[M2,b] conj(Q3[M3,c]) CG[M1,M2,M3]
    """
    assert abs(l1 - l2) <= l3 <= l1 + l2, (l1, l2, l3)
    Q1 = change_basis_real_to_complex(l1)
    Q2 = change_basis_real_to_complex(l2)
    Q3 = change_basis_real_to_complex(l3)
    C = su2_clebsch_gordan(l1, l2, l3).astype(np.complex128)
    C = np.einsum('ij,kl,mn,ikm->jln', Q1, Q2, np.conj(Q3), C)
    assert np.abs(C.imag).max() < 1e-10, (l1, l2, l3, np.abs(C.imag).max())
    C = C.real
    n = np.linalg.norm(C)
    assert n > 0
    return np.ascontiguousarray(C / n)
