"""Real spherical harmonics in e3nn's basis and normalization, in torch.

Counterpart of ``sevennet_exp_tpu/ops/spherical.py``: the coefficient
tables (``_monomials``, ``sh_coefficients``) are copied verbatim (numpy,
float64); ``spherical_harmonics`` evaluates them on torch tensors with
the same monomial-times-coefficient formula.

e3nn's polynomials satisfy Y^1(x, y, z) = (x, y, z) and follow the
recursion Y^l = N_l * w3j(l-1, 1, l)-contraction(Y^{l-1}, Y^1), with N_l
fixed so ||Y^l(r)|| = 1 on the unit sphere; 'component' normalization
multiplies block l by sqrt(2l+1).

Frozen copy of ``sevennet_exp_tpu_torch/ops/spherical.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

from .wigner import wigner_3j


def _monomials(l: int) -> List[Tuple[int, int, int]]:
    """Degree-l monomial exponents, deterministic order."""
    return [
        (a, b, l - a - b)
        for a in range(l, -1, -1)
        for b in range(l - a, -1, -1)
    ]


def _mono_index(l: int):
    return {m: i for i, m in enumerate(_monomials(l))}


def _mono_product_matrix(l1: int, l2: int) -> np.ndarray:
    """M[(i1, i2), j]: product of monomial i1 (deg l1) and i2 (deg l2)."""
    m1, m2 = _monomials(l1), _monomials(l2)
    idx = _mono_index(l1 + l2)
    M = np.zeros((len(m1), len(m2), len(idx)))
    for i, (a1, b1, c1) in enumerate(m1):
        for j, (a2, b2, c2) in enumerate(m2):
            M[i, j, idx[(a1 + a2, b1 + b2, c1 + c2)]] = 1.0
    return M


@lru_cache(maxsize=None)
def sh_coefficients(l: int) -> np.ndarray:
    """Coefficient matrix C with Y^l_m(r) = sum_k C[m, k] * mono_k(r).

    Norm-normalized: ||Y^l(r)||_2 = 1 on the unit sphere.
    """
    if l == 0:
        return np.ones((1, 1))
    if l == 1:
        return np.eye(3)
    Cprev = sh_coefficients(l - 1)          # (2l-1, n_prev)
    C1 = sh_coefficients(1)                 # (3, 3)
    w = wigner_3j(l - 1, 1, l)              # (2l-1, 3, 2l+1)
    P = _mono_product_matrix(l - 1, 1)      # (n_prev, 3, n_new)
    raw = np.einsum('anm,ai,nj,ijk->mk', w, Cprev, C1, P)
    r = np.array([0.213, 0.818, -0.532])
    r = r / np.linalg.norm(r)
    vals = raw @ _eval_monomials_np(l, r)
    n = np.linalg.norm(vals)
    return raw / n


def _eval_monomials_np(l: int, r: np.ndarray) -> np.ndarray:
    x, y, z = r
    return np.array([x ** a * y ** b * z ** c for a, b, c in _monomials(l)])


def eval_monomials(l: int, vec: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., n_mono(l)) degree-l monomials."""
    if l == 0:
        return torch.ones(vec.shape[:-1] + (1,), dtype=vec.dtype,
                          device=vec.device)
    if l == 1:
        return vec
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    cols = []
    for a, b, c in _monomials(l):
        t = torch.ones_like(x)
        if a:
            t = t * x ** a
        if b:
            t = t * y ** b
        if c:
            t = t * z ** c
        cols.append(t)
    return torch.stack(cols, dim=-1)


def spherical_harmonics(
    lmax: int,
    vec: torch.Tensor,
    normalize: bool = True,
    normalization: str = 'component',
    eps: float = 1e-30,
) -> torch.Tensor:
    """(..., 3) -> (..., (lmax+1)^2) concatenated Y^0..Y^lmax (e3nn
    ``spherical_harmonics(range(lmax+1), vec, normalize, normalization)``).
    Zero-norm rows stay finite through ``eps``."""
    if normalize:
        n = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + eps)
        vec = vec / n
    blocks = []
    for l in range(lmax + 1):
        coef = np.asarray(sh_coefficients(l))
        if normalization == 'component':
            coef = coef * np.sqrt(2 * l + 1)
        elif normalization == 'integral':
            coef = coef / np.sqrt(4.0 * np.pi)
        elif normalization != 'norm':
            raise ValueError(normalization)
        coef_t = torch.as_tensor(coef, dtype=vec.dtype, device=vec.device)
        blocks.append(eval_monomials(l, vec) @ coef_t.T)
    return torch.cat(blocks, dim=-1)
