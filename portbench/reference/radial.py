"""Radial basis and cutoff envelopes, in torch.

Counterpart of ``sevennet_exp_tpu/ops/radial.py`` (reference
sevenn/nn/edge_embedding.py): Bessel basis (2/rc) * sin(c_n r) / r with
trainable coefficients c_n = n*pi/rc, the polynomial envelope and the
XPLOR switching envelope.

Frozen copy of ``sevennet_exp_tpu_torch/ops/radial.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BesselBasis:
    cutoff: float
    num_basis: int = 8
    trainable: bool = True

    def apply(self, params, r: torch.Tensor) -> torch.Tensor:
        prefactor = 2.0 / self.cutoff
        ur = r[..., None]
        coeffs = params['coeffs'].to(r.dtype)
        # padded edges carry r > 0 dummy lengths; the caller masks them
        return prefactor * torch.sin(coeffs * ur) / ur


@dataclass(frozen=True)
class PolynomialCutoff:
    cutoff: float
    p: int = 6

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        p = float(self.p)
        c0 = (p + 1.0) * (p + 2.0) / 2.0
        c1 = p * (p + 2.0)
        c2 = p * (p + 1.0) / 2.0
        rr = r / self.cutoff
        return (1.0 - c0 * torch.pow(rr, p) + c1 * torch.pow(rr, p + 1.0)
                - c2 * torch.pow(rr, p + 2.0))


@dataclass(frozen=True)
class XPLORCutoff:
    cutoff: float
    cutoff_on: float

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        r_sq = r * r
        r_on_sq = self.cutoff_on ** 2
        r_cut_sq = self.cutoff ** 2
        smooth = ((r_cut_sq - r_sq) ** 2
                  * (r_cut_sq + 2.0 * r_sq - 3.0 * r_on_sq)
                  / (r_cut_sq - r_on_sq) ** 3)
        return torch.where(r < self.cutoff_on, torch.ones_like(r), smooth)
