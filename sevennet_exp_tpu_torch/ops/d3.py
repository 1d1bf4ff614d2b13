"""Grimme DFT-D3 two-body dispersion in plain PyTorch.

Counterpart of ``sevennet_exp_tpu/ops/d3.py`` (reference ``pair_d3.cu``):
coordination-number-dependent C6 by Gaussian interpolation over Grimme's
reference pairs, the four dampings (``damp_zero``, ``damp_bj``,
``damp_zerom``, ``damp_bjm``) with the published per-functional
parameters, all pairs summed over lattice replicas, fp32.

* **One energy function and autograd.** The total energy is a function of
  (positions, lattice, strain); forces and stress come from
  ``torch.autograd``, the C6(CN) chain rule included.
* **Chunked replica sums.** ``dispersion_energy`` loops over chunks of
  lattice shifts with a (C, N, N) pairwise block per chunk; each chunk
  body runs under ``torch.utils.checkpoint``, so that the backward pass
  keeps one chunk's block at a time, not every one (JAX: ``jax.checkpoint``
  on the scan body).
* **Log-sum-exp stabilised C6 weights**, in the factored per-atom form
  (``c6_atom_factors``): no (N, N, MAXC, MAXC) tensor.
* **Large systems.** ``dispersion_energy_tiled`` sweeps the (i, j) plane in
  (block, block) tiles under minimum-image convention (valid when every
  cell width is at least twice the cutoff, ``mic_ok``), each tile under
  checkpointing: O(block^2) memory at any N.

The parameter tables (r0ab, the C6 reference points, r2r4, rcov) are
Grimme et al.'s published D3 data (J. Chem. Phys. 132, 154104 (2010)),
in ``d3_params.npz`` beside this file. Internal math in Hartree atomic
units, the API (``D3Dispersion``) in eV and Angstrom.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

AU_TO_ANG = 0.52917726
AU_TO_EV = 27.21138505
K1 = 16.0
K3 = -4.0  # Gaussian C6-interpolation exponent
MAXC = 5

_PARAMS_PATH = os.path.join(os.path.dirname(__file__), 'd3_params.npz')


# ---------------------------------------------------------------------------
# Per-functional damping parameters: (rs6, s18, rs18, s6) per functional;
# alp = 14. The published D3 parametrisations (reference pair_d3.cu:422-648).
# ---------------------------------------------------------------------------

_ZERO = {
    'slater-dirac-exchange': (0.999, -1.957, 0.697, 1.0),
    'b-lyp': (1.094, 1.682, 1.0, 1.0),
    'b-p': (1.139, 1.683, 1.0, 1.0),
    'b97-d': (0.892, 0.909, 1.0, 1.0),
    'revpbe': (0.923, 1.010, 1.0, 1.0),
    'pbe': (1.217, 0.722, 1.0, 1.0),
    'pbesol': (1.345, 0.612, 1.0, 1.0),
    'rpw86-pbe': (1.224, 0.901, 1.0, 1.0),
    'rpbe': (0.872, 0.514, 1.0, 1.0),
    'tpss': (1.166, 1.105, 1.0, 1.0),
    'b3-lyp': (1.261, 1.703, 1.0, 1.0),
    'pbe0': (1.287, 0.928, 1.0, 1.0),
    'hse06': (1.129, 0.109, 1.0, 1.0),
    'revpbe38': (1.021, 0.862, 1.0, 1.0),
    'pw6b95': (1.532, 0.862, 1.0, 1.0),
    'tpss0': (1.252, 1.242, 1.0, 1.0),
    'b2-plyp': (1.427, 1.022, 1.0, 0.64),
    'pwpb95': (1.557, 0.705, 1.0, 0.82),
    'b2gp-plyp': (1.586, 0.760, 1.0, 0.56),
    'ptpss': (1.541, 0.879, 1.0, 0.75),
    'hf': (1.158, 1.746, 1.0, 1.0),
    'mpwlyp': (1.239, 1.098, 1.0, 1.0),
    'bpbe': (1.087, 2.033, 1.0, 1.0),
    'bh-lyp': (1.370, 1.442, 1.0, 1.0),
    'tpssh': (1.223, 1.219, 1.0, 1.0),
    'pwb6k': (1.660, 0.550, 1.0, 1.0),
    'b1b95': (1.613, 1.868, 1.0, 1.0),
    'bop': (0.929, 1.975, 1.0, 1.0),
    'o-lyp': (0.806, 1.764, 1.0, 1.0),
    'o-pbe': (0.837, 2.055, 1.0, 1.0),
    'ssb': (1.215, 0.663, 1.0, 1.0),
    'revssb': (1.221, 0.560, 1.0, 1.0),
    'otpss': (1.128, 1.494, 1.0, 1.0),
    'b3pw91': (1.176, 1.775, 1.0, 1.0),
    'revpbe0': (0.949, 0.792, 1.0, 1.0),
    'pbe38': (1.333, 0.998, 1.0, 1.0),
    'mpw1b95': (1.605, 1.118, 1.0, 1.0),
    'mpwb1k': (1.671, 1.061, 1.0, 1.0),
    'bmk': (1.931, 2.168, 1.0, 1.0),
    'cam-b3lyp': (1.378, 1.217, 1.0, 1.0),
    'lc-wpbe': (1.355, 1.279, 1.0, 1.0),
    'm05': (1.373, 0.595, 1.0, 1.0),
    'm052x': (1.417, 0.000, 1.0, 1.0),
    'm06l': (1.581, 0.000, 1.0, 1.0),
    'm06': (1.325, 0.000, 1.0, 1.0),
    'm062x': (1.619, 0.000, 1.0, 1.0),
    'm06hf': (1.446, 0.000, 1.0, 1.0),
    'hcth120': (1.221, 1.206, 1.0, 1.0),
}

_BJ = {
    'b-p': (0.3946, 3.2822, 4.8516, 1.0),
    'b-lyp': (0.4298, 2.6996, 4.2359, 1.0),
    'revpbe': (0.5238, 2.3550, 3.5016, 1.0),
    'rpbe': (0.1820, 0.8318, 4.0094, 1.0),
    'b97-d': (0.5545, 2.2609, 3.2297, 1.0),
    'pbe': (0.4289, 0.7875, 4.4407, 1.0),
    'rpw86-pbe': (0.4613, 1.3845, 4.5062, 1.0),
    'b3-lyp': (0.3981, 1.9889, 4.4211, 1.0),
    'tpss': (0.4535, 1.9435, 4.4752, 1.0),
    'hf': (0.3385, 0.9171, 2.8830, 1.0),
    'tpss0': (0.3768, 1.2576, 4.5865, 1.0),
    'pbe0': (0.4145, 1.2177, 4.8593, 1.0),
    'hse06': (0.383, 2.310, 5.685, 1.0),
    'revpbe38': (0.4309, 1.4760, 3.9446, 1.0),
    'pw6b95': (0.2076, 0.7257, 6.3750, 1.0),
    # canonical Grimme s6 = 0.64 for b2-plyp; the reference's switch has
    # the assignment after `break` (pair_d3.cu:537, dead code, s6 stays 1)
    'b2-plyp': (0.3065, 0.9147, 5.0570, 0.64),
    'dsd-blyp': (0.0000, 0.2130, 6.0519, 0.50),
    'dsd-blyp-fc': (0.0009, 0.2112, 5.9807, 0.50),
    'bop': (0.4870, 3.2950, 3.5043, 1.0),
    'mpwlyp': (0.4831, 2.0077, 4.5323, 1.0),
    'o-lyp': (0.5299, 2.6205, 2.8065, 1.0),
    'pbesol': (0.4466, 2.9491, 6.1742, 1.0),
    'bpbe': (0.4567, 4.0728, 4.3908, 1.0),
    'opbe': (0.5512, 3.3816, 2.9444, 1.0),
    'ssb': (-0.0952, -0.1744, 5.2170, 1.0),
    'revssb': (0.4720, 0.4389, 4.0986, 1.0),
    'otpss': (0.4634, 2.7495, 4.3153, 1.0),
    'b3pw91': (0.4312, 2.8524, 4.4693, 1.0),
    'bh-lyp': (0.2793, 1.0354, 4.9615, 1.0),
    'revpbe0': (0.4679, 1.7588, 3.7619, 1.0),
    'tpssh': (0.4529, 2.2382, 4.6550, 1.0),
    'mpw1b95': (0.1955, 1.0508, 6.4177, 1.0),
    'pwb6k': (0.1805, 0.9383, 7.7627, 1.0),
    'b1b95': (0.2092, 1.4507, 5.5545, 1.0),
    'bmk': (0.1940, 2.0860, 5.9197, 1.0),
    'cam-b3lyp': (0.3708, 2.0674, 5.4743, 1.0),
    'lc-wpbe': (0.3919, 1.8541, 5.0897, 1.0),
    'b2gp-plyp': (0.0000, 0.2597, 6.3332, 0.560),
    'ptpss': (0.0000, 0.2804, 6.5745, 0.750),
    'pwpb95': (0.0000, 0.2904, 7.3141, 0.820),
    'hf/mixed': (0.5607, 3.9027, 4.5622, 1.0),
    'hf/sv': (0.4249, 2.1849, 4.2783, 1.0),
    'hf/minis': (0.1702, 0.9841, 3.8506, 1.0),
    'b3-lyp/6-31gd': (0.5014, 4.0672, 4.8409, 1.0),
    'hcth120': (0.3563, 1.0821, 4.3359, 1.0),
    'pw1pw': (0.3807, 2.3363, 5.8844, 1.0),
    'pwgga': (0.2211, 2.6910, 6.7278, 1.0),
    'hsesol': (0.4650, 2.9215, 6.2003, 1.0),
    'hf3c': (0.4171, 0.8777, 2.9149, 1.0),
    'hf3cv': (0.3063, 0.5022, 3.9856, 1.0),
    'pbeh3c': (0.4860, 0.0000, 4.5000, 1.0),
    'pbeh-3c': (0.4860, 0.0000, 4.5000, 1.0),
}

_ZEROM = {
    'b2-plyp': (1.313134, 0.717543, 0.016035, 0.640000),
    'b3-lyp': (1.338153, 1.532981, 0.013988, 1.0),
    'b97-d': (1.151808, 1.020078, 0.035964, 1.0),
    'b-lyp': (1.279637, 1.841686, 0.014370, 1.0),
    'b-p': (1.233460, 1.945174, 0.000000, 1.0),
    'pbe': (2.340218, 0.000000, 0.129434, 1.0),
    'pbe0': (2.077949, 0.000081, 0.116755, 1.0),
    'lc-wpbe': (1.366361, 1.280619, 0.003160, 1.0),
}

_BJM = {
    'b2-plyp': (0.486434, 0.672820, 3.656466, 0.640000),
    'b3-lyp': (0.278672, 1.466677, 4.606311, 1.0),
    'b97-d': (0.240184, 1.206988, 3.864426, 1.0),
    'b-lyp': (0.448486, 1.875007, 3.610679, 1.0),
    'b-p': (0.821850, 3.140281, 2.728151, 1.0),
    'pbe': (0.012092, 0.358940, 5.938951, 1.0),
    'pbe0': (0.007912, 0.528823, 6.162326, 1.0),
    'lc-wpbe': (0.563761, 0.906564, 3.593680, 1.0),
}

DAMPING_TABLES = {
    'damp_zero': _ZERO,
    'damp_bj': _BJ,
    'damp_zerom': _ZEROM,
    'damp_bjm': _BJM,
}


class D3Damping(NamedTuple):
    """Resolved damping parameters."""
    kind: str  # 'zero' | 'bj' | 'zerom' | 'bjm'
    s6: float
    s8: float
    rs6: float   # a1 for bj-type damping
    rs8: float   # a2 for bj-type damping (beta for zerom)
    alp: float


def get_damping_params(damping: str, functional: str) -> D3Damping:
    if damping not in DAMPING_TABLES:
        raise ValueError(
            f'unknown damping {damping!r}; choose from {list(DAMPING_TABLES)}')
    table = DAMPING_TABLES[damping]
    functional = functional.lower()
    if functional not in table:
        raise ValueError(
            f'functional {functional!r} has no {damping} parameters')
    rs6, s18, rs18, s6 = table[functional]
    return D3Damping(damping[5:], s6, s18, rs6, rs18, 14.0)


class D3Tables(NamedTuple):
    """Per-atom-type slices of the Grimme tables (T = distinct types)."""
    r0ab: torch.Tensor     # (T, T) bohr
    rcov: torch.Tensor     # (T,) bohr (k2-scaled covalent radii)
    r2r4: torch.Tensor     # (T,) sqrt(Q) factors for C8
    c6ref: torch.Tensor    # (T, T, MAXC, MAXC) C6 references, NaN = absent
    cnref_i: torch.Tensor  # (T, T, MAXC, MAXC)
    cnref_j: torch.Tensor  # (T, T, MAXC, MAXC)


@functools.lru_cache(maxsize=1)
def _raw_tables() -> Dict[str, np.ndarray]:
    with np.load(_PARAMS_PATH) as f:
        return {k: f[k] for k in f.files}


def build_tables(atomic_numbers: Sequence[int], dtype=torch.float32,
                 device='cpu') -> D3Tables:
    """Slice the 94-element master tables down to the system's types."""
    raw = _raw_tables()
    z = np.asarray(atomic_numbers, dtype=np.int64)
    if (z < 1).any() or (z > 94).any():
        raise ValueError(f'D3 parameters exist only for Z in [1, 94]: {z}')
    idx = z - 1
    ix = np.ix_(idx, idx)

    def t(a):
        # through float32 first, as the JAX tables are made
        return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype,
                               device=device)

    return D3Tables(r0ab=t(raw['r0ab'][ix]), rcov=t(raw['rcov'][idx]),
                    r2r4=t(raw['r2r4'][idx]), c6ref=t(raw['c6'][ix]),
                    cnref_i=t(raw['cn_i'][ix]), cnref_j=t(raw['cn_j'][ix]))


def lattice_shifts(cell_ang: np.ndarray, pbc, r_cut_ang: float,
                   chunk: int = 16) -> np.ndarray:
    """Integer lattice shifts covering r_cut (host side, static count):
    per axis the replica count from the perpendicular cell heights, none
    along non-periodic axes (reference pair_d3.cu:1020-1046). The zero
    shift first; padded to a multiple of ``chunk`` with sentinel shifts
    that land beyond the cutoff and are masked."""
    cell = np.asarray(cell_ang, dtype=np.float64)
    pbc = np.asarray(pbc, dtype=bool)
    rep = np.zeros(3, dtype=np.int64)
    if pbc.any():
        if abs(np.linalg.det(cell)) < 1e-10:
            raise ValueError('periodic system needs a non-singular cell')
        inv = np.linalg.inv(cell)
        heights = 1.0 / np.linalg.norm(inv, axis=0)
        rep = np.where(pbc, np.floor(r_cut_ang / heights).astype(np.int64)
                       + 1, 0)
    grids = [np.arange(-r, r + 1) for r in rep]
    shifts = np.stack(np.meshgrid(*grids, indexing='ij'), -1).reshape(-1, 3)
    order = np.argsort(np.abs(shifts).sum(1), kind='stable')
    shifts = shifts[order]
    pad = (-len(shifts)) % chunk
    if pad:
        sentinel = np.full((pad, 3), 2 * int(rep.max()) + 9, dtype=np.int64)
        shifts = np.concatenate([shifts, sentinel], 0)
    return shifts.astype(np.float64)


def _ckpt(fn, *args):
    """fn(*args), under activation checkpointing when autograd records:
    the backward recomputes the call's intermediates instead of keeping
    them."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _pair_dist2(pos, lat, tau_frac):
    """(C, N, N) squared distances of r_ij = x_j - x_i + tau for a chunk
    of shifts, one Cartesian component at a time."""
    tau = tau_frac @ lat
    r2 = None
    for a in range(3):
        d = ((pos[None, None, :, a] - pos[None, :, None, a])
             + tau[:, None, None, a])
        r2 = d * d if r2 is None else r2 + d * d
    return r2


def _self_pairs(ok, first: bool):
    """Drop i == j at the zero shift (entry 0 of the first chunk)."""
    if first:
        ok = ok.clone()
        ok[0].fill_diagonal_(False)
    return ok


def _cn_chunk(pos, lat, tau_frac, rcov_sum, cn_thr: float, first: bool):
    r2 = _pair_dist2(pos, lat, tau_frac)
    ok = _self_pairs(r2 <= cn_thr, first)
    r = torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
    damp = 1.0 / (1.0 + torch.exp(-K1 * (rcov_sum[None] / r - 1.0)))
    return torch.sum(torch.where(ok, damp, torch.zeros_like(damp)),
                     dim=(0, 2))


def coordination_numbers(pos, lat, tidx, tables: D3Tables, shifts_cn,
                         cn_thr: float) -> torch.Tensor:
    """Fractional coordination numbers (pair_d3.cu:1051-1106):
    cn_i = sum_{j, tau != self} 1 / (1 + exp(-K1 ((rcov_i + rcov_j)/r - 1)))
    over chunks of shifts ``shifts_cn`` (n_chunks, chunk, 3)."""
    rcov = tables.rcov[tidx]
    rcov_sum = rcov[:, None] + rcov[None, :]
    cn = pos.new_zeros(pos.shape[0])
    for c in range(shifts_cn.shape[0]):
        cn = cn + _ckpt(_cn_chunk, pos, lat, shifts_cn[c], rcov_sum,
                        float(cn_thr), c == 0)
    return cn


def c6_atom_factors(cn, tidx, tables: D3Tables):
    """Per-atom factors of the Gaussian C6 interpolation (JAX
    ``c6_atom_factors``): Grimme's reference grid is separable, so with
    w_i[k] = exp(K3 (cn_i - cnref(t_i)[k])^2), max-stabilised per atom,
    C6_ij = (w_i^T C6REF[t_i, t_j] w_j) / (s_i s_j), s_i = sum_k w_i[k].
    Returns unnormalised (w (N, MAXC), u (N, T, MAXC)) with
    u[i, t, l] = sum_k w_i[k] c6ref[t_i, t, k, l]."""
    finite = torch.isfinite(tables.c6ref)                  # (T, T, C, C)
    valid_tk = torch.any(torch.any(finite, dim=3), dim=1)  # (T, C)
    neg_inf = torch.full_like(tables.cnref_i, -float('inf'))
    cnref_tk = torch.amax(torch.where(finite, tables.cnref_i, neg_inf),
                          dim=(1, 3))
    cnref_tk = torch.where(valid_tk, cnref_tk, torch.zeros_like(cnref_tk))
    v = valid_tk[tidx]                                     # (N, C)
    d = (cn[:, None] - cnref_tk[tidx]) ** 2
    logw = torch.where(v, K3 * d, torch.full_like(d, -float('inf')))
    m = torch.amax(logw, dim=-1, keepdim=True)
    w = torch.where(v, torch.exp(logw - torch.clamp(m, min=-1e30)),
                    torch.zeros_like(logw))
    c6p = torch.where(finite, tables.c6ref, torch.zeros_like(tables.c6ref))
    u = torch.einsum('ik,itkl->itl', w, c6p[tidx])
    return w, u


def _normalized_factors(w, u):
    s = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    return w / s, u / s[..., None]


def interpolate_c6(cn, tidx, tables: D3Tables) -> torch.Tensor:
    """(N, N) C6 by the Gaussian interpolation over reference pairs,
    C6_ij = sum_kl L_kl c6ref_kl / sum_kl L_kl, in the factored per-atom
    form, each atom's factors normalised before the pair contraction."""
    wn, un = _normalized_factors(*c6_atom_factors(cn, tidx, tables))
    c6 = cn.new_zeros((cn.shape[0], cn.shape[0]))
    for t in range(tables.rcov.shape[0]):
        c6 = c6 + torch.where(tidx[None, :] == t, un[:, t, :] @ wn.T,
                              torch.zeros_like(c6))
    return c6


def _pair_terms(damping: D3Damping, r2, c6, c8, r42, r0):
    """Damped -E_pair (Hartree, before the ordered-pair half) of every
    pair, at squared distances ``r2`` (masked slots already finite)."""
    s6, s8, alp = damping.s6, damping.s8, damping.alp
    r6 = r2 * r2 * r2
    if damping.kind in ('bj', 'bjm'):
        a1, a2 = damping.rs6, damping.rs8
        rr = a1 * torch.sqrt(3.0 * r42) + a2       # a1 sqrt(C8/C6) + a2
        rr2 = rr * rr
        rr6 = rr2 * rr2 * rr2
        return s6 * c6 / (r6 + rr6) + s8 * c8 / (r6 * r2 + rr6 * rr2)
    r = torch.sqrt(r2)
    if damping.kind == 'zero':
        t6 = (damping.rs6 * r0 / r) ** alp
        t8 = (damping.rs8 * r0 / r) ** (alp + 2.0)
    elif damping.kind == 'zerom':
        # D3M (Smith, Burns, Patkowski, Sherrill, JPCL 7, 2197 (2016)):
        # an additive beta * r0 inside the damping power
        rs6, beta = damping.rs6, damping.rs8
        t6 = (r / (rs6 * r0) + beta * r0) ** (-alp)
        t8 = (r / r0 + beta * r0) ** (-(alp + 2.0))
    else:  # pragma: no cover
        raise ValueError(damping.kind)
    return (s6 * c6 / r6 / (1.0 + 6.0 * t6)
            + s8 * c8 / (r6 * r2) / (1.0 + 6.0 * t8))


def _energy_chunk(pos, lat, tau_frac, c6, c8, r42, r0, damping, rthr,
                  first: bool):
    r2 = _pair_dist2(pos, lat, tau_frac)
    ok = _self_pairs(r2 <= rthr, first)
    # masked slots take a benign finite distance (1 bohr^2), which keeps
    # the backward free of inf * 0; the sum re-masks them
    r2 = torch.where(ok, r2, torch.ones_like(r2))
    e = _pair_terms(damping, r2, c6[None], c8[None], r42[None], r0[None])
    return torch.sum(torch.where(ok, e, torch.zeros_like(e)))


def dispersion_energy(pos, lat, tidx, tables: D3Tables, damping: D3Damping,
                      shifts_vdw, shifts_cn, rthr: float = 9000.0,
                      cn_thr: float = 1600.0) -> torch.Tensor:
    """Total two-body D3 dispersion energy in Hartree.

    pos (N, 3) bohr, lat (3, 3) bohr rows, tidx (N,) type indices;
    shifts_* (n_chunks, chunk, 3) fractional lattice multiples with the
    zero shift at [0, 0] (``lattice_shifts``). The summation of
    pair_d3.cu:1273-1505 (zero) / :1558-1768 (bj); energy only, the
    derivatives by autograd, each chunk under checkpointing."""
    cn = coordination_numbers(pos, lat, tidx, tables, shifts_cn, cn_thr)
    c6 = interpolate_c6(cn, tidx, tables)                  # (N, N)
    r2r4 = tables.r2r4[tidx]
    r42 = r2r4[:, None] * r2r4[None, :]
    c8 = 3.0 * c6 * r42
    r0 = tables.r0ab[tidx[:, None], tidx[None, :]]
    e = pos.new_zeros(())
    for c in range(shifts_vdw.shape[0]):
        e = e + _ckpt(_energy_chunk, pos, lat, shifts_vdw[c], c6, c8, r42,
                      r0, damping, float(rthr), c == 0)
    return -0.5 * e  # ordered-pair double count


# ---------------------------------------------------------------------------
# Large systems: the block-tiled minimum-image pair sweep. The replica path
# holds (C, N, N) blocks -- fine to ~10k atoms; an (N, N) fp32 plane alone
# is 37 GB at 97k. Here the (i, j) plane is swept in (block, block) tiles,
# O(block^2) live memory at any N, with the factored per-atom C6. Exact
# when every cell width is >= 2 * cutoff (``mic_ok``).
# ---------------------------------------------------------------------------


def mic_ok(cell_ang: np.ndarray, r_cut_ang: float) -> bool:
    """True when minimum-image convention is exact for r_cut: every
    perpendicular cell width >= 2 * r_cut (host side)."""
    cell = np.asarray(cell_ang, dtype=np.float64)
    inv = np.linalg.inv(cell)
    heights = 1.0 / np.linalg.norm(inv, axis=0)
    return bool(np.all(heights >= 2.0 * r_cut_ang))


def _tile_r2(pi, pj, lat, inv):
    """(B, B) squared minimum-image distances, one component at a time."""
    d = [pi[:, a][:, None] - pj[:, a][None, :] for a in range(3)]
    f = [d[0] * inv[0, a] + d[1] * inv[1, a] + d[2] * inv[2, a]
         for a in range(3)]
    f = [x - torch.round(x) for x in f]
    v = [f[0] * lat[0, a] + f[1] * lat[1, a] + f[2] * lat[2, a]
         for a in range(3)]
    return v[0] * v[0] + v[1] * v[1] + v[2] * v[2]


def _tile_ok(r2, thr, vi, vj, diag: bool):
    ok = (r2 <= thr) & vi[:, None] & vj[None, :]
    if diag:
        ok.fill_diagonal_(False)
    return ok


def _cn_tile(pi, pj, lat, inv, rcov_i, rcov_j, vi, vj, cn_thr: float,
             diag: bool):
    r2 = _tile_r2(pi, pj, lat, inv)
    ok = _tile_ok(r2, cn_thr, vi, vj, diag)
    r = torch.sqrt(torch.where(ok, r2, torch.ones_like(r2)))
    rsum = rcov_i[:, None] + rcov_j[None, :]
    damp = 1.0 / (1.0 + torch.exp(-K1 * (rsum / r - 1.0)))
    return torch.sum(torch.where(ok, damp, torch.zeros_like(damp)), dim=1)


def _energy_tile(pi, pj, lat, inv, ti, tj, uni, wnj, r42_i, r42_j, vi, vj,
                 r0ab, damping, rthr: float, diag: bool):
    r2 = _tile_r2(pi, pj, lat, inv)
    ok = _tile_ok(r2, rthr, vi, vj, diag)
    r2 = torch.where(ok, r2, torch.ones_like(r2))
    c6 = r2.new_zeros(r2.shape)
    for t in range(uni.shape[1]):
        c6 = c6 + torch.where(tj[None, :] == t, uni[:, t, :] @ wnj.T,
                              torch.zeros_like(c6))
    r42 = r42_i[:, None] * r42_j[None, :]
    r0 = r0ab[ti[:, None], tj[None, :]]
    e = _pair_terms(damping, r2, c6, 3.0 * c6 * r42, r42, r0)
    return torch.sum(torch.where(ok, e, torch.zeros_like(e)))


def dispersion_energy_tiled(pos, lat, tidx, tables: D3Tables,
                            damping: D3Damping, rthr: float = 9000.0,
                            cn_thr: float = 1600.0,
                            block: int = 1024) -> torch.Tensor:
    """Total two-body D3 energy (Hartree) by the tiled minimum-image sweep.

    pos (N, 3) bohr, lat (3, 3) bohr rows, tidx (N,) type indices. Equal
    to ``dispersion_energy`` whenever minimum image is exact for both
    thresholds; differentiable in pos and lat (forces, virial); each tile
    under checkpointing, so memory is O(block^2) at any N."""
    n = pos.shape[0]
    inv = torch.linalg.inv(lat)
    # wrap into the primary cell (the gradient of frac - floor(frac) is
    # the identity away from the wrap boundaries)
    frac = pos @ inv
    posw = (frac - torch.floor(frac)) @ lat
    npad = (-n) % block
    valid = torch.arange(n + npad, device=pos.device) < n
    if npad:
        posw = torch.cat([posw, posw.new_zeros((npad, 3))])
        tidx = torch.cat([tidx, tidx.new_zeros(npad)])
    nb = (n + npad) // block

    def sl(a, i):
        return a[i * block:(i + 1) * block]

    # pass 1: coordination numbers
    rcov = tables.rcov[tidx]
    cn = torch.cat([
        sum(_ckpt(_cn_tile, sl(posw, i), sl(posw, j), lat, inv,
                  sl(rcov, i), sl(rcov, j), sl(valid, i), sl(valid, j),
                  float(cn_thr), i == j) for j in range(nb))
        for i in range(nb)])
    # per-atom C6 factors, normalised; zero on the pad rows
    wn, un = _normalized_factors(*c6_atom_factors(cn[:n], tidx[:n], tables))
    wn = torch.cat([wn, wn.new_zeros((npad, MAXC))])
    un = torch.cat([un, un.new_zeros((npad,) + un.shape[1:])])
    # pass 2: pair energies
    r2r4 = tables.r2r4[tidx]
    e = pos.new_zeros(())
    for i in range(nb):
        for j in range(nb):
            e = e + _ckpt(_energy_tile, sl(posw, i), sl(posw, j), lat, inv,
                          sl(tidx, i), sl(tidx, j), sl(un, i), sl(wn, j),
                          sl(r2r4, i), sl(r2r4, j), sl(valid, i),
                          sl(valid, j), tables.r0ab, damping, float(rthr),
                          i == j)
    return -0.5 * e  # ordered-pair double count


def _energy_forces_stress(pos, lat, tidx, tables: D3Tables,
                          damping: D3Damping, shifts_vdw, shifts_cn,
                          rthr: float, cn_thr: float):
    """(E Hartree, F = -dE/dpos, sigma = dE/d(strain) / V 3 x 3), the strain
    symmetrised and applied to positions and lattice (JAX ``_efs_kernel``);
    one backward pass."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        strain = torch.zeros((3, 3), dtype=pos.dtype, device=pos.device,
                             requires_grad=True)
        sym = 0.5 * (strain + strain.T)
        e = dispersion_energy(p + p @ sym, lat + lat @ sym, tidx, tables,
                              damping, shifts_vdw, shifts_cn, rthr, cn_thr)
        gp, gs = torch.autograd.grad(e, [p, strain])
    vol = torch.abs(torch.linalg.det(lat))
    return e.detach(), -gp, gs / vol


class D3Dispersion:
    """D3 with an Angstrom / eV interface (JAX ``D3Dispersion``; the
    reference's ``pair_style d3 rthr cn_thr damping functional``,
    pair_d3.cu:262-301). ``rthr`` and ``cn_thr`` are squared cutoffs in
    bohr^2, as in the pair style's arguments. Runs on ``device`` (the card
    unless the caller asks for the CPU); every damping is differentiable.
    The MD engine takes one as ``d3=`` and uses its parameters."""

    def __init__(self, damping: str = 'damp_bj', functional: str = 'pbe',
                 rthr: float = 9000.0, cn_thr: float = 1600.0,
                 dtype=torch.float32, shift_chunk: int = 16, device='cuda'):
        self.damping = get_damping_params(damping, functional)
        self.rthr = float(rthr)
        self.cn_thr = float(cn_thr)
        self.dtype = dtype
        self.shift_chunk = int(shift_chunk)
        self.device = torch.device(device)
        self._tables: Optional[D3Tables] = None
        self._z_key: Optional[Tuple[int, ...]] = None

    def _tables_for(self, z_unique: np.ndarray) -> D3Tables:
        key = tuple(int(v) for v in z_unique)
        if key != self._z_key:
            self._tables = build_tables(z_unique, self.dtype, self.device)
            self._z_key = key
        return self._tables

    def compute(self, atomic_numbers, pos_ang, cell_ang=None, pbc=None):
        """{'energy': eV, 'forces': (N, 3) eV/A, 'stress': (3, 3) eV/A^3
        (dE/d(strain) / V)}; a system with no periodic axis is summed in
        a cell wide enough to hold no replica."""
        z = np.asarray(atomic_numbers, dtype=np.int64)
        pos = np.asarray(pos_ang, dtype=np.float32) / AU_TO_ANG
        if cell_ang is None or pbc is None or not np.any(pbc):
            cell = np.eye(3) * (2.0 * np.sqrt(self.rthr) + 1.0)
            pbc = np.zeros(3, bool)
        else:
            cell = np.asarray(cell_ang, dtype=np.float64)
            pbc = np.asarray(pbc, bool)
        lat = cell / AU_TO_ANG
        z_unique, tidx = np.unique(z, return_inverse=True)
        c = self.shift_chunk
        dev, dt = self.device, self.dtype

        def shifts(r2):
            s = lattice_shifts(lat, pbc, np.sqrt(r2), c).reshape(-1, c, 3)
            return torch.as_tensor(s, dtype=dt, device=dev)

        e, f, sig = _energy_forces_stress(
            torch.as_tensor(pos, dtype=dt, device=dev),
            torch.as_tensor(lat, dtype=dt, device=dev),
            torch.as_tensor(tidx.reshape(-1), device=dev),
            self._tables_for(z_unique), self.damping, shifts(self.rthr),
            shifts(self.cn_thr), self.rthr, self.cn_thr)
        return {
            'energy': float(e) * AU_TO_EV,
            'forces': f.cpu().numpy() * (AU_TO_EV / AU_TO_ANG),
            'stress': sig.cpu().numpy() * (AU_TO_EV / AU_TO_ANG ** 3),
        }
