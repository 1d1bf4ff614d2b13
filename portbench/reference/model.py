"""SevenNet-0 (the NequIP form of the 7net-0 family: linear self-connection,
one cutoff, species-wise rescale, linear readout) as plain float32 PyTorch.

The energy is a function of the positions: each convolution runs over a
plain edge list (pairs inside the cutoff, both directions), its edges in
blocks under ``torch.utils.checkpoint`` so that one block's intermediates
live at a time, and the forces are -dE/dpos by autograd. The layer order,
the ir_mul feature layout and the normalisations are e3nn's as the model
defines them (``tensor_product.py``); the parameters are the checkpoint's
numpy tree, read by ``checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .irreps import Irrep, Irreps, infer_irreps_out
from .radial import BesselBasis, PolynomialCutoff, XPLORCutoff
from .spherical import spherical_harmonics
from .tensor_product import (
    FullyConnectedNetSpec,
    GateSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

# edges per checkpointed block: ~24 KB of saved intermediates an edge at
# 7net-0 width, so ~3 GB live while one block's backward runs
EDGE_BLOCK = 131072


class Conv:
    """One interaction block's shapes: the self-connection and si1
    linears, the uvu tensor product, its radial MLP and si2, the gate."""

    def __init__(self, t, irreps_x, irreps_filter, irreps_out, parity_mode,
                 hidden, act_radial, act_scalar, act_gate, bias):
        self.t = t
        self.gate = GateSpec(irreps_out, act_scalar, act_gate)
        gate_in = self.gate.irreps_in
        self.sc = LinearSpec(irreps_x, gate_in, biases=bias)
        self.si1 = LinearSpec(irreps_x, irreps_x, biases=bias)
        tp_out = infer_irreps_out(irreps_x, irreps_filter, irreps_out.lmax,
                                  parity_mode, False)
        self.tp = UVUTensorProductSpec(irreps_x, irreps_filter, tp_out)
        self.mlp = FullyConnectedNetSpec(
            hs=tuple(hidden + [self.tp.weight_numel]), act=act_radial)
        self.si2 = LinearSpec(self.tp.irreps_out, gate_in, biases=bias)


def build_specs(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The model's static shapes from a configuration's sizes."""
    irreps = [Irreps(s) for s in cfg['irreps_manual']]
    parity = -1 if cfg['is_parity'] else 1
    irreps_filter = Irreps.spherical_harmonics(cfg['lmax'], parity)
    nb = cfg['radial_basis']['bessel_basis_num']
    hidden = [nb] + list(cfg['weight_nn_hidden_neurons'])
    p_map = {'e': 1, 'o': -1}
    act_scalar = {p_map[k]: v for k, v in cfg['act_scalar'].items()}
    act_gate = {p_map[k]: v for k, v in cfg['act_gate'].items()}
    n_conv = cfg['num_convolution_layer']
    convs = []
    for t in range(n_conv):
        mode = 'even' if t == n_conv - 1 else 'full'
        convs.append(Conv(t, irreps[t], irreps_filter, irreps[t + 1], mode,
                          hidden, cfg['act_radial'], act_scalar, act_gate,
                          cfg['use_bias_in_linear']))
    n_species = len(cfg['chemical_species'])
    hid = Irreps([(irreps[-1].dim // 2, Irrep(0, 1))])
    return dict(
        embed=LinearSpec(Irreps(f'{n_species}x0e'), irreps[0],
                         biases=cfg['use_bias_in_linear']),
        convs=convs, lmax=cfg['lmax'], nb=nb,
        readout1=LinearSpec(irreps[-1], hid,
                            biases=cfg['use_bias_in_linear']),
        readout2=LinearSpec(hid, Irreps('1x0e'),
                            biases=cfg['use_bias_in_linear']))


class ReferenceModel:
    """E(pos) of one periodic structure; ``cfg`` the configuration's
    sizes, ``params`` the checkpoint's numpy tree, ``type_map`` atomic
    number -> type index (the checkpoint's)."""

    def __init__(self, cfg: Dict[str, Any], params: Dict[str, Any],
                 type_map: Dict[int, int], device):
        self.cfg = cfg
        self.specs = build_specs(cfg)
        self.device = torch.device(device)
        self.cutoff = float(cfg['cutoff'])
        cf = cfg['cutoff_function']
        if cf['cutoff_function_name'] == 'XPLOR':
            self.env = XPLORCutoff(self.cutoff, float(cf['cutoff_on']))
        else:
            self.env = PolynomialCutoff(self.cutoff, int(cf.get('poly_cut_p_value', 6)))
        self.basis = BesselBasis(self.cutoff, self.specs['nb'])
        self.type_map = {int(k): int(v) for k, v in type_map.items()}

        def t(a):
            if torch.is_tensor(a):
                return a
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.p = {layer: ({k: (t(v) if not isinstance(v, dict)
                               else {kk: t(vv) for kk, vv in v.items()})
                           for k, v in sub.items()})
                  for layer, sub in params.items()}

    def _types(self, z: np.ndarray) -> torch.Tensor:
        return torch.as_tensor([self.type_map[int(v)] for v in z],
                               device=self.device)

    def _conv_rows(self, conv: Conv, x, src, dst, vec, n: int, denom):
        """sum over a block of edges of TP(x[src], Y(vec); MLP(|vec|)),
        added onto the destination atoms."""
        r = torch.sqrt(torch.sum(vec * vec, dim=-1))
        emb = (self.basis.apply({'coeffs': self.p['edge_embedding']['coeffs']},
                                r) * self.env.apply(r)[:, None])
        sh = spherical_harmonics(self.specs['lmax'], vec, normalize=True,
                                 normalization='component')
        w = conv.mlp.apply(self.p[f'{conv.t}_convolution']['weight_nn'],
                           emb) / denom
        msg = conv.tp.apply(x[src], sh, w)
        return x.new_zeros((n, msg.shape[1])).index_add(0, dst, msg)

    def energies(self, pos: torch.Tensor, z: np.ndarray, edges,
                 graph: torch.Tensor = None, n_graphs: int = 1,
                 strain: torch.Tensor = None,
                 block: int = EDGE_BLOCK) -> torch.Tensor:
        """Energy (eV) of each of ``n_graphs`` structures whose atoms are
        concatenated (``graph``: each atom's structure; None: one).
        ``edges`` = (dst, src, shift) from ``neighbors.edge_list`` with
        the structures' atom offsets: vec = pos[src] - pos[dst] + shift,
        formed in float64 and rounded once to ``pos``'s dtype; with
        ``strain`` (n_graphs, 3, 3) each vector becomes vec + vec @ strain
        of its structure. ``block``: edges a checkpointed block (None: no
        checkpointing, so that gradients of gradients can be taken)."""
        dst, src, shift = edges
        n = pos.shape[0]
        p64 = pos.double()
        vec = (p64[src] - p64[dst] + shift).to(pos.dtype)
        if graph is None:
            graph = torch.zeros(n, dtype=torch.long, device=pos.device)
        if strain is not None:
            vec = vec + torch.einsum('ea,eab->eb', vec, strain[graph[dst]])
        types = self._types(z)
        n_species = len(self.cfg['chemical_species'])
        x = torch.nn.functional.one_hot(types, n_species).to(pos.dtype)
        x = self.specs['embed'].apply(self.p['onehot_to_feature_x'], x)
        for conv in self.specs['convs']:
            t = conv.t
            sc = conv.sc.apply(self.p[f'{t}_self_connection_intro'], x)
            x = conv.si1.apply(self.p[f'{t}_self_interaction_1'], x)
            cp = self.p[f'{t}_convolution']
            denom = cp['denominator'][0]
            if block is None:
                agg = self._conv_rows(conv, x, src, dst, vec, n, denom)
            else:
                agg = None
                for b0 in range(0, dst.shape[0], block):
                    b1 = b0 + block
                    part = checkpoint(self._conv_rows, conv, x, src[b0:b1],
                                      dst[b0:b1], vec[b0:b1], n, denom,
                                      use_reentrant=False)
                    agg = part if agg is None else agg + part
            x = conv.si2.apply(cp['si2'], agg)
            x = x + sc
            x = conv.gate.apply(x)
        h = self.specs['readout1'].apply(self.p['reduce_input_to_hidden'], x)
        e_scaled = self.specs['readout2'].apply(
            self.p['reduce_hidden_to_energy'], h)[:, 0]
        rs = self.p['rescale_atomic_energy']
        e_atom = e_scaled * rs['scale'][types] + rs['shift'][types]
        return e_atom.double().new_zeros(n_graphs).index_add(
            0, graph, e_atom.double()).to(pos.dtype)

    def energy(self, pos: torch.Tensor, z: np.ndarray, edges) -> torch.Tensor:
        """Total energy (eV) of one structure (see ``energies``)."""
        return self.energies(pos, z, edges)[0]


def energy_forces(fn, pos: torch.Tensor):
    """(E, F = -dE/dpos) of an energy function of the positions."""
    with torch.enable_grad():
        p = pos.detach().clone().requires_grad_(True)
        e = fn(p)
        (g,) = torch.autograd.grad(e, p)
    return e.detach(), -g


def param_leaves(params: Dict[str, Any], prefix: str = '') -> List[str]:
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += param_leaves(v, f'{prefix}{k}/')
        else:
            out.append(f'{prefix}{k}')
    return out
