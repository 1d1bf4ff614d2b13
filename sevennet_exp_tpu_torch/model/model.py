"""SevenNetModel: the whole network as one ``nn.Module``.

Counterpart of ``sevennet_exp_tpu/model/model.py``. ``energy`` runs the
layer sequence over the data dict; ``energy_and_forces`` takes forces
as -dE/dpos by autograd through whatever builds the data from the
positions (on the dense grid: the scatter-free pair gather of
``ops/scatter.gather_pair``). ``apply`` is the single-point form: the
gradient with respect to the edge vectors, from which it assembles the
forces and the virial stress (the calculator's path).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .. import _keys as KEY
from ..ops.scatter import scatter_sum

Data = Dict[str, Any]


class SevenNetModel(nn.Module):
    def __init__(self, layers: List[Tuple[str, nn.Module]],
                 config: Dict[str, Any], type_map: Dict[int, int],
                 cutoff: float):
        super().__init__()
        self.layers = nn.ModuleDict(layers)
        self.config = config
        self.type_map = dict(type_map)
        self.cutoff = float(cutoff)
        lut = np.full(120, -1, dtype=np.int64)
        for z, idx in self.type_map.items():
            lut[z] = idx
        self.register_buffer('z_to_onehot', torch.from_numpy(lut))

    # -- parameters ----------------------------------------------------
    def param_tree(self) -> Dict[str, Any]:
        """Parameter buffers in the JAX pytree layout {layer: {...}}."""
        return {name: layer.param_tree()
                for name, layer in self.layers.items()
                if hasattr(layer, 'param_tree')}

    def state(self) -> Dict[str, torch.Tensor]:
        """Flat {'layer/sub/key': tensor} view of ``param_tree``."""
        return _flatten(self.param_tree())

    @torch.no_grad()
    def load_state(self, state: Dict[str, torch.Tensor]):
        """Copy a flat state (``checkpoint.params_from_numpy``) into the
        buffers; every buffer must be given, with its exact shape."""
        mine = self.state()
        missing = sorted(set(mine) - set(state))
        extra = sorted(set(state) - set(mine))
        if missing or extra:
            raise KeyError(f'state mismatch: missing {missing}, '
                           f'unexpected {extra}')
        for k, dst in mine.items():
            src = state[k]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f'{k}: shape {tuple(src.shape)} != '
                                 f'{tuple(dst.shape)}')
            dst.copy_(src)

    # -- forward -------------------------------------------------------
    def preprocess(self, data: Data) -> Data:
        """Z -> one-hot index lookup (reference sequential.py:130-168)."""
        data = dict(data)
        data[KEY.NODE_FEATURE] = self.z_to_onehot[
            data[KEY.ATOMIC_NUMBERS].long()]
        return data

    def apply_energy(self, data: Data) -> Data:
        data = self.preprocess(data)
        for layer in self.layers.values():
            data = layer(data)
        return data

    def energy(self, data: Data) -> torch.Tensor:
        return torch.sum(self.apply_energy(data)[KEY.PRED_TOTAL_ENERGY])

    def energy_and_forces(self, pos: torch.Tensor,
                          make_data: Callable[[torch.Tensor], Data]):
        """(E, F = -dE/dpos); make_data(pos) builds the graph inputs."""
        with torch.enable_grad():
            pos = pos.detach().requires_grad_(True)
            e = self.energy(make_data(pos))
            (g,) = torch.autograd.grad(e, pos)
        return e.detach(), -g


    def apply(self, data: Data, compute_stress: bool = True) -> Data:
        """Energy + forces (+ stress) from one gradient with respect to
        EDGE_VEC (reference force_output.py:167-224):

          fij    = dE/d(edge_vec)
          F_i    = sum_{e: i=edge_idx[0]} fij - sum_{e: i=edge_idx[1]} fij
          virial = -(sum_e over graph r_ij (x) f_ij) / volume, Voigt
                   (xx, yy, zz, xy, yz, zx)

        On a symmetric dense grid (EDGE_REV + EDGE_DENSE_D) both force
        sums are reshape-sums, the second one after a gather by ``rev``;
        on a plain edge list they are two ``index_add_`` scatters. The
        per-graph virial is summed in float64 (as ``AtomReduce`` sums the
        energies): tens of thousands of float32 terms of both signs into
        six numbers."""
        edge_vec0 = data[KEY.EDGE_VEC]
        with torch.enable_grad():
            edge_vec = edge_vec0.detach().requires_grad_(True)
            out = self.apply_energy(dict(data, **{KEY.EDGE_VEC: edge_vec}))
            energy = torch.sum(out[KEY.PRED_TOTAL_ENERGY])
            (fij,) = torch.autograd.grad(energy, edge_vec)
        out = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in out.items()}
        edge_idx = data[KEY.EDGE_IDX]
        n_nodes = data[KEY.ATOMIC_NUMBERS].shape[0]
        rev, dd = data.get(KEY.EDGE_REV), data.get(KEY.EDGE_DENSE_D)
        if rev is not None and dd is not None:
            pf = scatter_sum(fij, None, n_nodes, dense_d=dd)
            nf = scatter_sum(fij[rev], None, n_nodes, dense_d=dd)
        else:
            pf = scatter_sum(fij, edge_idx[0], n_nodes)
            nf = scatter_sum(fij, edge_idx[1], n_nodes)
        out[KEY.PRED_FORCE] = pf - nf
        if compute_stress:
            rij = edge_vec0.detach().double()
            f64 = fij.double()
            virial = torch.cat([
                rij * f64,
                (rij[:, 0] * f64[:, 1])[:, None],
                (rij[:, 1] * f64[:, 2])[:, None],
                (rij[:, 2] * f64[:, 0])[:, None]], dim=-1)
            num_graphs = data[KEY.NUM_ATOMS].shape[0]
            sout = scatter_sum(virial, data[KEY.BATCH][edge_idx[1]],
                               num_graphs)
            vol = data[KEY.CELL_VOLUME].double()
            out[KEY.PRED_STRESS] = (-sout / vol[..., None]).to(fij.dtype)
        return out


def _flatten(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(_flatten(v, key + '/'))
        else:
            out[key] = v
    return out
