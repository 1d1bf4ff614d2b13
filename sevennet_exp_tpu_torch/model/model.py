"""SevenNetModel: the whole network as one ``nn.Module``.

Counterpart of ``sevennet_exp_tpu/model/model.py``. ``energy`` runs the
layer sequence over the data dict; ``energy_and_forces`` takes forces
as -dE/dpos by autograd through whatever builds the data from the
positions (on the dense grid: the scatter-free pair gather of
``ops/scatter.gather_pair``). ``apply`` is the single-point form: the
gradient with respect to the edge vectors, from which it assembles the
forces and the virial stress (the calculator's path);
``energy_forces_stress`` is the engine's form of the same on the dense
grid (NPT).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import _keys as KEY
from ..ops.fused_conv import USE_KERNELS_KEY
from ..ops.scatter import scatter_sum

Data = Dict[str, Any]


class SevenNetModel(nn.Module):
    def __init__(self, layers: List[Tuple[str, nn.Module]],
                 config: Dict[str, Any], type_map: Dict[int, int],
                 cutoff: float, modal_map: Optional[Dict[str, int]] = None):
        super().__init__()
        self.layers = nn.ModuleDict(layers)
        self.config = config
        self.type_map = dict(type_map)
        self.cutoff = float(cutoff)
        # modality name -> MODAL_TYPE index (empty: a single-modal model)
        self.modal_map = dict(modal_map or {})
        lut = np.full(120, -1, dtype=np.int64)
        for z, idx in self.type_map.items():
            lut[z] = idx
        self.register_buffer('z_to_onehot', torch.from_numpy(lut))

    # -- parameters ----------------------------------------------------
    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """(params, trainable_mask) trees keyed by layer name, drawn from
        ``generator`` (CPU float32 tensors; JAX ``SevenNetModel.init``).
        ``load_state(flatten(params))`` puts them into the model."""
        params, mask = {}, {}
        for name, layer in self.layers.items():
            if hasattr(layer, 'init'):
                params[name], mask[name] = layer.init(generator)
        return params, mask

    def param_tree(self) -> Dict[str, Any]:
        """Parameter buffers in the JAX pytree layout {layer: {...}}."""
        return {name: layer.param_tree()
                for name, layer in self.layers.items()
                if hasattr(layer, 'param_tree')}

    def conv_routes(self, agg_d: int = 0,
                    use_kernels: bool = True) -> List[Dict[str, Any]]:
        """One entry per convolution: its ``route`` on a grid of degree
        ``agg_d`` (0: the plain edge list of the calculator and the
        trainer), 'kernel' (the fused conv: its kernels on the card) or
        'plain' (the plain chain on any device), and the ``refusal`` that
        sends it down the plain chain (None on the kernel route)."""
        from .layers import IrrepsConvolution
        out = []
        for name, layer in self.layers.items():
            if not isinstance(layer, IrrepsConvolution):
                continue
            why = (layer.kernel_refusal(agg_d) if use_kernels
                   else 'use_kernels is off')
            out.append({'layer': name, 'route': 'plain' if why else 'kernel',
                        'refusal': why})
        return out

    def state(self) -> Dict[str, torch.Tensor]:
        """Flat {'layer/sub/key': tensor} view of ``param_tree``."""
        return flatten(self.param_tree())

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

    def walk(self, data: Data):
        """The layer sequence as a generator: before every convolution it
        yields NODE_FEATURE and continues with the rows it is sent back;
        it returns the output dict. ``apply_energy`` drives one walk; the
        brick engine drives one walk a brick in lockstep, so that every
        brick's ghost rows are refreshed from its neighbours' rows of the
        same layer (``parallel/mdbrick.py``)."""
        from .layers import IrrepsConvolution
        data = self.preprocess(data)
        for layer in self.layers.values():
            if isinstance(layer, IrrepsConvolution):
                data[KEY.NODE_FEATURE] = yield data[KEY.NODE_FEATURE]
            data = layer(data)
        return data

    def apply_energy(self, data: Data, halo_refresh=None) -> Data:
        """halo_refresh(x): refreshes the ghost rows of the node features
        before every convolution (domain-decomposed MD; the JAX
        ``apply_energy``'s hook, the analog of the reference's
        between-segment forward_comm, pair_e3gnn_parallel.cpp:355-387).
        None leaves them as they are."""
        walk = self.walk(data)
        x = None
        try:
            while True:
                x = walk.send(x)
                if halo_refresh is not None:
                    x = halo_refresh(x)
        except StopIteration as done:
            return done.value

    def energy(self, data: Data) -> torch.Tensor:
        return torch.sum(self.apply_energy(data)[KEY.PRED_TOTAL_ENERGY])

    def energy_and_forces(self, pos: torch.Tensor,
                          make_data: Callable[[torch.Tensor], Data],
                          extra: Optional[Callable] = None):
        """(E, F = -dE/dpos); make_data(pos) builds the graph inputs.
        extra(pos): an energy added before the backward pass (the MD
        engine's D3)."""
        with torch.enable_grad():
            pos = pos.detach().requires_grad_(True)
            e = self.energy(make_data(pos))
            if extra is not None:
                e = e + extra(pos)
            (g,) = torch.autograd.grad(e, pos)
        return e.detach(), -g

    def energy_forces_stress(self, pos: torch.Tensor, cell: torch.Tensor,
                             make_data: Callable[[torch.Tensor], Data],
                             extra: Optional[Callable] = None):
        """(E, F, stress Voigt xx yy zz xy yz zx) on the cell ``cell``, the
        stress in the model convention: -dE/d(strain)/V at zero strain,
        the strain acting on the edge vectors as ``vec + vec @ strain``
        (the JAX engine's ``_efs_fn``). One backward pass gives both
        gradients: with fij = dE/d(EDGE_VEC) of the data ``make_data(pos)``
        builds, dE/d(strain)[b, a] = sum_e vec[e, b] fij[e, a], summed in
        float64 as ``apply`` sums its virial. The six entries are taken from
        the unsymmetrised gradient, as the JAX engine takes them.
        extra(pos, strain): an energy added before the backward pass, whose
        strain gradient joins the model's (the MD engine's D3, on positions
        and lattice under the strain)."""
        with torch.enable_grad():
            pos = pos.detach().requires_grad_(True)
            data = make_data(pos)
            vec = data[KEY.EDGE_VEC]
            e = self.energy(data)
            if extra is None:
                g, fij = torch.autograd.grad(e, [pos, vec])
            else:
                strain = torch.zeros((3, 3), dtype=pos.dtype,
                                     device=pos.device, requires_grad=True)
                e = e + extra(pos, strain)
                g, fij, g_strain = torch.autograd.grad(e, [pos, vec, strain])
        ge = vec.detach().double().T @ fij.double()
        if extra is not None:
            ge = ge + g_strain.double()
        c = cell.detach().double()
        vol = torch.abs(torch.dot(c[0], torch.linalg.cross(c[1], c[2])))
        stress = -torch.stack([ge[0, 0], ge[1, 1], ge[2, 2], ge[0, 1],
                               ge[1, 2], ge[2, 0]]) / vol
        return e.detach(), -g, stress.to(pos.dtype)

    def apply(self, data: Data, compute_stress: bool = True,
              create_graph: bool = False) -> Data:
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
        six numbers.

        ``create_graph``: energy, forces and stress stay differentiable
        with respect to the parameters that require a gradient (the
        trainer's loss). Then the data must be a plain edge list with
        ``USE_KERNELS_KEY`` False: the dense grid's gathers and the fused
        conv have first-order backwards only."""
        edge_vec0 = data[KEY.EDGE_VEC]
        if create_graph and (KEY.EDGE_REV in data
                             or data.get(USE_KERNELS_KEY, True)):
            raise ValueError('create_graph runs the plain chain on the plain '
                             'edge list: no EDGE_REV, USE_KERNELS_KEY False')
        with torch.enable_grad():
            edge_vec = edge_vec0.detach().requires_grad_(True)
            out = self.apply_energy(dict(data, **{KEY.EDGE_VEC: edge_vec}))
            energy = torch.sum(out[KEY.PRED_TOTAL_ENERGY])
            (fij,) = torch.autograd.grad(energy, edge_vec,
                                         create_graph=create_graph)
        if not create_graph:
            out = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in out.items()}
        with torch.set_grad_enabled(create_graph):
            return self._forces_stress(data, out, edge_vec0, fij,
                                       compute_stress)

    @staticmethod
    def _forces_stress(data: Data, out: Data, edge_vec0, fij,
                       compute_stress: bool) -> Data:
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


def flatten(tree, prefix=''):
    """{'layer': {'sub': {'key': leaf}}} -> {'layer/sub/key': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, dict):
            out.update(flatten(v, key + '/'))
        else:
            out[key] = v
    return out
