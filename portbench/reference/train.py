"""Training steps of the plain reference: the per-atom energy, force and
stress Huber losses of a batch (forces -dE/dpos and stress -(1/V)
dE/dstrain in Voigt xx yy zz xy yz zx, both by autograd with the graph
kept), their gradient with respect to every trainable parameter, and
Adam (bias-corrected, eps outside the square root)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .model import ReferenceModel
from .neighbors import edge_list

KBAR = 1602.1766208     # eV/A^3 -> kbar


def huber(err: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(err)
    return torch.where(a < delta, 0.5 * a * a, delta * (a - 0.5 * delta))


def batch_graph(structs: List[Dict], cutoff: float, device):
    """Concatenated atoms of a batch: (pos, z, edges, graph, cells)."""
    pos, z, dst, src, shift, graph, cells = [], [], [], [], [], [], []
    off = 0
    for g, s in enumerate(structs):
        p = torch.as_tensor(s['pos'], dtype=torch.float32, device=device)
        c = torch.as_tensor(s['cell'], dtype=torch.float64, device=device)
        d, sr, sh = edge_list(p, c, cutoff)
        pos.append(p)
        z.append(s['z'])
        dst.append(d + off)
        src.append(sr + off)
        shift.append(sh)
        graph.append(torch.full((len(s['z']),), g, dtype=torch.long,
                                device=device))
        cells.append(c)
        off += len(s['z'])
    return (torch.cat(pos), np.concatenate(z),
            (torch.cat(dst), torch.cat(src), torch.cat(shift)),
            torch.cat(graph), torch.stack(cells))


def loss(model: ReferenceModel, structs: List[Dict], job: Dict, device):
    """The batch's total loss, differentiable in the model's parameters."""
    pos, z, edges, graph, cells = batch_graph(structs, model.cutoff, device)
    n_g = len(structs)
    pos = pos.detach().requires_grad_(True)
    strain = torch.zeros((n_g, 3, 3), dtype=pos.dtype, device=device,
                         requires_grad=True)
    e = model.energies(pos, z, edges, graph, n_g, strain, block=None)
    g_pos, g_eps = torch.autograd.grad(e.sum(), [pos, strain],
                                       create_graph=True)
    forces = -g_pos
    vol = torch.abs(torch.linalg.det(cells)).to(pos.dtype)
    voigt = torch.stack([g_eps[:, 0, 0], g_eps[:, 1, 1], g_eps[:, 2, 2],
                         g_eps[:, 0, 1], g_eps[:, 1, 2], g_eps[:, 2, 0]], 1)
    stress = -voigt / vol[:, None]
    n_at = torch.as_tensor([len(s['z']) for s in structs], dtype=pos.dtype,
                           device=device)
    ref_e = torch.as_tensor([s['energy'] for s in structs], dtype=pos.dtype,
                            device=device)
    ref_f = torch.as_tensor(np.concatenate([s['forces'] for s in structs]),
                            dtype=pos.dtype, device=device)
    ref_s = torch.as_tensor(np.stack([s['stress'] for s in structs]),
                            dtype=pos.dtype, device=device)
    d = job['loss_param']['delta']
    l_e = huber(e / n_at - ref_e / n_at, d).mean()
    l_f = huber(forces - ref_f, d).mean()
    l_s = huber((stress - ref_s) * KBAR, d).mean()
    return (l_e + job['force_loss_weight'] * l_f
            + job['stress_loss_weight'] * l_s)


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))


def train_steps(cfg: Dict, theta0: Dict[str, torch.Tensor],
                trainable: Dict[str, bool], type_map, batches: List[List],
                job: Dict, device) -> Dict:
    """The reference's steps over ``batches`` from the flat parameters
    ``theta0``: each step's loss, the first step's gradient and the
    parameters after the last step."""
    flat = {k: v.detach().clone().requires_grad_(trainable[k])
            for k, v in theta0.items()}
    tree: Dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split('/')
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    model = ReferenceModel(cfg, tree, type_map, device)
    keys = [k for k in flat if trainable[k]]
    opt = Adam({k: flat[k] for k in keys}, job['optim_param']['lr'])
    losses, g1 = [], None
    for structs in batches:
        tot = loss(model, structs, job, device)
        grads = torch.autograd.grad(tot, [flat[k] for k in keys],
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(flat[k]))
                 for k, g in zip(keys, grads)}
        if g1 is None:
            g1 = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(grads)
        losses.append(float(tot.detach()))
    return {'losses': losses, 'g1': g1,
            'theta': {k: v.detach().clone() for k, v in flat.items()}}
