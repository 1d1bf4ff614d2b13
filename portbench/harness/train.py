"""A training cell: the program's ``Trainer.train_step`` fed by its
``GraphLoader`` on the dataset in an order drawn from the seed, from
initial parameters the harness draws from the seed, and the check of the
first steps against the plain reference.

Set-up builds one trainer and drives it through its first ``check_steps``
steps by the window's own call and feed (distinct structures in every
batch); those are the steps compared, and the same trainer goes on into
the measured window. Compared: each step's loss; the first gradient as
the optimizer got it (Adam's first moment after one step over (1 - beta1)),
leaf by leaf by its norm; the parameters' change over the checked steps,
leaf by leaf by its norm. A leaf's gap is measured against the larger of
its own reference norm and the median leaf's. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off
alone and are left out of the change.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..reference.model import build_specs
from ..reference.neighbors import edge_list
from ..reference.train import train_steps
from . import trace as tr
from . import traffic
from .md import checkpoint_config

# leaves the configuration does not train (train_denominator and
# train_shift_scale false)
FROZEN = ('denominator', 'rescale_atomic_energy/')


def initial_parameters(ck: Dict, seed: int, device) -> Dict[str, Any]:
    """Flat parameters from the seed, on the device in one draw: weights
    N(0, 1) (the model normalises them in its forward pass), the Bessel
    frequencies n pi / cutoff, the denominator and the per-species shift
    and scale of the checkpoint's dataset statistics."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f'{prefix}{k}/')
            else:
                flat[f'{prefix}{k}'] = np.asarray(v, np.float32)

    walk(ck['params'], '')
    weights = [k for k in flat if k.rsplit('/', 1)[1].startswith('w')]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    draw = torch.randn(sum(flat[k].size for k in weights), generator=gen,
                       device=device)
    out, off = {}, 0
    for k, v in flat.items():
        if k in weights:
            out[k] = draw[off:off + v.size].reshape(v.shape)
            off += v.size
        elif k.endswith('coeffs'):
            cutoff = float(ck['config']['cutoff'])
            out[k] = torch.arange(1, v.size + 1, device=device,
                                  dtype=torch.float32) * np.pi / cutoff
        else:
            out[k] = torch.as_tensor(v, device=device)
    return out


def trainable(flat: Dict) -> Dict[str, bool]:
    return {k: not any(f in k for f in FROZEN) for k in flat}


def _tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split('/')
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def job_config(mix: Dict) -> Dict:
    keys = ('loss', 'loss_param', 'optimizer', 'optim_param', 'scheduler',
            'scheduler_param', 'force_loss_weight', 'stress_loss_weight',
            'is_train_stress', 'error_record')
    return {k: mix[k] for k in keys}


class Feed:
    """The window's feed: the loader's batches, epoch after epoch, each
    copied to the device; the host's time for it is counted."""

    def __init__(self, loader, trainer):
        self.loader, self.trainer = loader, trainer
        self.it = iter(loader)
        self.host_s = 0.0
        self.steps = 0

    def step(self):
        t0 = time.perf_counter()
        try:
            batch = next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            batch = next(self.it)
        dev = self.trainer.batch_to_device(batch)
        self.host_s += time.perf_counter() - t0
        self.trainer.train_step(dev)
        self.steps += 1


def program_setup(ck: Dict, mix: Dict, structs: List[Dict], order,
                  theta0: Dict[str, torch.Tensor], device):
    from sevennet_exp_tpu_torch import _keys as KEY
    from sevennet_exp_tpu_torch.data.graph import (
        Atoms,
        atoms_to_graph,
        pad_cap,
    )
    from sevennet_exp_tpu_torch.data.loader import GraphLoader
    from sevennet_exp_tpu_torch.model.build import \
        build_e3_equivariant_model
    from sevennet_exp_tpu_torch.train.trainer import Trainer

    cutoff = float(ck['config']['cutoff'])
    graphs = [atoms_to_graph(Atoms(
        atomic_numbers=s['z'], pos=s['pos'], cell=s['cell'],
        pbc=np.array([True] * 3), energy=s['energy'], forces=s['forces'],
        stress=s['stress']), cutoff) for s in (structs[i] for i in order)]
    # capacities against the worst batch the dataset can form, as the
    # program's shuffling loader pads, so that every seed's order pads to
    # the same shapes
    b = int(mix['batch_size'])
    nodes = sorted((int(g[KEY.NUM_ATOMS]) for g in graphs), reverse=True)
    edges = sorted((g[KEY.EDGE_IDX].shape[1] for g in graphs), reverse=True)
    loader = GraphLoader(graphs, b, shuffle=False, drop_last=True,
                         n_node=pad_cap(sum(nodes[:b]), multiple=8),
                         n_edge=pad_cap(sum(edges[:b]), multiple=128))
    model = build_e3_equivariant_model(dict(ck['config']))
    host = {k: v.detach().cpu().numpy() for k, v in theta0.items()}
    mask = trainable(host)
    trainer = Trainer(model, params=_tree(host), trainable_mask=_tree(mask),
                      config=job_config(mix), device=device)
    return trainer, loader


def check_steps(trainer, feed: Feed, n: int) -> Dict:
    """The first ``n`` steps through the window's feed, with the loss of
    each, the first gradient (from Adam's state) and the parameters after
    the n-th step."""
    losses = []
    orig = trainer._loss_fn

    def tapped(batch, create_graph):
        tot, parts, out = orig(batch, create_graph)
        losses.append(float(tot.detach()))
        return tot, parts, out

    trainer._loss_fn = tapped
    g1 = None
    beta1 = trainer.optimizer.param_groups[0]['betas'][0]
    for i in range(n):
        feed.step()
        if i == 0:
            # a step that never reached the optimizer leaves no moment
            g1 = {k: trainer.optimizer.state.get(p, {}).get(
                      'exp_avg', torch.zeros_like(p)).detach().clone()
                  / (1 - beta1) for k, p in trainer.params.items()
                  if p.requires_grad}
    del trainer._loss_fn
    theta = {k: p.detach().clone() for k, p in trainer.params.items()}
    return {'losses': losses, 'g1': g1, 'theta': theta}


def moved_leaves(ref: Dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of
    the median leaf's: the others move by round-off alone."""
    norms = {k: float(torch.linalg.norm(g)) for k, g in ref['g1'].items()}
    med = float(np.median(list(norms.values())))
    return sorted(k for k, v in norms.items() if v >= 1e-3 * med)


def compare(got: Dict, ref: Dict, theta0: Dict) -> Dict[str, float]:
    """The numbers compared (see the module's docstring)."""
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(got['losses'], ref['losses']))
    keys = sorted(ref['g1'])
    gn_ref = {k: float(torch.linalg.norm(ref['g1'][k])) for k in keys}
    med_g = float(np.median(list(gn_ref.values())))
    grad = max(abs(float(torch.linalg.norm(got['g1'][k])) - gn_ref[k])
               / max(gn_ref[k], med_g) for k in keys)
    moved = moved_leaves(ref)
    d_ref = {k: float(torch.linalg.norm(ref['theta'][k] - theta0[k]))
             for k in moved}
    med_d = float(np.median(list(d_ref.values())))
    upd = max(abs(float(torch.linalg.norm(got['theta'][k] - theta0[k]))
                  - d_ref[k]) / max(d_ref[k], med_d) for k in moved)
    return {'loss_err': loss, 'grad_err': grad, 'update_err': upd}


def reference(ck: Dict, cfg: Dict, mix: Dict, structs, order, theta0,
              device, tf32: bool = False) -> Dict:
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    b = int(mix['batch_size'])
    batches = [[structs[j] for j in order[i * b:(i + 1) * b]]
               for i in range(int(mix['check_steps']))]
    try:
        return train_steps(cfg['model'], theta0, trainable(theta0),
                           ck['config']['_type_map'], batches, mix, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def mean_edges(structs: List[Dict], cutoff: float, device) -> float:
    """Edges inside the cutoff a structure, over the dataset."""
    return float(np.mean([len(edge_list(
        torch.as_tensor(s['pos'], dtype=torch.float32, device=device),
        torch.as_tensor(s['cell'], device=device), cutoff)[0])
        for s in structs]))


def run(cell: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, root: str, t_start: float,
        readers: Callable[[Dict], Dict]) -> Dict[str, Any]:
    cfg = cell['config']
    ck = checkpoint_config(cfg, root)
    structs, order = traffic.train_inputs(mix, seed, root)
    theta0 = initial_parameters(ck, seed, device)
    trainer, loader = program_setup(ck, mix, structs, order, theta0, device)
    feed = Feed(loader, trainer)
    got = check_steps(trainer, feed, int(mix['check_steps']))
    if device.type == 'cuda':
        torch.cuda.synchronize()
    prof = tr.profiler() if trace else None
    if prof:
        prof.start()
    setup_s = time.perf_counter() - t_start
    feed.host_s, feed.steps = 0.0, 0
    mark = torch.profiler.record_function(tr.WINDOW_MARK) if prof else None
    t0 = time.perf_counter()
    if mark:
        mark.__enter__()
    # whole passes over the epoch's batches, so that every seed's window
    # holds the same structures
    per_epoch = len(loader)
    while True:
        feed.step()
        if (feed.steps % per_epoch == 0
                and time.perf_counter() - t0 >= seconds):
            break
    if device.type == 'cuda':
        torch.cuda.synchronize()
    if mark:
        mark.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    if prof:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    finite = all(bool(torch.isfinite(p).all())
                 for p in trainer.params.values())
    steps = feed.steps
    out = {'setup_s': setup_s, 'window': {'wall_s': wall, 'steps': steps},
           'peak_bytes': peak, 'finite': finite,
           'counters': {'steps': steps, 'host_s': feed.host_s},
           'structures_per_s': steps * int(mix['batch_size']) / wall}
    if trace:
        t = tr.read(prof)
        del prof
        ctx = {'kind': 'train', 'trace': t, 'window_s': wall,
               'steps': steps, 'batch_size': int(mix['batch_size']),
               'host_s': feed.host_s, 'device': device,
               'specs': build_specs(cfg['model']),
               'edges_per_structure': mean_edges(
                   structs, float(cfg['model']['cutoff']), device),
               'atoms_per_structure': float(np.mean(
                   [len(s['z']) for s in structs]))}
        out['per_layer'] = readers(ctx)
        out['trace'] = t
    del trainer, loader, feed
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    ref = reference(ck, cfg, mix, structs, order, theta0, device)
    out['numbers'] = compare(got, ref, theta0)
    return out


def calibrate(cell: Dict, mix: Dict, seed: int, device, root: str,
              control: bool = True) -> Dict[str, Dict[str, float]]:
    """One seed's readings: the program's checked steps against the
    reference, and with ``control`` the reference with TF32 matmuls in the
    program's place."""
    cfg = cell['config']
    ck = checkpoint_config(cfg, root)
    structs, order = traffic.train_inputs(mix, seed, root)
    theta0 = initial_parameters(ck, seed, device)
    trainer, loader = program_setup(ck, mix, structs, order, theta0, device)
    got = check_steps(trainer, Feed(loader, trainer),
                      int(mix['check_steps']))
    del trainer, loader
    gc.collect()
    torch.cuda.empty_cache()
    ref = reference(ck, cfg, mix, structs, order, theta0, device)
    out = {'program': compare(got, ref, theta0),
           'leaves_left_out': len(ref['g1']) - len(moved_leaves(ref))}
    if control:
        lower = reference(ck, cfg, mix, structs, order, theta0, device,
                          tf32=True)
        out['control'] = compare(lower, ref, theta0)
    return out
