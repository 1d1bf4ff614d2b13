"""Batch inference -> errors.txt / info.csv / per_graph.csv / per_atom.csv
(reference sevenn/scripts/inference.py:16-220). Stress in kbar
(x1602.1766208).

Counterpart of ``sevennet_exp_tpu/scripts/inference.py``: the loader's
padded batches (several graphs, a pad graph, pad atoms and pad edges, one
set of capacities for every batch) go through ``SevenNetModel.apply`` on
the model's device with the kernels on -- the calculator's route, kernels
1-2 in their edge-row form (``agg_d = 0``) on a CUDA device, their plain
version on the CPU. Energy and stress are per graph, forces per atom.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .. import _keys as KEY
from .._const import KBAR_COEFF
from ..checkpoint import SevenNetCheckpoint
from ..data.dataset import expand_dataset_paths, read_structure_file
from ..data.graph import atoms_to_graph
from ..data.loader import GraphLoader
from ..ops.fused_conv import USE_KERNELS_KEY

_INT_KEYS = (KEY.ATOMIC_NUMBERS, KEY.BATCH, KEY.EDGE_IDX, KEY.NUM_ATOMS,
             KEY.MODAL_TYPE)


def _run_model(model, graphs, batch_size: int, modal=None,
               timings: Optional[list] = None):
    """Per-graph results of ``model`` on ``graphs``. modal: the MODAL_TYPE
    index every graph takes. timings: a list that receives, per batch,
    {'host_s', 'total_s', 'n_node', 'n_edge'} (host: the collate and the
    copy to the device; total: until the results are back on the host)."""
    device = model.z_to_onehot.device
    loader = GraphLoader(graphs, batch_size=batch_size)
    results = []
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        if modal is not None:
            batch[KEY.MODAL_TYPE] = np.full(
                batch[KEY.NUM_ATOMS].shape, modal, dtype=np.int32
            )
        data = {k: torch.as_tensor(
                    v, dtype=torch.long if k in _INT_KEYS else None,
                    device=device)
                for k, v in batch.items()}
        data[USE_KERNELS_KEY] = True
        t_host = time.perf_counter()
        out = model.apply(data)
        n_graphs = int(batch[KEY.GRAPH_MASK].sum())
        node_off = 0
        e = out[KEY.PRED_TOTAL_ENERGY].cpu().numpy()
        f = out[KEY.PRED_FORCE].cpu().numpy()
        s = out[KEY.PRED_STRESS].cpu().numpy()
        ae = out[KEY.ATOMIC_ENERGY].cpu().numpy()
        if timings is not None:
            timings.append({'host_s': t_host - t0,
                            'total_s': time.perf_counter() - t0,
                            'n_node': int(batch[KEY.POS].shape[0]),
                            'n_edge': int(batch[KEY.EDGE_IDX].shape[1])})
        for gi in range(n_graphs):
            n = int(batch[KEY.NUM_ATOMS][gi])
            results.append({
                'n_atoms': n,
                'pred_energy': float(e[gi]),
                'pred_forces': f[node_off:node_off + n].copy(),
                'pred_stress': s[gi].copy(),
                'atomic_energy': ae[node_off:node_off + n, 0].copy(),
                'z': batch[KEY.ATOMIC_NUMBERS][node_off:node_off + n].copy(),
                'pos': batch[KEY.POS][node_off:node_off + n].copy(),
                'ref_energy': float(batch[KEY.ENERGY][gi])
                if KEY.ENERGY in batch else np.nan,
                'ref_forces': np.asarray(
                    batch[KEY.FORCE][node_off:node_off + n]
                ) if KEY.FORCE in batch else np.full((n, 3), np.nan),
                'ref_stress': np.asarray(batch[KEY.STRESS][gi])
                if KEY.STRESS in batch else np.full(6, np.nan),
            })
            node_off += n
    return results


def write_inference_csv(results: List[dict], out_dir: str,
                        infos: Optional[List[dict]] = None):
    os.makedirs(out_dir, exist_ok=True)
    sfx = ['xx', 'yy', 'zz', 'xy', 'yz', 'zx']
    with open(os.path.join(out_dir, 'per_graph.csv'), 'w', newline='') as f:
        w = None
        for r in results:
            row = {
                KEY.NUM_ATOMS: r['n_atoms'],
                KEY.ENERGY: r['ref_energy'],
                KEY.PRED_TOTAL_ENERGY: r['pred_energy'],
            }
            for i, x in enumerate(sfx):
                row[f'{KEY.STRESS}_{x}'] = r['ref_stress'][i] * KBAR_COEFF
            for i, x in enumerate(sfx):
                row[f'{KEY.PRED_STRESS}_{x}'] = (
                    r['pred_stress'][i] * KBAR_COEFF
                )
            if w is None:
                w = csv.DictWriter(f, fieldnames=row.keys())
                w.writeheader()
            w.writerow(row)
    with open(os.path.join(out_dir, 'per_atom.csv'), 'w', newline='') as f:
        w = None
        for si, r in enumerate(results):
            for ai in range(r['n_atoms']):
                row = {
                    'stct_id': si, 'atom_id': ai,
                    KEY.ATOMIC_NUMBERS: int(r['z'][ai]),
                    KEY.ATOMIC_ENERGY: r['atomic_energy'][ai],
                }
                for d, x in enumerate('xyz'):
                    row[f'{KEY.POS}_{x}'] = r['pos'][ai][d]
                for d, x in enumerate('xyz'):
                    row[f'{KEY.FORCE}_{x}'] = r['ref_forces'][ai][d]
                for d, x in enumerate('xyz'):
                    row[f'{KEY.PRED_FORCE}_{x}'] = r['pred_forces'][ai][d]
                if w is None:
                    w = csv.DictWriter(f, fieldnames=row.keys())
                    w.writeheader()
                w.writerow(row)
    if infos:
        with open(os.path.join(out_dir, 'info.csv'), 'w', newline='') as f:
            keys = sorted({k for i in infos for k in i})
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for i in infos:
                w.writerow(i)


def _errors_txt(results: List[dict], out_dir: str):
    e_res, f_res, s_res = [], [], []
    for r in results:
        if not np.isnan(r['ref_energy']):
            e_res.append(
                (r['pred_energy'] - r['ref_energy']) / r['n_atoms']
            )
        ok = ~np.isnan(r['ref_forces']).any(axis=1)
        f_res.extend((r['pred_forces'][ok] - r['ref_forces'][ok]).reshape(-1))
        if not np.isnan(r['ref_stress']).any():
            s_res.extend(
                (r['pred_stress'] - r['ref_stress']) * KBAR_COEFF
            )
    lines = []
    for name, arr, unit in (
        ('Energy', np.array(e_res), 'eV/atom'),
        ('Force', np.array(f_res), 'eV/A'),
        ('Stress', np.array(s_res), 'kbar'),
    ):
        if arr.size:
            lines.append(
                f'{name} MAE: {np.abs(arr).mean():.6f} {unit}'
            )
            lines.append(
                f'{name} RMSE: {np.sqrt((arr ** 2).mean()):.6f} {unit}'
            )
    with open(os.path.join(out_dir, 'errors.txt'), 'w') as f:
        f.write('\n'.join(lines) + '\n')


def inference(
    checkpoint: str,
    targets: List[str],
    output_dir: str = 'sevenn_infer_result',
    batch_size: int = 4,
    modal: Optional[str] = None,
    device='cuda',
    timings: Optional[list] = None,
    **kwargs,
):
    """Reference scripts/inference.py:119-220. checkpoint: a path or a
    pretrained keyword; targets: structure files (globs and braces
    expanded); the model runs on ``device``."""
    cp = SevenNetCheckpoint(checkpoint)
    model, _ = cp.build_model(device=device)
    graphs, infos = [], []
    for path in expand_dataset_paths(list(targets)):
        for at in read_structure_file(path):
            graphs.append(
                atoms_to_graph(at, model.cutoff, allow_unlabeled=True)
            )
            info = dict(at.info or {})
            info['file'] = os.path.abspath(path)
            infos.append(info)
    modal_idx = model.modal_map.get(modal) if modal else None
    results = _run_model(model, graphs, batch_size, modal_idx, timings)
    write_inference_csv(results, output_dir, infos)
    _errors_txt(results, output_dir)
    return results
