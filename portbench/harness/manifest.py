"""Finding a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic mix, its limits, and the readers of the
per-layer metrics that list it."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_manifest(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, 'BENCHMARK.json')) as fh:
        return json.load(fh)


def cell(name: str, manifest: Dict[str, Any]) -> Dict[str, Any]:
    """{'workload', 'config', 'traffic', 'end_to_end', 'per_layer'} of one
    cell: the metrics are those whose ``workloads`` list it (or that have
    none)."""
    work = {w['name']: w for w in manifest['workloads']}
    if name not in work:
        raise SystemExit(f'unknown workload {name!r}: one of {sorted(work)}')
    w = work[name]
    conf = {c['name']: c for c in manifest['configs']}[w['config']]
    with open(os.path.join(ROOT, conf['file'])) as fh:
        cfg = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if name in m.get('workloads', [name])]

    return {'workload': w, 'config': cfg, 'config_entry': conf,
            'end_to_end': mine(manifest['end_to_end']),
            'per_layer': mine(manifest['per_layer'])}


def limits(workload: str) -> Dict[str, Any]:
    with open(os.path.join(HERE, 'limits', f'{workload}.json')) as fh:
        return json.load(fh)


def reader(metric: str):
    """The ``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, 'metrics', f'{metric}.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric.replace('.', '_').replace('-', '_'),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_values(metrics: List[Dict], ctx: Dict) -> Dict[str, Dict]:
    """Every per-layer metric whose reader finds something to read."""
    out = {}
    for m in metrics:
        v = reader(m['name'])(ctx)
        if v is not None:
            out[m['name']] = {'value': float(v), 'unit': m['unit']}
    return out
