"""Operations of one force call (the model's forward and its backward to
the positions) and of one structure in a training step: the numerators
of ``mfu_pct``. Counted from the shapes and from what the structure
needs: the rows that carry an edge."""

from __future__ import annotations

from typing import Dict

import numpy as np

from . import conv as cc


def conv_shapes(specs: Dict, agg_d: int):
    return [cc.conv_shape(c.tp, c.mlp.hs, c.si2, agg_d, specs['lmax'])
            for c in specs['convs']]


def force_call_flops(specs: Dict, degrees: np.ndarray, deg_cap: int,
                     chunk_rows: int, geom: bool) -> Dict:
    """{'conv': ..., 'nodes': ..., 'edges': ..., 'total': ...} operations
    of one force call on the dense grid."""
    n = len(degrees)
    live = float(degrees.sum())
    conv = 0.0
    for shape in conv_shapes(specs, deg_cap):
        for rows, lv in cc.chunk_live(degrees, deg_cap, chunk_rows):
            f, b = cc.conv_cost(shape, rows, lv, geom=geom)
            conv += f + b
    # node-level linears: forward, and backward to their input (no
    # parameter takes a gradient in MD); the one-hot embedding forward only
    nodes = cc.linear_flops(specs['embed'], n)
    for c in specs['convs']:
        nodes += 2.0 * (cc.linear_flops(c.sc, n) + cc.linear_flops(c.si1, n))
    nodes += 2.0 * (cc.linear_flops(specs['readout1'], n)
                    + cc.linear_flops(specs['readout2'], n))
    edges = 0.0
    if not geom:
        # Bessel, envelope and SH of every live row outside the kernels,
        # forward and backward (the geometry-fused pair counts them inside)
        geo = 20.0 + 4.0 * specs['nb'] + 5.0 * cc.sh_term_count(
            specs['lmax'])
        edges = 4.0 * live * geo
    return dict(conv=conv, nodes=nodes, edges=edges,
                total=conv + nodes + edges)


def train_structure_flops(specs: Dict, atoms: float, edges: float) -> float:
    """Operations of one structure in a training step: its forward and
    force backward on a plain edge list (rows = edges), and the backward
    of both to the parameters at twice their cost."""
    conv = 0.0
    for shape in conv_shapes(specs, 0):
        f, b = cc.conv_cost(shape, int(edges), edges, geom=False)
        conv += f + b
    nodes = cc.linear_flops(specs['embed'], int(atoms))
    for c in specs['convs']:
        nodes += 2.0 * (cc.linear_flops(c.sc, int(atoms))
                        + cc.linear_flops(c.si1, int(atoms)))
    nodes += 2.0 * (cc.linear_flops(specs['readout1'], int(atoms))
                    + cc.linear_flops(specs['readout2'], int(atoms)))
    geo = 20.0 + 4.0 * specs['nb'] + 5.0 * cc.sh_term_count(specs['lmax'])
    return 3.0 * (conv + nodes + 4.0 * edges * geo)
