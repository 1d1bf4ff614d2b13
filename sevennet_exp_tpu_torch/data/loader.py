"""Static-shape batch loader.

Counterpart of ``sevennet_exp_tpu/data/loader.py``: splits a dataset into
batches of ``batch_size`` graphs and pads every batch to ONE global
(n_node, n_edge, n_graph) capacity, so every train step sees the same
shapes. The epoch order comes from ``np.random.default_rng(seed)`` as in
the JAX loader, so both packages draw the same batches, index for index.
Data parallelism (the JAX loader's ``shard``) is not in the port yet
(ROADMAP A.7).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from .. import _keys as KEY
from .graph import collate_graphs, pad_cap


class GraphLoader:
    def __init__(
        self,
        graphs: Sequence[Dict],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        n_node: Optional[int] = None,
        n_edge: Optional[int] = None,
        drop_last: bool = False,
    ):
        self.graphs = list(graphs)
        sizes = [(int(g[KEY.NUM_ATOMS]), g[KEY.EDGE_IDX].shape[1])
                 for g in self.graphs]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last
        # global capacities: max over batches of (sum nodes, sum edges)
        max_nodes = max_edges = 0
        for i in range(0, len(sizes), batch_size):
            chunk = sizes[i:i + batch_size]
            max_nodes = max(max_nodes, sum(s[0] for s in chunk))
            max_edges = max(max_edges, sum(s[1] for s in chunk))
        # shuffling changes batch composition: pad against the worst case
        if shuffle and len(sizes) > batch_size:
            max_nodes = sum(sorted((s[0] for s in sizes),
                                   reverse=True)[:batch_size])
            max_edges = sum(sorted((s[1] for s in sizes),
                                   reverse=True)[:batch_size])
        self.n_node = n_node or pad_cap(max_nodes, multiple=8)
        self.n_edge = n_edge or pad_cap(max_edges, multiple=128)
        self.n_graph = batch_size + 1  # last slot absorbs padded nodes

    def __len__(self):
        n = len(self.graphs)
        return (n // self.batch_size if self.drop_last
                else (n + self.batch_size - 1) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.graphs))
        if self.shuffle:
            order = self.rng.permutation(order)
        for i in range(0, len(order), self.batch_size):
            idx = order[i:i + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield collate_graphs([self.graphs[j] for j in idx],
                                 n_node=self.n_node, n_edge=self.n_edge,
                                 n_graph=self.n_graph)
