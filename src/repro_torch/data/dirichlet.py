"""Dirichlet non-IID partitioner (paper §4.1), a numpy copy of the JAX
package's ``data/dirichlet.py`` (bitwise-equal from the same generator).

Per class, node proportions come from Dir(α·1) and the class's samples
are split accordingly (disjoint, never reshuffled afterwards).
"""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_nodes: int, alpha: float,
                        rng: np.random.Generator,
                        min_per_node: int = 2) -> List[np.ndarray]:
    """Returns a list of index arrays, one per node (disjoint, covering)."""
    labels = np.asarray(labels)
    classes = np.unique(labels)
    node_indices: List[list] = [[] for _ in range(num_nodes)]
    for _ in range(100):
        node_indices = [[] for _ in range(num_nodes)]
        for c in classes:
            idx = np.flatnonzero(labels == c)
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_nodes, alpha))
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for node, part in enumerate(np.split(idx, cuts)):
                node_indices[node].extend(part.tolist())
        if min(len(ix) for ix in node_indices) >= min_per_node:
            break
    out = []
    for ix in node_indices:
        arr = np.asarray(ix, dtype=np.int64)
        rng.shuffle(arr)
        out.append(arr)
    return out


def partition_stats(labels: np.ndarray, parts: List[np.ndarray],
                    num_classes: int) -> np.ndarray:
    """(n_nodes, n_classes) normalized class histograms of a partition."""
    hists = []
    for ix in parts:
        h = np.bincount(labels[ix], minlength=num_classes).astype(np.float64)
        hists.append(h / max(h.sum(), 1.0))
    return np.stack(hists)
