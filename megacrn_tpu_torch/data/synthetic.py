"""Synthetic road graph (counterpart of ``megacrn_tpu/data/synthetic.py``).

The real EXPY-TKY road graph (``expy-tky_adj01.npy``) is not in the
repository, so the serving slice runs on this stand-in, exactly as the JAX
CLI does with ``--dataset SYNTH``. Plain numpy; the output is bit-identical
to the JAX package's for the same arguments.
"""
from __future__ import annotations

import numpy as np


def synthetic_road_adjacency(num_nodes: int, avg_degree: int = 4,
                             seed: int = 0) -> np.ndarray:
    """Sparse 0/1 road-graph adjacency (ring + random chords)."""
    rng = np.random.RandomState(seed)
    a = np.zeros((num_nodes, num_nodes), np.float32)
    idx = np.arange(num_nodes)
    a[idx, (idx + 1) % num_nodes] = 1
    a[(idx + 1) % num_nodes, idx] = 1
    extra = max(0, avg_degree - 2) * num_nodes // 2
    src = rng.randint(0, num_nodes, extra)
    dst = rng.randint(0, num_nodes, extra)
    a[src, dst] = 1
    a[dst, src] = 1
    np.fill_diagonal(a, 0)
    return a
