"""kNN prior graph for GTS's BCE graph-structure loss (counterpart of
``megacrn_tpu/data/graph_prior.py``; numpy only).

Reference: ``sklearn.neighbors.kneighbors_graph(train_feas.T, k,
metric='cosine')`` over node columns of the normalized training series
(``model/traintest_GTS.py:330-333``) — connectivity mode (binary), self
excluded.
"""
from __future__ import annotations

import numpy as np


def cosine_knn_graph(series: np.ndarray, k: int) -> np.ndarray:
    """series: (T, N) — nodes are columns. Returns binary (N, N) float32
    where row i marks i's k nearest neighbors by cosine *distance*
    (1 - cosine similarity) in float64, excluding self, matching sklearn
    connectivity mode."""
    x = series.T.astype(np.float64)  # (N, T)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    sim = (x / norms) @ (x / norms).T
    dist = 1.0 - sim
    np.fill_diagonal(dist, np.inf)  # exclude self
    n = dist.shape[0]
    nbr = np.argpartition(dist, kth=k - 1, axis=1)[:, :k]
    g = np.zeros((n, n), np.float32)
    g[np.repeat(np.arange(n), k), nbr.ravel()] = 1.0
    return g
