"""Synthetic traffic data and road graph (counterpart of
``megacrn_tpu/data/synthetic.py``).

The reference's raw datasets and the real EXPY-TKY road graph
(``expy-tky_adj01.npy``) are not in the repository, so the port trains and
serves on these stand-ins, exactly as the JAX CLI does with ``--dataset
SYNTH`` or EXPY-TKY without CSVs: a speed series with a daily/weekly
periodic base, spatially correlated noise and missing readings (exact
zeros, which exercise the masked losses), and a ring-plus-chords adjacency.
Plain numpy; the outputs are bit-identical to the JAX package's for the same
arguments.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_speed_series(
    num_steps: int,
    num_nodes: int,
    interval_minutes: int = 5,
    seed: int = 0,
    missing_rate: float = 0.02,
    start: str = "2012-03-01",
    min_speed: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values (T, N) float32 speeds in ~[0, 70], datetime64 index).

    ``min_speed``: lower clip bound. The default 0 permits arbitrarily small
    positive speeds, which make MAPE ill-conditioned (|err/y| explodes);
    parity fixtures that compare MAPE pass a real-traffic floor (e.g. 20)
    so all four metrics are well-conditioned. Missing values are exact
    zeros either way (masked by the loss/metrics)."""
    rng = np.random.RandomState(seed)
    steps_per_day = 24 * 60 // interval_minutes
    t = np.arange(num_steps)

    phase = rng.uniform(0, 2 * np.pi, num_nodes)
    daily = np.sin(2 * np.pi * t[:, None] / steps_per_day + phase[None, :])
    weekly = 0.3 * np.sin(2 * np.pi * t[:, None] / (7 * steps_per_day))
    base = 45.0 + 12.0 * daily + 5.0 * weekly

    # Spatially correlated AR(1) noise: neighbors share disturbances.
    mix = rng.rand(num_nodes, num_nodes) * (rng.rand(num_nodes, num_nodes) < 0.05)
    np.fill_diagonal(mix, 1.0)
    mix /= mix.sum(1, keepdims=True)
    noise = np.zeros((num_steps, num_nodes))
    eps = rng.randn(num_steps, num_nodes) * 3.0
    for i in range(1, num_steps):
        noise[i] = 0.8 * noise[i - 1] @ mix.T + eps[i]

    values = np.clip(base + noise, min_speed, 70.0)
    values[rng.rand(num_steps, num_nodes) < missing_rate] = 0.0

    index = (np.datetime64(start) +
             np.arange(num_steps) * np.timedelta64(interval_minutes, "m"))
    return values.astype(np.float32), index


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
