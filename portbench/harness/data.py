"""The benchmark's inputs, made from the seed on the host: a month of
speeds with its time covariate, and the road graph and its supports.

Plain numpy, and the benchmark's own: the program under test gets only
what these functions return. The road graph is fixed by the configuration
(its own seed), never by ``--seed``.
"""
from __future__ import annotations

import numpy as np

STEPS_PER_DAY_MINUTES = 24 * 60


def seed_stream(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use of the run's seed."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def speed_series(rng: np.random.Generator, num_steps: int, num_nodes: int,
                 interval_minutes: int, missing_rate: float) -> np.ndarray:
    """(T, N) float32 speeds in [0, 70]: a daily and weekly periodic base
    with a phase per sensor, AR(1) noise that neighbouring sensors share,
    and missing readings as exact zeros (which the masked losses skip)."""
    per_day = STEPS_PER_DAY_MINUTES // interval_minutes
    t = np.arange(num_steps, dtype=np.float64)[:, None]
    phase = rng.uniform(0.0, 2 * np.pi, num_nodes)[None, :]
    base = (45.0 + 12.0 * np.sin(2 * np.pi * t / per_day + phase)
            + 1.5 * np.sin(2 * np.pi * t / (7 * per_day)))
    eps = rng.standard_normal((num_steps, num_nodes))
    nbr = rng.integers(0, num_nodes, (num_nodes, 4))
    eps = 3.0 * (eps + eps[:, nbr].sum(-1)) / np.sqrt(5.0)
    noise = np.empty_like(eps)
    noise[0] = eps[0]
    for i in range(1, num_steps):
        noise[i] = 0.8 * noise[i - 1] + 0.6 * eps[i]
    values = np.clip(base + noise, 0.0, 70.0)
    values[rng.random((num_steps, num_nodes)) < missing_rate] = 0.0
    return values.astype(np.float32)


def time_covariate(num_steps: int, num_nodes: int, interval_minutes: int,
                   kind: str, start_weekday: int = 0) -> np.ndarray:
    """(T, N) float32 decoder covariate of the configuration's protocol:
    ``time_in_day`` (the fraction of the day, METR-LA's
    generate_training_data.py) or ``weekday_time`` (``weekday * slots +
    slot`` over its largest value, EXPY-TKY's utils.py:62-71)."""
    minutes = np.arange(num_steps, dtype=np.int64) * interval_minutes
    minute_of_day = minutes % STEPS_PER_DAY_MINUTES
    if kind == "time_in_day":
        v = minute_of_day / STEPS_PER_DAY_MINUTES
    elif kind == "weekday_time":
        weekday = (start_weekday + minutes // STEPS_PER_DAY_MINUTES) % 7
        slots = STEPS_PER_DAY_MINUTES // interval_minutes
        v = weekday * slots + minute_of_day // interval_minutes
        v = v / v.max()
    else:
        raise ValueError(f"unknown covariate {kind!r}")
    return np.repeat(v.astype(np.float32)[:, None], num_nodes, axis=1)


def month(config: dict, traffic: dict, seed: int):
    """(speeds (T, N), covariate (T, N)) of ``traffic["series_days"]`` days
    at the configuration's interval, from ``seed``."""
    d, m = config["data"], config["model"]
    steps = traffic["series_days"] * STEPS_PER_DAY_MINUTES \
        // d["interval_minutes"]
    rng = np.random.default_rng(seed_stream(seed, 0))
    speeds = speed_series(rng, steps, m["num_nodes"], d["interval_minutes"],
                          d["missing_rate"])
    cov = time_covariate(steps, m["num_nodes"], d["interval_minutes"],
                         d["covariate"], d["start_weekday"])
    return speeds, cov


def road_adjacency(num_nodes: int, avg_degree: int, seed: int) -> np.ndarray:
    """0/1 symmetric road graph: a ring plus random chords (the port's
    synthetic road graph, frozen here)."""
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


def dual_random_walk(adj: np.ndarray) -> np.ndarray:
    """(2, N, N) float32: ``[(D^-1 A)^T, (D^-1 A^T)^T]`` (DCRNN's dual
    random walk), isolated nodes left at zero."""
    def rw(a):
        d = a.sum(1)
        d_inv = np.divide(1.0, d, out=np.zeros_like(d), where=d > 0)
        return (d_inv[:, None] * a).T

    adj = np.asarray(adj, np.float32)
    return np.stack([rw(adj), rw(adj.T)]).astype(np.float32)


def graph_supports(config: dict):
    """The configuration's static supports (2, N, N), or None where the
    model learns its graph."""
    g = config["graph"]
    if g["kind"] == "learned":
        return None
    if g["kind"] == "road":
        return dual_random_walk(road_adjacency(
            config["model"]["num_nodes"], g["avg_degree"], g["seed"]))
    raise ValueError(f"unknown graph kind {g['kind']!r}")


def windows(a: np.ndarray, length: int) -> np.ndarray:
    """(T, N, ...) -> (T - length + 1, length, N, ...), a strided view."""
    v = np.lib.stride_tricks.sliding_window_view(a, length, axis=0)
    return np.moveaxis(v, -1, 1)
