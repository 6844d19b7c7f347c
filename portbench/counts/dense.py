"""The least time of one dense Chebyshev aggregation on one H100, from the
counts of the program's ``graph.aggregate`` span: ``nodes`` N, ``width``
(B*C of its input), ``supports`` S and ``order`` K.

An aggregation is ``S * (K-1)`` products ``t_k = A_s @ t_{k-1}`` of an
``(N, N)`` support with ``(N, width)`` features, ``2 * N * N * width``
operations each. Each product reads its support and its input and writes
its output, each once; from the second level on, the recursion
``2 * A_s @ t_{k-1} - t_{k-2}`` also reads ``t_{k-2}`` once. The level-0
term is the input itself and costs nothing. Copies the program makes
around the products (layouts, the stack of the terms) are not counted,
so a share of this bound reads low, never high.
"""
from __future__ import annotations

from typing import Dict, Tuple

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def aggregate_counts(counts: Dict[str, int],
                     itemsize: int = 4) -> Tuple[float, float]:
    """(operations, bytes) of one aggregation with the span's counts."""
    n, f = counts["nodes"], counts["width"]
    s, k = counts["supports"], counts["order"]
    products = s * (k - 1)
    flops = products * 2.0 * n * n * f
    nbytes = itemsize * (products * (n * n + 2 * n * f)
                         + s * max(k - 2, 0) * n * f)
    return flops, float(nbytes)


def aggregate_bound(counts: Dict[str, int], itemsize: int = 4,
                    dtype: str = "float32") -> Tuple[float, str]:
    """(seconds, "bytes" or "operations") of one aggregation."""
    flops, nbytes = aggregate_counts(counts, itemsize)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
