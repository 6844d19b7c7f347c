"""The least time of a sparse product ``y = A @ x`` on one H100, and the
launches of the block-COO SpMM in a MegaCRN train step on the stacked road
pack.

``spmm_bound`` is frozen from ``chip_smoke.py:spmm_bound`` of the program's
repository (its arithmetic unchanged; it reads a matrix's counts here, not
the program's pack): the nonzeros (a value and a 4-byte column each) and
the row pointers read once, the rows of x that a nonzero references read
once, y written once, and 2*f flops a nonzero. Stored zeros are not
counted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

BLOCK = 128  # the pack's tile edge: each support is padded to a multiple


@dataclass(frozen=True)
class SparseCounts:
    """What a product with one matrix needs: its nonzeros, the rows of x
    they reference, the rows of y (``n_rows``) and of the row-pointer array
    (``n_rows + 1``)."""

    nnz: int
    x_rows: int
    n_rows: int

    @classmethod
    def of(cls, a: np.ndarray) -> "SparseCounts":
        nz = a != 0
        return cls(int(nz.sum()), int(nz.any(axis=0).sum()), a.shape[0])


def spmm_bound(c: SparseCounts, f: int, itemsize: int = 4,
               dtype: str = "float32") -> Tuple[float, str]:
    """(seconds, "bytes" or "operations") of ``y = A @ x`` with x of width
    ``f``."""
    flops = 2.0 * c.nnz * f
    nbytes = (c.nnz * (itemsize + 4) + 4 * (c.n_rows + 1)
              + c.x_rows * f * itemsize + c.n_rows * f * itemsize)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def stacked(supports: np.ndarray) -> np.ndarray:
    """``diag(A_1 .. A_S)``, each support padded to a multiple of 128 rows
    and columns: the matrix of one Chebyshev level over all supports."""
    s, n, _ = supports.shape
    n_pad = -(-n // BLOCK) * BLOCK
    big = np.zeros((s * n_pad, s * n_pad), np.float32)
    for i in range(s):
        big[i * n_pad:i * n_pad + n, i * n_pad:i * n_pad + n] = supports[i]
    return big


def train_step_launches(m: dict, batch: int) -> List[Tuple[str, int]]:
    """("fwd" or "bwd", width f) of every block-COO launch of one train
    step: per aggregation ``cheb_k - 1`` products over the stacked features
    (width batch * channels), two aggregations a cell step (``[x || h]``
    and ``z * h``), and in the backward one product on the transposed pack
    for each forward one whose input needs a gradient: all but the first
    encoder step's ``[x || 0]``."""
    launches = []
    levels = m["cheb_k"] - 1
    for part, d_in, hid, steps in (
            ("enc", m["input_dim"], m["rnn_units"], m["seq_len"]),
            ("dec", m["output_dim"] + m["ycov_dim"],
             m["rnn_units"] + m["mem_dim"], m["horizon"])):
        for t in range(steps):
            for layer in range(m["num_layers"]):
                d = d_in if layer == 0 else hid
                for width, grad in ((d + hid, not (part == "enc" and t == 0
                                                   and layer == 0)),
                                    (hid, True)):
                    for _ in range(levels):
                        launches.append(("fwd", batch * width))
                        if grad:
                            launches.append(("bwd", batch * width))
    return launches


def train_step_bound_s(supports: np.ndarray, m: dict, batch: int) -> float:
    """Summed least time of one train step's block-COO launches."""
    big = stacked(supports)
    counts = {"fwd": SparseCounts.of(big), "bwd": SparseCounts.of(big.T)}
    return sum(spmm_bound(counts[side], f)[0]
               for side, f in train_step_launches(m, batch))
