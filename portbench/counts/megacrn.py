"""Floating-point operations of a MegaCRN forward and train step, from the
configuration's shapes. A multiply-add is 2 operations; only products are
counted (the elementwise gates, softmaxes and losses are a few percent and
left out, so a share of the peak reads low, never high).

Per cell step and layer, with C = d_in + H and S supports of K levels:
- the gate's graph convolution: the aggregation of ``[x || h]`` (width C)
  and the projection ``(B*N, S*K*C) @ (S*K*C, 2H)``;
- the candidate's: the aggregation of ``z*h`` (width H; the x part of its
  input is the gate's, since an aggregation is linear and blockwise over a
  concatenation) and the projection ``(B*N, S*K*C) @ (S*K*C, H)``.
An aggregation is ``S * (K-1)`` products of a support with ``(N, B*C)``
features: ``2 * N * N * B * C`` each for a dense support,
``2 * nnz_s * B * C`` for a sparse one (``nnz`` below counts all S). The
learned graph adds ``E_i = We_i @ Memory`` and ``E_1 @ E_2^T`` both ways; the
memory read adds the query, the attention scores and the value; the decoder
adds the output projection.

A train step is counted as three forwards (the backward of a product takes
two products of its size).
"""
from __future__ import annotations

from typing import Optional


def forward_flops(m: dict, batch: int, nnz: Optional[int] = None) -> float:
    """One forward at ``batch`` windows; ``nnz``: the static supports'
    nonzeros, all S together, or None for the learned dense graph."""
    n, s, k = m["num_nodes"], 2, m["cheb_k"]
    rows = batch * n
    if nnz is None:
        agg_per_channel = s * (k - 1) * 2.0 * n * n * batch
        e, mem = m["mem_dim"], m["mem_num"]
        graph = 2 * (2.0 * n * mem * e) + 2 * (2.0 * n * n * e)
    else:
        agg_per_channel = (k - 1) * 2.0 * nnz * batch
        graph = 0.0
    total = graph
    for d_in, hid, steps in (
            (m["input_dim"], m["rnn_units"], m["seq_len"]),
            (m["output_dim"] + m["ycov_dim"], m["rnn_units"] + m["mem_dim"],
             m["horizon"])):
        for layer in range(m["num_layers"]):
            c = (d_in if layer == 0 else hid) + hid
            cell = (agg_per_channel * (c + hid)
                    + 2.0 * rows * s * k * c * 2 * hid
                    + 2.0 * rows * s * k * c * hid)
            total += steps * cell
    h, d, mem = m["rnn_units"], m["mem_dim"], m["mem_num"]
    total += 2.0 * rows * h * d + 2 * (2.0 * rows * d * mem)
    total += m["horizon"] * 2.0 * rows * (h + d) * m["output_dim"]
    return total


def train_step_flops(m: dict, batch: int, nnz: Optional[int] = None) -> float:
    return 3.0 * forward_flops(m, batch, nnz)
