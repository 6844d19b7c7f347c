"""AGCN graph convolution and the graph-conv GRU cell (counterpart of
``megacrn_tpu/nn/cell.py``; reference ``model/MegaCRN.py:7-51``).

Module and parameter names are the reference's (``gate.weights``,
``gate.bias``, ``update.weights``, ``update.bias``), so a reference
state_dict loads as it is. The weights are ``(S*K*dim_in, dim_out)``,
applied as ``x @ W``.

The cell aggregates ``[x || h]`` once for the gate and reuses its x-slice
for the candidate: aggregation is linear and blockwise over the concat, so
this is the reference's math with 2 Chebyshev stacks per step instead of 4
half-stacks, and the same weight layout.

Gate-role parity (``model/MegaCRN.py:43-47``): the FIRST half ``z`` of the
sigmoid output gates the state fed to the candidate, the SECOND half ``r``
is the convex gate, ``h = r*h + (1-r)*hc``. Deliberately not the textbook
GRU assignment.
"""
from __future__ import annotations

import torch
from torch import nn

from megacrn_tpu_torch.nn.init import xavier_normal
from megacrn_tpu_torch.ops.graph import cheb_aggregate


class AGCN(nn.Module):
    """Weight (S*K*dim_in, dim_out) xavier-normal, zero bias
    (model/MegaCRN.py:11-14)."""

    def __init__(self, dim_in: int, dim_out: int, cheb_k: int,
                 num_supports: int, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.weights = nn.Parameter(xavier_normal(
            (num_supports * cheb_k * dim_in, dim_out), generator, dtype))
        self.bias = nn.Parameter(torch.zeros(dim_out, dtype=dtype))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """x @ W + b, with the parameters read in x's dtype."""
        return x @ self.weights.to(x.dtype) + self.bias.to(x.dtype)


class GCRNCell(nn.Module):
    """Gate AGCN -> 2*dim_out, update AGCN -> dim_out
    (model/MegaCRN.py:35-36); ``forward`` is the JAX ``gcrn_cell_apply``."""

    def __init__(self, dim_in: int, dim_out: int, cheb_k: int,
                 num_supports: int, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.gate = AGCN(dim_in + dim_out, 2 * dim_out, cheb_k, num_supports,
                         generator, dtype)
        self.update = AGCN(dim_in + dim_out, dim_out, cheb_k, num_supports,
                           generator, dtype)

    def forward(self, x: torch.Tensor, h: torch.Tensor, supports,
                cheb_k: int, aggregate=cheb_aggregate) -> torch.Tensor:
        """x: (B, N, dim_in); h: (B, N, hidden) -> new hidden (B, N, hidden)."""
        cx = x.shape[-1]
        b, n = x.shape[0], x.shape[1]
        agg_xh = aggregate(supports, torch.cat([x, h], -1), cheb_k)
        z, r = torch.sigmoid(
            self.gate.project(agg_xh.reshape(b, n, -1))).chunk(2, dim=-1)
        agg_zh = aggregate(supports, z * h, cheb_k)
        # [agg_x || agg_zh] flattened support-major, each block [x, h]: the
        # reference weight layout (JAX ``_project``).
        cat = torch.cat([agg_xh[..., :cx], agg_zh], dim=-1).flatten(2)
        hc = torch.tanh(self.update.project(cat))
        return r * h + (1.0 - r) * hc
