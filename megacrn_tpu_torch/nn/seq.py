"""Stacked-cell sequence modules (counterpart of
``megacrn_tpu/nn/seq.py``; reference ``model/MegaCRN.py:53-113``).

``encoder_init`` / ``decoder_init`` build a ``CellStack`` whose cells sit in
a ``dcrnn_cells`` ModuleList, the reference's name. ``stack_step`` runs one
time step through the layers; the model loops over time in Python.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from megacrn_tpu_torch.nn.cell import GCRNCell
from megacrn_tpu_torch.ops.graph import cheb_aggregate


class CellStack(nn.Module):
    def __init__(self, cells):
        super().__init__()
        self.dcrnn_cells = nn.ModuleList(cells)


def encoder_init(dim_in: int, dim_out: int, cheb_k: int, num_layers: int,
                 num_supports: int, generator: torch.Generator,
                 dtype=torch.float32) -> CellStack:
    """Layer 0 maps dim_in->dim_out; deeper layers dim_out->dim_out
    (model/MegaCRN.py:60-63)."""
    return CellStack([
        GCRNCell(dim_in if i == 0 else dim_out, dim_out, cheb_k,
                 num_supports, generator, dtype)
        for i in range(num_layers)])


decoder_init = encoder_init  # same structure (model/MegaCRN.py:91-101)


def stack_step(stack: CellStack, x_t: torch.Tensor,
               states: Tuple[torch.Tensor, ...], supports, cheb_k: int,
               aggregate=cheb_aggregate
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One time step through the layer stack; layer i consumes layer i-1's
    fresh output (model/MegaCRN.py:107-112). Returns (top output, new
    states)."""
    inp = x_t
    new_states = []
    for cell, h in zip(stack.dcrnn_cells, states):
        inp = cell(inp, h, supports, cheb_k, aggregate)
        new_states.append(inp)
    return inp, tuple(new_states)


def init_hidden(num_layers: int, batch: int, num_nodes: int, hidden: int,
                dtype=torch.float32, device=None) -> Tuple[torch.Tensor, ...]:
    """Zero states per layer (model/MegaCRN.py:50-51, 85-89)."""
    return tuple(torch.zeros((batch, num_nodes, hidden), dtype=dtype,
                             device=device) for _ in range(num_layers))
