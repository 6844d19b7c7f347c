"""DCGRU cell: the diffusion-convolution GRU of the GTS baseline
(counterpart of ``megacrn_tpu/nn/dcgru.py``; reference
``model/GTS.py:69-217``), on the natural (B, N, C) layout.

Parity-critical details kept:

* The random-walk support ``(D^-1 (A + I))^T`` with 1/0 -> 0
  (``GTS.py:118-126,136``). The reference and the JAX package rebuild it
  from the sampled adjacency at every cell step; the adjacency does not
  change within a forward, so the GTS model here builds it once per forward
  and hands it to every step (``support=``): the same numbers.
* The diffusion stack ``[x, A x, 2 A x1 - x0, ...]``, K+1 matrices with the
  identity once (``GTS.py:185-206``).
* The projection's feature order is **input-major, matrix-minor** (flat
  index ``c * (K+1) + k``, ``GTS.py:208-209``), the opposite of MegaCRN's.
* Gate bias 1.0 (``GTS.py:142``), candidate bias 0; ``r`` (the first half)
  gates the state into the candidate and ``u`` is the convex gate
  (``GTS.py:144-153``).

Parameter names are the reference's LayerParams names
(``gconv_weight_(in, out)``, ``gconv_biases_{out}``), so a reference
state_dict loads as it is; the weights are ``(in, out)``, applied as
``x @ W``.
"""
from __future__ import annotations

import torch
from torch import nn

from megacrn_tpu_torch.nn.init import xavier_normal


def random_walk_support(adj: torch.Tensor) -> torch.Tensor:
    """(D^-1 (A + I))^T with 1/0 -> 0 on empty rows (GTS.py:118-126), the
    transpose taken at the call site in the reference (GTS.py:136)."""
    a = adj + torch.eye(adj.shape[0], dtype=adj.dtype, device=adj.device)
    d = a.sum(dim=1)
    nonzero = d > 0
    # The division guarded too, so an empty row's gradient stays finite.
    d_inv = torch.where(nonzero, 1.0 / torch.where(nonzero, d,
                                                   torch.ones_like(d)),
                        torch.zeros_like(d))
    return (d_inv[:, None] * a).T


def diffusion_stack(support: torch.Tensor, x: torch.Tensor,
                    max_step: int) -> torch.Tensor:
    """[T_0..T_K](A) applied to x: (B, N, C) -> (B, N, C, K+1)."""
    terms = [x]
    if max_step > 0:
        x0, x1 = x, torch.einsum("nm,bmc->bnc", support, x)
        terms.append(x1)
        for _ in range(2, max_step + 1):
            x2 = 2.0 * torch.einsum("nm,bmc->bnc", support, x1) - x0
            terms.append(x2)
            x0, x1 = x1, x2
    return torch.stack(terms, dim=-1)


class DCGRUCell(nn.Module):
    """The gate gconv -> 2*units and the candidate gconv -> units, each
    over [x || h] (``dim_in + units`` channels) times K+1 matrices."""

    def __init__(self, dim_in: int, num_units: int, max_diffusion_step: int,
                 generator: torch.Generator, dtype=torch.float32):
        super().__init__()
        self.num_units = num_units
        self.max_diffusion_step = max_diffusion_step
        rows = (dim_in + num_units) * (max_diffusion_step + 1)
        self._gate = (rows, 2 * num_units)
        self._cand = (rows, num_units)
        for shape, bias in ((self._gate, 1.0), (self._cand, 0.0)):
            self.register_parameter(f"gconv_weight_{shape}", nn.Parameter(
                xavier_normal(shape, generator, dtype)))
            self.register_parameter(f"gconv_biases_{shape[1]}", nn.Parameter(
                torch.full((shape[1],), bias, dtype=dtype)))

    def _gconv(self, shape, support, x, h):
        w = getattr(self, f"gconv_weight_{shape}").to(x.dtype)
        b = getattr(self, f"gconv_biases_{shape[1]}").to(x.dtype)
        stack = diffusion_stack(support, torch.cat([x, h], dim=-1),
                                self.max_diffusion_step)
        return stack.flatten(2) @ w + b  # input-major, matrix-minor

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                adj: torch.Tensor = None,
                support: torch.Tensor = None) -> torch.Tensor:
        """One DCGRU step (GTS.py:128-153): x (B, N, dim_in), h (B, N,
        units). Give the sampled ``adj`` (its support is built here, in the
        adj's precision, then cast to x's dtype, as the JAX cell does) or
        the prebuilt ``support``."""
        if support is None:
            support = random_walk_support(adj).to(x.dtype)
        r, u = torch.sigmoid(self._gconv(self._gate, support, x, h)).chunk(
            2, dim=-1)
        c = torch.tanh(self._gconv(self._cand, support, x, r * h))
        return u * h + (1.0 - u) * c


class DCGRUStack(nn.Module):
    """The reference's ``dcgru_layers`` ModuleList: layer 0 maps
    dim_in -> units, deeper layers units -> units."""

    def __init__(self, dim_in: int, num_units: int, max_diffusion_step: int,
                 num_layers: int, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.dcgru_layers = nn.ModuleList([
            DCGRUCell(dim_in if i == 0 else num_units, num_units,
                      max_diffusion_step, generator, dtype)
            for i in range(num_layers)])

    def step(self, inp, states, support):
        """One time step through the layers; returns (top output, new
        states)."""
        new_states = []
        for cell, h in zip(self.dcgru_layers, states):
            inp = cell(inp, h, support=support)
            new_states.append(inp)
        return inp, tuple(new_states)
