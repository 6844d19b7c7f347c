"""MegaCRN: meta-graph + memory + seq2seq GCRN (counterpart of
``megacrn_tpu/models/megacrn.py``; reference ``model/MegaCRN.py:116-194``).

The module's parameter names are the reference's (``memory.Memory``,
``encoder.dcrnn_cells.{i}.gate.weights``, ``proj.0.weight``, ...), so a
reference ``.pt`` state_dict loads with ``load_state_dict`` as it is;
``interop.params_from_flat`` converts the JAX package's flat naming.

This slice ports the deterministic forward (no scheduled sampling) of two
graph backends: ``dense`` (learned meta-graph, dense Chebyshev stack) and
``road_sparse`` with a ``StackedRoadPack`` (block-COO SpMM kernel). The
encoder and decoder loop over time in Python.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.kernels.spmm_coo import StackedRoadPack
from megacrn_tpu_torch.nn.init import torch_linear_bias, torch_linear_weight
from megacrn_tpu_torch.nn.memory import memory_init, query_memory
from megacrn_tpu_torch.nn.seq import (decoder_init, encoder_init, init_hidden,
                                      stack_step)
from megacrn_tpu_torch.ops.graph import (cheb_aggregate,
                                         cheb_aggregate_sparse_stacked,
                                         meta_graph)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


class MegaCRNOutput(NamedTuple):
    """The reference forward 5-tuple (model/MegaCRN.py:194)."""

    output: torch.Tensor  # (B, horizon, N, output_dim)
    h_att: torch.Tensor  # (B, N, mem_dim)
    query: torch.Tensor  # (B, N, mem_dim)
    pos: torch.Tensor  # (B, N, mem_dim)
    neg: torch.Tensor  # (B, N, mem_dim)


class MegaCRN(nn.Module):
    """MegaCRN with reference-parity initial distributions.

    ``generator`` draws the initial weights (a CPU ``torch.Generator``;
    default: seeded with 0). ``device``: where the model lives, the card
    unless the caller says otherwise (``resolve_device``).
    """

    def __init__(self, cfg: MegaCRNConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        self.memory = memory_init(cfg.num_nodes, cfg.rnn_units, cfg.mem_num,
                                  cfg.mem_dim, g, dtype)
        self.encoder = encoder_init(cfg.input_dim, cfg.rnn_units, cfg.cheb_k,
                                    cfg.num_layers, cfg.num_supports, g,
                                    dtype)
        # Decoder input is [go || y_cov]; hidden width rnn_units + mem_dim
        # (model/MegaCRN.py:140-141).
        self.decoder = decoder_init(cfg.output_dim + cfg.ycov_dim,
                                    cfg.decoder_dim, cfg.cheb_k,
                                    cfg.num_layers, cfg.num_supports, g,
                                    dtype)
        # proj = nn.Sequential(nn.Linear(decoder_dim, output_dim))
        # (model/MegaCRN.py:144), drawn from `g`, not the global RNG.
        proj = nn.utils.skip_init(nn.Linear, cfg.decoder_dim, cfg.output_dim,
                                  dtype=dtype)
        with torch.no_grad():
            proj.weight.copy_(torch_linear_weight(
                (cfg.decoder_dim, cfg.output_dim), g, dtype).T)
            proj.bias.copy_(torch_linear_bias(
                cfg.decoder_dim, (cfg.output_dim,), g, dtype))
        self.proj = nn.Sequential(proj)
        self.to(device)

    def forward(self, x: torch.Tensor, y_cov: torch.Tensor,
                road_supports: Optional[StackedRoadPack] = None
                ) -> MegaCRNOutput:
        """The deterministic forward (the JAX ``forward`` with
        ``training=False``): the decoder feeds back its own output.
        Scheduled sampling comes with the training slice.

        x: (B, T, N, input_dim); y_cov: (B, horizon, N, ycov_dim).
        ``road_supports``: the ``StackedRoadPack`` of the ``road_sparse``
        backend, on the model's device.
        """
        cfg = self.cfg
        batch, n_nodes = x.shape[0], x.shape[2]
        compute_dtype = DTYPES[cfg.compute_dtype]
        # Memory read / output at >= f32: upcasts bf16, passes f64 through.
        acc_dtype = torch.promote_types(torch.float32, compute_dtype)
        mem = self.memory
        supports, aggregate = self._graph(road_supports, compute_dtype)

        x = x.to(compute_dtype)
        y_cov = y_cov.to(compute_dtype)

        # --- encoder over T (model/MegaCRN.py:174-176) ---
        states = init_hidden(cfg.num_layers, batch, n_nodes, cfg.rnn_units,
                             compute_dtype, x.device)
        for t in range(x.shape[1]):
            _, states = stack_step(self.encoder, x[:, t], states, supports,
                                   cfg.cheb_k, aggregate)
        h_t = states[-1].to(acc_dtype)

        # --- memory read (model/MegaCRN.py:178-181) ---
        h_att, query, pos, neg = query_memory(mem, h_t)
        h0 = torch.cat([h_t, h_att], dim=-1).to(compute_dtype)
        states = (h0,) * cfg.num_layers  # same tensor for every layer

        # --- decoder over the horizon, feeding back its own output ---
        go = torch.zeros((batch, n_nodes, cfg.output_dim),
                         dtype=compute_dtype, device=x.device)
        proj_w = self.proj[0].weight.to(compute_dtype).T
        proj_b = self.proj[0].bias.to(compute_dtype)
        outs = []
        for t in range(cfg.horizon):
            h_de, states = stack_step(self.decoder,
                                      torch.cat([go, y_cov[:, t]], dim=-1),
                                      states, supports, cfg.cheb_k,
                                      aggregate)
            go = h_de @ proj_w + proj_b
            outs.append(go)
        output = torch.stack(outs, dim=1).to(acc_dtype)
        return MegaCRNOutput(output, h_att, query, pos, neg)

    def _graph(self, road_supports, compute_dtype):
        """(supports, aggregate) of the configured backend, with the
        supports cast to compute_dtype."""
        backend = self.cfg.graph_backend
        if backend == "dense":
            mem = self.memory
            supports = meta_graph(mem["Memory"], mem["We1"], mem["We2"])
            return supports.to(compute_dtype), cheb_aggregate
        if backend == "road_sparse":
            if road_supports is None:
                raise ValueError("graph_backend='road_sparse' requires "
                                 "road_supports=StackedRoadPack")
            if not isinstance(road_supports, StackedRoadPack):
                raise NotImplementedError(
                    f"{type(road_supports).__name__} road supports are not "
                    "ported yet (ROADMAP Queue 1 items 4-5: block-ELL and "
                    "node-ELL packs)")
            if road_supports.num_supports != self.cfg.num_supports:
                raise ValueError("StackedRoadPack.num_supports != "
                                 "cfg.num_supports")
            # Only the forward pack's tile data narrows (a no-op once the
            # Predictor has cast it); the kernel accumulates in f32.
            return (road_supports.to(dtype=compute_dtype),
                    cheb_aggregate_sparse_stacked)
        items = {"sparse_meta": 6, "dense_ring": 10}
        if backend not in items:
            raise ValueError(f"unknown graph_backend {backend!r}")
        raise NotImplementedError(
            f"graph_backend={backend!r} is not ported yet (ROADMAP Queue 1 "
            f"item {items[backend]})")

