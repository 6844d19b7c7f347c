"""MegaCRN: meta-graph + memory + seq2seq GCRN (counterpart of
``megacrn_tpu/models/megacrn.py``; reference ``model/MegaCRN.py:116-194``).

The module's parameter names are the reference's (``memory.Memory``,
``encoder.dcrnn_cells.{i}.gate.weights``, ``proj.0.weight``, ...), so a
reference ``.pt`` state_dict loads with ``load_state_dict`` as it is;
``interop.params_from_flat`` converts the JAX package's flat naming.

The port runs two graph backends: ``dense`` (learned meta-graph, dense
Chebyshev stack) and ``road_sparse``, whose road-graph constant is either a
``StackedRoadPack`` (block-COO SpMM kernel) or a list of per-support
``(BlockELL, BlockELL_t)`` pairs (block-ELL SpMM kernel). The forward
serves and trains: with ``training=True`` the decoder does scheduled
sampling. The encoder and decoder loop over time in Python.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.kernels.spmm import BlockELL
from megacrn_tpu_torch.kernels.spmm_coo import StackedRoadPack
from megacrn_tpu_torch.nn.init import torch_linear_bias, torch_linear_weight
from megacrn_tpu_torch.nn.memory import memory_init, query_memory
from megacrn_tpu_torch.nn.seq import (decoder_init, encoder_init, init_hidden,
                                      stack_step)
from megacrn_tpu_torch.ops.graph import (cheb_aggregate,
                                         cheb_aggregate_sparse,
                                         cheb_aggregate_sparse_stacked,
                                         meta_graph)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float64": torch.float64}


def compute_sampling_threshold(cl_decay_steps: int, batches_seen) -> float:
    """Inverse-sigmoid curriculum threshold (model/MegaCRN.py:146-147)."""
    c = float(cl_decay_steps)
    return c / (c + math.exp(float(batches_seen) / c))


def sampling_mask(threshold: float, horizon: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(horizon,) bool on the generator's device: one uniform coin per
    decoder step, True (feed the label) where ``coin < threshold``. The one
    place the forward draws random numbers, so a test can hand both packages
    the same mask."""
    coins = torch.rand(horizon, generator=generator, device=generator.device)
    return coins < threshold


def road_supports_to(road_supports, device=None, dtype=None,
                     transpose: bool = False):
    """Move and cast the tile data of a ``road_sparse`` graph constant (a
    ``StackedRoadPack`` or a list of ``(BlockELL, BlockELL_t)`` pairs). The
    transposed packs are read only by the backward, so they move only when
    ``transpose`` is set."""
    if isinstance(road_supports, StackedRoadPack):
        return road_supports.to(device, dtype, transpose=transpose)
    return [(a.to(device, dtype), a_t.to(device, dtype) if transpose else a_t)
            for a, a_t in road_supports]


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
                road_supports=None, labels: Optional[torch.Tensor] = None,
                batches_seen=0, generator: Optional[torch.Generator] = None,
                training: bool = False) -> MegaCRNOutput:
        """The forward (the JAX ``forward``). With ``training=True`` and
        ``cfg.use_curriculum_learning`` the decoder feeds the label instead
        of its own output at the steps ``sampling_mask`` picks, with
        threshold ``compute_sampling_threshold(cfg.cl_decay_steps,
        batches_seen)`` and coins from ``generator``; otherwise it feeds
        back its own output, deterministically.

        x: (B, T, N, input_dim); y_cov: (B, horizon, N, ycov_dim); labels:
        (B, horizon, N, output_dim). ``road_supports``: the ``road_sparse``
        graph constant, a ``StackedRoadPack`` or a list of ``(BlockELL,
        BlockELL_t)`` pairs, on the model's device (the transposed packs
        too, for a backward).
        """
        cfg = self.cfg
        batch, n_nodes = x.shape[0], x.shape[2]
        compute_dtype = DTYPES[cfg.compute_dtype]
        # Memory read / output at >= f32: upcasts bf16, passes f64 through.
        acc_dtype = torch.promote_types(torch.float32, compute_dtype)
        mem = self.memory
        supports, aggregate = self._graph(road_supports, compute_dtype)
        use_truth = None
        if training and cfg.use_curriculum_learning:
            if labels is None or generator is None:
                raise ValueError("curriculum training requires labels and "
                                 "generator")
            use_truth = sampling_mask(
                compute_sampling_threshold(cfg.cl_decay_steps, batches_seen),
                cfg.horizon, generator).to(x.device)
            labels = labels.to(compute_dtype)

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

        # --- decoder over the horizon with scheduled sampling (:182-192) ---
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
            out_t = h_de @ proj_w + proj_b
            outs.append(out_t)
            go = (out_t if use_truth is None
                  else torch.where(use_truth[t], labels[:, t], out_t))
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
                                 "road_supports=StackedRoadPack or "
                                 "[(BlockELL, BlockELL_t), ...]")
            if isinstance(road_supports, StackedRoadPack):
                if road_supports.num_supports != self.cfg.num_supports:
                    raise ValueError("StackedRoadPack.num_supports != "
                                     "cfg.num_supports")
                aggregate = cheb_aggregate_sparse_stacked
            elif isinstance(road_supports, (list, tuple)) and all(
                    isinstance(pair, (list, tuple)) and len(pair) == 2
                    and all(isinstance(a, BlockELL) for a in pair)
                    for pair in road_supports):
                if len(road_supports) != self.cfg.num_supports:
                    raise ValueError("len(road_supports) != "
                                     "cfg.num_supports")
                aggregate = cheb_aggregate_sparse
            else:
                raise NotImplementedError(
                    f"{type(road_supports).__name__} road supports are not "
                    "ported yet (ROADMAP Queue 1 item 1: node-ELL packs)")
            # Only the tile data narrows (a no-op once the caller has cast
            # it); the kernels accumulate in f32. The transposed packs are
            # cast only when autograd records, since only a backward reads
            # them.
            return (road_supports_to(road_supports, dtype=compute_dtype,
                                     transpose=torch.is_grad_enabled()),
                    aggregate)
        items = {"sparse_meta": 7, "dense_ring": 11}
        if backend not in items:
            raise ValueError(f"unknown graph_backend {backend!r}")
        raise NotImplementedError(
            f"graph_backend={backend!r} is not ported yet (ROADMAP Queue 1 "
            f"item {items[backend]})")

