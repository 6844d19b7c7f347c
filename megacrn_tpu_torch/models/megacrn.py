"""MegaCRN: meta-graph + memory + seq2seq GCRN (counterpart of
``megacrn_tpu/models/megacrn.py``; reference ``model/MegaCRN.py:116-194``).

The module's parameter names are the reference's (``memory.Memory``,
``encoder.dcrnn_cells.{i}.gate.weights``, ``proj.0.weight``, ...), so a
reference ``.pt`` state_dict loads with ``load_state_dict`` as it is;
``interop.params_from_flat`` converts the JAX package's flat naming.

The port runs every single-device graph backend of the JAX model:
``dense`` (learned meta-graph, dense Chebyshev stack, ``dense_impl``
``recursive`` or ``stacked``); ``road_sparse`` on a static road graph and
``sparse_meta``, the learned meta-graph on a static edge pattern, whose
graph constants (``road_supports=``) and aggregations ``ops.graph``'s
table ``GRAPH_CONSTANTS`` lists: the model checks that a constant serves
``cfg.graph_backend`` and takes the table's ``(supports, aggregate)``. The
forward serves and trains: with ``training=True`` the decoder does scheduled
sampling, and ``cfg.remat`` recomputes each cell step in the backward. The
encoder and decoder loop over time in Python. The ``dense`` backend records
a ``graph.meta`` span (``train.telemetry``) around each forward's meta-graph
and a ``graph.aggregate`` span around each aggregation, with the shapes of
its products as counts.

Inside a node-partitioned step of ``parallel.api`` the forward gets the
mesh's ``node_group`` (the counterpart of the JAX ``ring_axis`` and
``shard_fn``): x holds this rank's node block, and the aggregation crosses
ranks. ``dense_ring`` builds the rank's rows of the meta-graph supports and
aggregates on the ring (``parallel.ring``), ``dense`` under a node axis > 1
the same rows with the x blocks all-gathered (the all-gather GSPMD inserts
in JAX); a rank's rows of a road constant or of a ``sparse_meta`` pattern
take the table's node-partitioned aggregations (``parallel.ring``).
Outside a mesh ``dense_ring`` is the ``dense`` path, as in JAX.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.nn.init import torch_linear
from megacrn_tpu_torch.nn.memory import memory_init, query_memory
from megacrn_tpu_torch.nn.seq import (decoder_init, encoder_init, init_hidden,
                                      stack_step)
# road_supports_to is the mover of ops.graph's table, named here for the
# predictor, the train steps and the CLI.
from megacrn_tpu_torch.ops.graph import (  # noqa: F401
    cheb_aggregate, cheb_aggregate_prestacked, cheb_support_stack,
    graph_constant, meta_graph, road_supports_to)
from megacrn_tpu_torch.parallel.ring import (cheb_aggregate_gathered,
                                             cheb_aggregate_ring,
                                             local_meta_supports)
from megacrn_tpu_torch.train.telemetry import span

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
        self.proj = nn.Sequential(torch_linear(cfg.decoder_dim,
                                               cfg.output_dim, g, dtype))
        self.to(device)

    def forward(self, x: torch.Tensor, y_cov: torch.Tensor,
                road_supports=None, labels: Optional[torch.Tensor] = None,
                batches_seen=0, generator: Optional[torch.Generator] = None,
                training: bool = False, node_group=None) -> MegaCRNOutput:
        """The forward (the JAX ``forward``). With ``training=True`` and
        ``cfg.use_curriculum_learning`` the decoder feeds the label instead
        of its own output at the steps ``sampling_mask`` picks, with
        threshold ``compute_sampling_threshold(cfg.cl_decay_steps,
        batches_seen)`` and coins from ``generator``; otherwise it feeds
        back its own output, deterministically.

        x: (B, T, N, input_dim); y_cov: (B, horizon, N, ycov_dim); labels:
        (B, horizon, N, output_dim). ``road_supports``: the graph constant
        of a ``road_sparse`` or ``sparse_meta`` model (see the module
        docstring) on the model's device, the transposed side too for a
        backward (``road_supports_to`` moves it). ``node_group``: the
        mesh's node group, set only inside a node-partitioned step, where
        x, y_cov and labels hold this rank's node block.
        """
        cfg = self.cfg
        batch, n_nodes = x.shape[0], x.shape[2]
        compute_dtype = DTYPES[cfg.compute_dtype]
        # Memory read / output at >= f32: upcasts bf16, passes f64 through.
        acc_dtype = torch.promote_types(torch.float32, compute_dtype)
        mem = self.memory
        supports, aggregate = self._graph(road_supports, compute_dtype,
                                          node_group, n_nodes)
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
        # Remat recomputes each cell step in the backward instead of keeping
        # its aggregation stacks; without autograd there is no backward.
        remat = cfg.remat and torch.is_grad_enabled()

        def run(step, *args):
            if not remat:
                return step(*args)
            # The decoder's coins are drawn before the loop (sampling_mask),
            # so a recomputed step draws no random number: no RNG state to
            # save and restore.
            return checkpoint(step, *args, use_reentrant=False,
                              preserve_rng_state=False)

        def enc_step(x_t, *states):
            return stack_step(self.encoder, x_t, states, supports,
                              cfg.cheb_k, aggregate)[1]

        # --- encoder over T (model/MegaCRN.py:174-176) ---
        states = init_hidden(cfg.num_layers, batch, n_nodes, cfg.rnn_units,
                             compute_dtype, x.device)
        for t in range(x.shape[1]):
            states = run(enc_step, x[:, t], *states)
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

        def dec_step(go, y_cov_t, *states):
            h_de, states = stack_step(self.decoder,
                                      torch.cat([go, y_cov_t], dim=-1),
                                      states, supports, cfg.cheb_k,
                                      aggregate)
            return h_de @ proj_w + proj_b, states

        outs = []
        for t in range(cfg.horizon):
            out_t, states = run(dec_step, go, y_cov[:, t], *states)
            outs.append(out_t)
            go = (out_t if use_truth is None
                  else torch.where(use_truth[t], labels[:, t], out_t))
        output = torch.stack(outs, dim=1).to(acc_dtype)
        return MegaCRNOutput(output, h_att, query, pos, neg)

    def _graph(self, road_supports, compute_dtype, node_group=None,
               n_nodes=None):
        """(supports, aggregate) of the configured backend, with the
        supports cast to compute_dtype; under a ``node_group`` the rank's
        rows of them (``n_nodes`` of them) and an aggregation that crosses
        the group."""
        cfg = self.cfg
        backend = cfg.graph_backend
        mem = self.memory
        if node_group is not None and (
                backend == "dense_ring"
                or (backend == "dense" and node_group.size > 1)):
            supports = local_meta_supports(
                mem["Memory"], mem["We1"], mem["We2"], node_group,
                n_nodes).to(compute_dtype)
            return supports, functools.partial(
                cheb_aggregate_ring if backend == "dense_ring"
                else cheb_aggregate_gathered, group=node_group)
        if backend in ("dense", "dense_ring"):
            if cfg.dense_impl not in ("recursive", "stacked"):
                raise ValueError(f"unknown dense_impl {cfg.dense_impl!r}")
            with span("graph.meta", nodes=cfg.num_nodes,
                      supports=cfg.num_supports, dim=cfg.mem_dim):
                supports = meta_graph(mem["Memory"], mem["We1"],
                                      mem["We2"]).to(compute_dtype)
            num_s = supports.shape[0]
            if cfg.dense_impl == "recursive":
                agg = cheb_aggregate
            else:
                # The polynomial stack once per forward, after the cast, so
                # its N^3 products run in compute_dtype; every aggregation
                # is then one tall product.
                poly = cheb_support_stack(supports, cfg.cheb_k)

                def agg(_supports, x, cheb_k):
                    return cheb_aggregate_prestacked(poly, num_s, x, cheb_k)

            def aggregate(supports_, x, cheb_k):
                # The products' shapes, from which their operations and
                # bytes follow.
                with span("graph.aggregate", nodes=x.shape[1],
                          width=x.shape[0] * x.shape[2], supports=num_s,
                          order=cheb_k):
                    return agg(supports_, x, cheb_k)

            return supports, aggregate
        if backend not in ("road_sparse", "sparse_meta"):
            raise ValueError(f"unknown graph_backend {backend!r}")
        if backend == "road_sparse" and road_supports is None:
            raise ValueError("graph_backend='road_sparse' requires "
                             "road_supports= (ops.graph.GRAPH_CONSTANTS)")
        kind = graph_constant(road_supports)
        if kind is None or kind.backend != backend or kind.graph is None:
            raise TypeError(f"{type(road_supports).__name__} is not a "
                            f"{backend} graph constant that the forward "
                            "takes (ops.graph.GRAPH_CONSTANTS)")
        return kind.graph(road_supports, mem, compute_dtype, node_group,
                          n_nodes, cfg.num_supports)
