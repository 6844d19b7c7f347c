"""MegaCRN: meta-graph + memory + seq2seq GCRN (counterpart of
``megacrn_tpu/models/megacrn.py``; reference ``model/MegaCRN.py:116-194``).

The module's parameter names are the reference's (``memory.Memory``,
``encoder.dcrnn_cells.{i}.gate.weights``, ``proj.0.weight``, ...), so a
reference ``.pt`` state_dict loads with ``load_state_dict`` as it is;
``interop.params_from_flat`` converts the JAX package's flat naming.

The port runs every single-device graph backend of the JAX model:
``dense`` (learned meta-graph, dense Chebyshev stack, ``dense_impl``
``recursive`` or ``stacked``); ``road_sparse``, whose road-graph constant is
a ``StackedRoadPack`` (block-COO SpMM kernel), a list of per-support
``(BlockELL, BlockELL_t)`` pairs (block-ELL SpMM kernel) or a stacked
node-ELL pack (flat or degree-bucketed); and ``sparse_meta``, the learned
meta-graph on a static edge pattern (``NodeELLPattern``,
``BucketedNodeELLPattern`` or the 128x128-tile ``BlockPattern``). The
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
in JAX); a list of local block-ELL pairs goes through
``cheb_aggregate_sparse_sharded``, a ``LocalNodeELL`` /
``LocalBucketedNodeELL`` through ``cheb_aggregate_node_ell_sharded``, and
``sparse_meta``'s ``LocalNodePattern`` / ``LocalBlockPattern`` (the rank's
rows of the edge pattern) through the learned sharded aggregations of
``parallel.ring``: each rank computes its rows of the SDDMM and softmax
from the whole node embeddings and multiplies them into the gathered x.
Outside a mesh ``dense_ring`` is the ``dense`` path, as in JAX.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.kernels.sparse_graph import (
    BlockPattern, LocalBlockPattern, cheb_aggregate_learned_sparse,
    sparse_meta_graph)
from megacrn_tpu_torch.kernels.sparse_graph_node import (
    BucketedNodeELLPattern, LocalNodePattern, NodeELLPattern,
    cheb_aggregate_learned_node, sparse_meta_graph_node)
from megacrn_tpu_torch.kernels.spmm import BlockELL
from megacrn_tpu_torch.kernels.spmm_coo import StackedRoadPack
from megacrn_tpu_torch.kernels.spmm_ell_node import (
    BucketedStackedNodeELL, LocalBucketedNodeELL, LocalNodeELL,
    StackedNodeELL, cheb_aggregate_node_ell, cheb_aggregate_node_ell_sharded)
from megacrn_tpu_torch.nn.init import torch_linear
from megacrn_tpu_torch.nn.memory import memory_init, query_memory
from megacrn_tpu_torch.nn.seq import (decoder_init, encoder_init, init_hidden,
                                      stack_step)
from megacrn_tpu_torch.ops.graph import (cheb_aggregate,
                                         cheb_aggregate_prestacked,
                                         cheb_aggregate_sparse,
                                         cheb_aggregate_sparse_stacked,
                                         cheb_support_stack, meta_graph)
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


# The graph constants with their own ``.to(device, dtype, transpose=...)``.
_PACKS = (StackedRoadPack, StackedNodeELL, BucketedStackedNodeELL)
_NODE_PATTERNS = (NodeELLPattern, BucketedNodeELLPattern)
_LOCAL_NODE_ELL = (LocalNodeELL, LocalBucketedNodeELL)
_LOCAL_PATTERNS = (LocalNodePattern, LocalBlockPattern)
_MOVABLE = (_PACKS + _NODE_PATTERNS + _LOCAL_NODE_ELL + _LOCAL_PATTERNS
            + (BlockPattern,))


def road_supports_to(road_supports, device=None, dtype=None,
                     transpose: bool = False):
    """Move and cast a graph constant: a ``StackedRoadPack``, a list of
    ``(BlockELL, BlockELL_t)`` pairs, a stacked node-ELL pack (flat or
    bucketed), a rank's local node-ELL rows or a ``sparse_meta`` pattern
    (node, bucketed or block; whole or a rank's rows). Index arrays move
    and are never cast; tile data, weights and masks are cast to
    ``dtype``. The transposed packs (and a node pattern's transposed
    side) are read only by the backward, so they move only when
    ``transpose`` is set."""
    if isinstance(road_supports, _MOVABLE):
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
            from megacrn_tpu_torch.parallel.ring import (
                cheb_aggregate_gathered, cheb_aggregate_ring,
                local_meta_supports)

            supports = local_meta_supports(
                mem["Memory"], mem["We1"], mem["We2"], node_group,
                n_nodes).to(compute_dtype)
            agg = (cheb_aggregate_ring if backend == "dense_ring"
                   else cheb_aggregate_gathered)

            def aggregate(supports_, x, cheb_k):
                return agg(supports_, x, cheb_k, node_group)

            return supports, aggregate
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
        if backend == "road_sparse":
            if road_supports is None:
                raise ValueError("graph_backend='road_sparse' requires "
                                 "road_supports=StackedRoadPack, "
                                 "[(BlockELL, BlockELL_t), ...] or a "
                                 "stacked node-ELL pack")
            if isinstance(road_supports, _LOCAL_NODE_ELL):
                if node_group is None:
                    raise ValueError(
                        f"{type(road_supports).__name__} is one rank's rows: "
                        "it needs the node_group of a node-partitioned step")

                def aggregate(pack, x, cheb_k):
                    return cheb_aggregate_node_ell_sharded(pack, x, cheb_k,
                                                           node_group)
            elif isinstance(road_supports, _PACKS):
                if road_supports.num_supports != cfg.num_supports:
                    raise ValueError(f"{type(road_supports).__name__}"
                                     ".num_supports != cfg.num_supports")
                aggregate = (cheb_aggregate_sparse_stacked
                             if isinstance(road_supports, StackedRoadPack)
                             else cheb_aggregate_node_ell)
            elif isinstance(road_supports, (list, tuple)) and all(
                    isinstance(pair, (list, tuple)) and len(pair) == 2
                    and all(isinstance(a, BlockELL) for a in pair)
                    for pair in road_supports):
                if len(road_supports) != cfg.num_supports:
                    raise ValueError("len(road_supports) != "
                                     "cfg.num_supports")
                if node_group is None:
                    aggregate = cheb_aggregate_sparse
                else:
                    # One rank's row-block packs (kernels.spmm.local_packs).
                    from megacrn_tpu_torch.parallel.ring import \
                        cheb_aggregate_sparse_sharded

                    def aggregate(packs, x, cheb_k):
                        return cheb_aggregate_sparse_sharded(
                            packs, x, cheb_k, node_group)
            else:
                raise TypeError(
                    f"{type(road_supports).__name__} is not a road_sparse "
                    "graph constant: give a StackedRoadPack, [(BlockELL, "
                    "BlockELL_t), ...], a StackedNodeELL or a "
                    "BucketedStackedNodeELL")
            # Only the values narrow (a no-op once the caller has cast
            # them). The transposed packs are cast only when autograd
            # records, since only a backward reads them.
            return (road_supports_to(road_supports, dtype=compute_dtype,
                                     transpose=torch.is_grad_enabled()),
                    aggregate)
        if backend == "sparse_meta":
            local = isinstance(road_supports, _LOCAL_PATTERNS)
            if not isinstance(road_supports, _NODE_PATTERNS + (BlockPattern,)
                              + _LOCAL_PATTERNS):
                raise TypeError(
                    "graph_backend='sparse_meta' requires road_supports="
                    "NodeELLPattern, BucketedNodeELLPattern or BlockPattern,"
                    f" got {type(road_supports).__name__}")
            if local != (node_group is not None and node_group.size > 1):
                raise ValueError(
                    "a node-partitioned step takes the rank's rows of the "
                    "pattern (LocalNodePattern or LocalBlockPattern: "
                    "parallel.api cuts them), and only it does")
            if local and road_supports.n_loc != n_nodes:
                raise ValueError(f"the pattern holds {road_supports.n_loc} "
                                 f"rows, x holds {n_nodes} nodes")
            pattern = road_supports_to(road_supports, dtype=compute_dtype,
                                       transpose=torch.is_grad_enabled())
            # The learned weights at the parameters' dtype, then cast.
            if isinstance(pattern, _NODE_PATTERNS + (LocalNodePattern,)):
                weights = sparse_meta_graph_node(mem["Memory"], mem["We1"],
                                                 mem["We2"], pattern)
                if isinstance(getattr(pattern, "pattern", pattern),
                              BucketedNodeELLPattern):
                    weights = tuple(tuple(w_b.to(compute_dtype) for w_b in w)
                                    for w in weights)
                else:
                    weights = tuple(w.to(compute_dtype) for w in weights)
                agg = cheb_aggregate_learned_node
            else:
                weights = tuple(t.to(compute_dtype) for t in sparse_meta_graph(
                    mem["Memory"], mem["We1"], mem["We2"], pattern))
                agg = cheb_aggregate_learned_sparse
            if local:
                from megacrn_tpu_torch.parallel.ring import (
                    cheb_aggregate_learned_node_sharded,
                    cheb_aggregate_learned_sparse_sharded)

                sharded = (cheb_aggregate_learned_node_sharded
                           if agg is cheb_aggregate_learned_node
                           else cheb_aggregate_learned_sparse_sharded)

                def aggregate(weights_, x, cheb_k):
                    return sharded(weights_, pattern, x, cheb_k, node_group)
            else:
                def aggregate(weights_, x, cheb_k):
                    return agg(weights_, pattern, x, cheb_k)

            return weights, aggregate
        raise ValueError(f"unknown graph_backend {backend!r}")
