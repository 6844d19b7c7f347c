"""Graph aggregation ops: Chebyshev neighbourhood aggregation and the learned
meta-graph (counterpart of ``megacrn_tpu/ops/graph.py``).

Semantics reproduce the reference AGCN support construction
(``model/MegaCRN.py:16-27``) and the hypernetwork meta-graph
(``model/MegaCRN.py:168-173``). Chebyshev polynomials are applied to the
features, ``t_k(x) = 2 A @ t_{k-1}(x) - t_{k-2}(x)``, never built as N x N
matrices. Every stack is ``(B, N, S*K, C)`` in the reference's support-major
order ``[I, g1, T2(g1), ..., I, g2, T2(g2), ...]`` so that a flat reshape
matches the reference weight layout.

One table, ``GRAPH_CONSTANTS``, says what each graph constant (the
``road_supports=`` of ``MegaCRN.forward``) does; no caller tests its type.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from megacrn_tpu_torch.kernels.sparse_graph import (
    BlockPattern, LocalBlockPattern, cheb_aggregate_learned_sparse,
    local_block_pattern, sparse_meta_graph)
from megacrn_tpu_torch.kernels.sparse_graph_node import (
    BucketedNodeELLPattern, LocalNodePattern, NodeELLPattern,
    cheb_aggregate_learned_node, local_node_pattern, sparse_meta_graph_node)
from megacrn_tpu_torch.kernels.spmm import (BlockELL, ShardedRoadPacks,
                                            local_packs, spmm_batched)
from megacrn_tpu_torch.kernels.spmm_coo import (
    SpmmCOOFunction, StackedRoadPack, spmm_coo_reference)
from megacrn_tpu_torch.kernels.spmm_ell_node import (
    BucketedShardedNodeELL, BucketedStackedNodeELL, LocalBucketedNodeELL,
    LocalNodeELL, ShardedNodeELL, StackedNodeELL, cheb_aggregate_node_ell,
    local_node_ell)
from megacrn_tpu_torch.parallel import ring


def support_matmul(support: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``einsum('nm,bmc->bnc')``: aggregate node features over one support.

    support: (N, N); x: (B, N, C).
    """
    return torch.einsum("nm,bmc->bnc", support, x)


def cheb_aggregate(supports: torch.Tensor, x: torch.Tensor,
                   cheb_k: int) -> torch.Tensor:
    """Chebyshev feature stack for every support, in reference concat order.

    supports: (S, N, N) dense supports; x: (B, N, C). Returns
    (B, N, S*cheb_k, C) with ``out[:, :, s*K + k] = T_k(A_s) @ x``,
    ``T_0 = I, T_1 = A``.
    """
    terms = []
    for a in supports:
        t_prev, t_cur = x, support_matmul(a, x)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, 2.0 * support_matmul(a, t_cur) - t_prev
            terms.append(t_cur)
    return torch.stack(terms, dim=2)


def cheb_support_stack(supports: torch.Tensor,
                       cheb_k: int) -> torch.Tensor:
    """The row-stacked Chebyshev polynomial matrices, built once per
    forward: ``[T_1(A_0); ..; T_{K-1}(A_0); T_1(A_1); ..]`` ->
    ((K-1)*S*N, N), by the matrix recursion ``T_k = 2 A T_{k-1} - T_{k-2}``.
    ``T_0 = I`` is not stacked: ``cheb_aggregate_prestacked`` splices x
    itself in."""
    s_num, n, _ = supports.shape
    rows = []
    for a in supports:
        t_prev = torch.eye(n, dtype=a.dtype, device=a.device)
        t_cur = a
        rows.append(a)
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, 2.0 * (a @ t_cur) - t_prev
            rows.append(t_cur)
    return torch.cat(rows, dim=0)


def cheb_aggregate_prestacked(stack: torch.Tensor, num_supports: int,
                              x: torch.Tensor, cheb_k: int) -> torch.Tensor:
    """Chebyshev feature stack through ONE tall product with a precomputed
    polynomial stack (``cheb_support_stack``): ``((K-1)*S*N, N) @ (N, B*C)``
    in place of the (K-1)-deep per-support recursion of ``cheb_aggregate``.
    Same math; output layout and order identical: (B, N, S*K, C)."""
    b, n, c = x.shape
    km1 = cheb_k - 1
    y = torch.einsum("pm,bmc->bpc", stack, x)
    terms = []
    for s in range(num_supports):
        terms.append(x)
        for k in range(km1):
            lo = (s * km1 + k) * n
            terms.append(y[:, lo:lo + n, :])
    return torch.stack(terms, dim=2)


def cheb_aggregate_sparse_stacked(packs, x: torch.Tensor,
                                  cheb_k: int) -> torch.Tensor:
    """Chebyshev stack over static sparse supports through ONE
    block-diagonal COO pack (``kernels.spmm_coo.StackedRoadPack``): the
    recursion over all S supports runs on stacked features, so each
    Chebyshev level is one SpMM. Output layout/order identical to
    ``cheb_aggregate``.

    ``packs.impl == "kernel"`` goes through ``SpmmCOOFunction`` (its
    backward is the same kernel on ``packs.pack_t``); ``"reference"`` runs
    ``spmm_coo_reference``, which autograd differentiates by itself."""
    if packs.impl == "kernel":
        def apply(v):
            return SpmmCOOFunction.apply(v, packs.pack, packs.pack_t)
    else:
        def apply(v):
            return spmm_coo_reference(packs.pack, v)
    s_num, n_pad = packs.num_supports, packs.n_pad
    b, n, c = x.shape
    flat = x.permute(1, 0, 2).reshape(n, b * c)
    xp = flat.new_zeros((n_pad, b * c))
    xp[:n] = flat
    x_stack = xp.repeat(s_num, 1)  # (S*n_pad, f), contiguous
    t_prev, t_cur = x_stack, apply(x_stack)
    levels = [None, t_cur]  # level 0 is `flat` itself
    for _ in range(2, cheb_k):
        t_prev, t_cur = t_cur, 2.0 * apply(t_cur) - t_prev
        levels.append(t_cur)
    terms = [flat if k == 0 else levels[k][s * n_pad:s * n_pad + n]
             for s in range(s_num) for k in range(cheb_k)]
    stack = torch.stack(terms, 1)  # (N, S*K, B*C)
    return stack.view(n, s_num * cheb_k, b, c).permute(2, 0, 1, 3)


def cheb_aggregate_sparse(packs, x: torch.Tensor,
                          cheb_k: int) -> torch.Tensor:
    """Chebyshev stack over static sparse supports through the block-ELL
    SpMM (``kernels.spmm``), support by support, in the same support-major
    order as ``cheb_aggregate``.

    packs: sequence of ``(BlockELL, BlockELL_t)`` pairs, one per support.
    """
    terms = []
    for pack, pack_t in packs:
        t_prev, t_cur = x, spmm_batched(pack, pack_t, x)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, (
                2.0 * spmm_batched(pack, pack_t, t_cur) - t_prev)
            terms.append(t_cur)
    return torch.stack(terms, dim=2)


def dual_random_walk_supports(adj) -> tuple:
    """DCRNN-style dual random-walk normalisation of a static road
    adjacency: ``[(D^-1 A)^T, (D^-1 A^T)^T]`` as two dense numpy matrices
    with the pattern of adj / adj^T (pack with
    ``kernels.spmm_coo.build_stacked_road_pack`` or
    ``kernels.spmm.build_road_ell_pairs``)."""

    def rw(a):
        d = a.sum(1)
        # Divide only where d > 0 so isolated nodes stay warning-free.
        d_inv = np.divide(1.0, d, out=np.zeros_like(d), where=d > 0)
        return (d_inv[:, None] * a).T

    adj = np.asarray(adj, np.float32)
    return rw(adj), rw(adj.T)


def meta_graph(memory: torch.Tensor, we1: torch.Tensor,
               we2: torch.Tensor) -> torch.Tensor:
    """Hypernetwork-generated adaptive adjacency pair.

    ``E_i = We_i @ Memory``; ``g1 = softmax(relu(E1 @ E2^T))``,
    ``g2 = softmax(relu(E2 @ E1^T))``. Returns (2, N, N).
    """
    e1 = we1 @ memory
    e2 = we2 @ memory
    g1 = torch.softmax(torch.relu(e1 @ e2.T), dim=-1)
    g2 = torch.softmax(torch.relu(e2 @ e1.T), dim=-1)
    return torch.stack([g1, g2], dim=0)


# ---------------------------------------------------------------------------
# The graph constants: one table says what each type does.
# ---------------------------------------------------------------------------

class GraphConstant(NamedTuple):
    """What the table gives for one kind of graph constant."""

    backend: str  # the graph_backend it serves
    # (c, memory, dtype, node_group, n_nodes, num_supports) -> the
    # (supports, aggregate) of MegaCRN.forward; None for a sharded road
    # constant, whose ranks take the node-partitioned step on their rows.
    graph: Optional[Callable]
    # (c, index, n_shards) -> rank index's rows under a node axis.
    rows: Optional[Callable]


def _cast(c, dtype):
    # Only the values narrow (a no-op once the caller has cast them); the
    # transposed side only when autograd records: only a backward reads it.
    return road_supports_to(c, None, dtype, torch.is_grad_enabled())


def _stacked(aggregate, pack, memory, dtype, node_group, n_nodes,
             num_supports):
    if pack.num_supports != num_supports:
        raise ValueError(f"{type(pack).__name__}"
                         ".num_supports != cfg.num_supports")
    return _cast(pack, dtype), aggregate


def _ell_pairs(pairs, memory, dtype, node_group, n_nodes, num_supports):
    if len(pairs) != num_supports:
        raise ValueError("len(road_supports) != cfg.num_supports")
    # Under a node group: one rank's row-block packs (spmm.local_packs).
    return _cast(pairs, dtype), (
        cheb_aggregate_sparse if node_group is None else partial(
            ring.cheb_aggregate_sparse_sharded, group=node_group))


def _local_node_ell(pack, memory, dtype, node_group, n_nodes, num_supports):
    if node_group is None:
        raise ValueError(
            f"{type(pack).__name__} is one rank's rows: it needs the "
            "node_group of a node-partitioned step")
    return _cast(pack, dtype), partial(
        ring.cheb_aggregate_node_ell_sharded, group=node_group)


def _learned(meta_graph_fn, aggregate, local: bool, pattern, memory, dtype,
             node_group, n_nodes, num_supports):
    """A ``sparse_meta`` pattern: the learned weights on its edges and the
    Chebyshev stack over them. ``local``: one rank's rows, which a
    node-partitioned step takes, and only it."""
    if local != (node_group is not None and node_group.size > 1):
        raise ValueError(
            "a node-partitioned step takes the rank's rows of the "
            "pattern (LocalNodePattern or LocalBlockPattern: "
            "parallel.api cuts them), and only it does")
    if local and pattern.n_loc != n_nodes:
        raise ValueError(f"the pattern holds {pattern.n_loc} "
                         f"rows, x holds {n_nodes} nodes")
    pattern = _cast(pattern, dtype)
    # The learned weights at the parameters' dtype, then cast (a bucketed
    # pattern's per bucket).
    weights = tuple(
        tuple(w_b.to(dtype) for w_b in w) if isinstance(w, tuple)
        else w.to(dtype) for w in meta_graph_fn(
            memory["Memory"], memory["We1"], memory["We2"], pattern))
    agg = (partial(aggregate, group=node_group) if local
           else aggregate)
    return weights, lambda w, x, cheb_k: agg(w, pattern, x, cheb_k)


def _sharded_rows(local, sp, index, n_shards):
    if sp.n_loc * n_shards != sp.n_full:
        raise ValueError(f"the packs are cut for {sp.n_full // sp.n_loc}"
                         f" node shards, the mesh has {n_shards}")
    return local(sp, index)


_ELL_PAIRS = GraphConstant("road_sparse", _ell_pairs, None)

# Each kind of graph constant, with the types that make it.
GRAPH_CONSTANTS = {t: kind for types, kind in (
    ((StackedRoadPack,), GraphConstant("road_sparse", partial(
        _stacked, cheb_aggregate_sparse_stacked), None)),
    ((StackedNodeELL, BucketedStackedNodeELL), GraphConstant(
        "road_sparse", partial(_stacked, cheb_aggregate_node_ell), None)),
    ((LocalNodeELL, LocalBucketedNodeELL), GraphConstant(
        "road_sparse", _local_node_ell, None)),
    ((ShardedRoadPacks,), GraphConstant(
        "road_sparse", None, partial(_sharded_rows, local_packs))),
    ((ShardedNodeELL, BucketedShardedNodeELL), GraphConstant(
        "road_sparse", None, partial(_sharded_rows, local_node_ell))),
    ((NodeELLPattern, BucketedNodeELLPattern), GraphConstant(
        "sparse_meta", partial(_learned, sparse_meta_graph_node,
                          cheb_aggregate_learned_node, False),
        local_node_pattern)),
    ((BlockPattern,), GraphConstant(
        "sparse_meta", partial(_learned, sparse_meta_graph,
                          cheb_aggregate_learned_sparse, False),
        local_block_pattern)),
    ((LocalNodePattern,), GraphConstant("sparse_meta", partial(
        _learned, sparse_meta_graph_node,
        ring.cheb_aggregate_learned_node_sharded, True), None)),
    ((LocalBlockPattern,), GraphConstant("sparse_meta", partial(
        _learned, sparse_meta_graph,
        ring.cheb_aggregate_learned_sparse_sharded, True), None)),
) for t in types}


def graph_constant(c) -> Optional[GraphConstant]:
    """The table's entry for ``c`` (block-ELL pairs: any sequence of
    ``(BlockELL, BlockELL_t)``); None where ``c`` is no graph constant."""
    kind = GRAPH_CONSTANTS.get(type(c))
    if kind is None and isinstance(c, (list, tuple)) and all(
            isinstance(pair, (list, tuple)) and len(pair) == 2
            and all(isinstance(a, BlockELL) for a in pair) for pair in c):
        return _ELL_PAIRS
    return kind


def road_supports_to(road_supports, device=None, dtype=None,
                     transpose: bool = False):
    """Move and cast a graph constant that a forward takes (None stays
    None): index arrays move and are never cast; tile data, weights and
    masks are cast to ``dtype``. The transposed packs (and a node pattern's
    transposed side) are read only by the backward, so they move only when
    ``transpose`` is set."""
    if road_supports is None:
        return None
    kind = graph_constant(road_supports)
    if kind is _ELL_PAIRS:
        return [(a.to(device, dtype),
                 a_t.to(device, dtype) if transpose else a_t)
                for a, a_t in road_supports]
    if kind is None or kind.graph is None:
        raise TypeError(f"{type(road_supports).__name__} is no graph "
                        "constant of a forward (GRAPH_CONSTANTS)")
    return road_supports.to(device, dtype, transpose=transpose)


def captured(c, backend: str, device: torch.device) -> bool:
    """Whether a ``backend`` model's predictor replays its forward on ``c``
    from a CUDA graph: a ``StackedRoadPack`` through the kernel on a CUDA
    device (the reference's ``index_add_`` sums in no fixed order)."""
    return (backend == "road_sparse" and isinstance(c, StackedRoadPack)
            and c.impl == "kernel" and device.type == "cuda")


def node_partitioned(c) -> bool:
    """Whether ``c`` is a sharded road constant, whose mesh run takes the
    node-partitioned step on each rank's rows (``rank_rows``)."""
    kind = graph_constant(c)
    return kind is not None and kind.graph is None


def rank_rows(c, index: int, n_shards: int):
    """Rank ``index``'s rows of the graph constant ``c`` when ``n_shards``
    ranks split the nodes; None stays None."""
    if c is None:
        return None
    kind = graph_constant(c)
    if kind is None or kind.rows is None:
        raise TypeError(f"{type(c).__name__} has no rank's rows "
                        "(GRAPH_CONSTANTS)")
    return kind.rows(c, index, n_shards)
