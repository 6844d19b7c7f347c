"""Node-partitioned graph aggregation with explicit collectives (counterpart
of ``megacrn_tpu/parallel/ring.py``).

Per rank of the node group (p ranks, local rows n_loc = N / p):
  support_local: (n_loc, N) row block of a dense support
  x_local:       (B, n_loc, C) node block of the features
  y_local[b, i, c] = sum_m support_local[i, m] * x[b, m, c]

``ring_support_matmul`` computes it as p block-column products, one per
ring hop, the neighbour's x block arriving by ``comm.ring_shift`` (the
``ppermute`` toward the lower rank). ``cheb_aggregate_gathered`` is the
same product with the x blocks all-gathered at once: the counterpart of
the all-gather that GSPMD inserts for the ``dense`` backend under a node
axis. ``cheb_aggregate_sparse_sharded`` runs the block-ELL SpMM (the CUDA
kernel on the card) on each rank's rectangular row-block packs,
``cheb_aggregate_node_ell_sharded`` the node-ELL gather-reduce on its rows,
and ``cheb_aggregate_learned_node_sharded`` / ``_sparse_sharded`` the
learned ``sparse_meta`` supports on each rank's rows of the edge pattern;
these all-gather the x node blocks once and re-gather each further
Chebyshev level (``cheb_stack_gathered``). All of them are
differentiable: the shifts and gathers carry their transposes.
"""
from __future__ import annotations

import functools

import torch

from megacrn_tpu_torch.kernels.sparse_graph import spmm_blocks
from megacrn_tpu_torch.kernels.sparse_graph_node import learned_node_apply
from megacrn_tpu_torch.kernels.spmm import spmm_batched
from megacrn_tpu_torch.kernels.spmm_ell_node import apply_local_node_ell
from megacrn_tpu_torch.parallel.comm import (Group, all_gather_nodes,
                                             ring_shift)


def _block_matmul(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nm,bmc->bnc", a, x)


def ring_support_matmul(support_local: torch.Tensor, x_local: torch.Tensor,
                        group: Group) -> torch.Tensor:
    """y_local = (row block of A) @ (all of x), by the ring schedule."""
    p, idx = group.size, group.index
    n_loc = x_local.shape[1]
    # support_local's columns grouped by owner block: (n_loc, p, n_loc)
    cols = support_local.reshape(n_loc, p, n_loc)
    acc = _block_matmul(cols[:, idx], x_local)
    buf = x_local
    for s in range(1, p):
        # After s hops the buffer holds block (idx + s) mod p.
        buf = ring_shift(buf, group)
        acc = acc + _block_matmul(cols[:, (idx + s) % p], buf)
    return acc


def local_meta_supports(memory: torch.Tensor, we1: torch.Tensor,
                        we2: torch.Tensor, group: Group,
                        n_local: int) -> torch.Tensor:
    """This rank's rows of the meta-graph supports (``ops.graph.meta_graph``,
    model/MegaCRN.py:168-173): the node embeddings E1/E2 are small (N x d)
    and computed replicated, then sliced by the rank's node index; the row
    softmax runs over full rows, so the blocks are exact. (2, n_local, N).
    """
    e1 = we1 @ memory
    e2 = we2 @ memory
    lo = group.index * n_local
    e1_loc, e2_loc = e1[lo:lo + n_local], e2[lo:lo + n_local]
    g1 = torch.softmax(torch.relu(e1_loc @ e2.T), dim=-1)
    g2 = torch.softmax(torch.relu(e2_loc @ e1.T), dim=-1)
    return torch.stack([g1, g2], dim=0)


def _cheb_terms(supports, x, cheb_k, matmul):
    terms = []
    for a in supports:
        t_prev, t_cur = x, matmul(a, x)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, 2.0 * matmul(a, t_cur) - t_prev
            terms.append(t_cur)
    return torch.stack(terms, dim=2)


def cheb_aggregate_ring(supports: torch.Tensor, x: torch.Tensor,
                        cheb_k: int, group: Group) -> torch.Tensor:
    """The Chebyshev stack (``ops.graph.cheb_aggregate`` order) with every
    ``A @ x`` on the ring. supports: (S, n_local, N) row blocks; x:
    (B, n_local, C). Returns (B, n_local, S*cheb_k, C)."""
    return _cheb_terms(supports, x, cheb_k,
                       lambda a, t: ring_support_matmul(a, t, group))


def cheb_aggregate_gathered(supports: torch.Tensor, x: torch.Tensor,
                            cheb_k: int, group: Group) -> torch.Tensor:
    """The same stack with each term's node blocks all-gathered over the
    group before the row-block product (the per-support recursion is
    kept)."""
    return _cheb_terms(supports, x, cheb_k, lambda a, t: _block_matmul(
        a, all_gather_nodes(t, group)))


def make_ring_aggregate(mesh):
    """``(support (N, N), x (B, N, C)) -> y`` for the full support and the
    global batch: this rank's (B / data, N / node, C) block of
    ``einsum('nm,bmc->bnc', support, x)``, computed by the ring over the
    mesh's node axis (the batch rows split over the data axis)."""

    def aggregate(support: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n = support.shape[0]
        k, b = n // mesh.node, x.shape[0] // mesh.data
        rows = slice(mesh.node_index * k, (mesh.node_index + 1) * k)
        xb = x[mesh.data_index * b:(mesh.data_index + 1) * b, rows]
        return ring_support_matmul(support[rows], xb, mesh.node_group)

    return aggregate


def cheb_stack_gathered(num_supports: int, apply_local, x: torch.Tensor,
                   cheb_k: int, group: Group) -> torch.Tensor:
    """The Chebyshev stack of the node-partitioned sparse routes:
    ``apply_local(s, t_full)`` multiplies this rank's rows of support ``s``
    into the all-gathered (B, N, C) ``t_full``, giving (B, n_loc, C). x is
    gathered once for every support and each further level re-gathers its
    input; the output stays node-local, (B, n_loc, S*cheb_k, C), and dx
    flows back through the gathers' reduce-scatters."""
    x_full = all_gather_nodes(x, group)
    terms = []
    for s in range(num_supports):
        t_prev, t_cur = x, apply_local(s, x_full)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, (
                2.0 * apply_local(s, all_gather_nodes(t_cur, group))
                - t_prev)
            terms.append(t_cur)
    return torch.stack(terms, dim=2)


def cheb_aggregate_sparse_sharded(packs, x: torch.Tensor, cheb_k: int,
                                  group: Group) -> torch.Tensor:
    """Node-partitioned Chebyshev stack over the static sparse road supports:
    each rank holds the (BlockELL (n_loc x N), BlockELL_t (N x n_loc)) pair
    of its rows for each support (``kernels.spmm.local_packs``) and runs
    the block-ELL SpMM on its rows only (``cheb_stack_gathered``); dx flows
    back through the transposed packs and the gathers' reduce-scatters."""
    return cheb_stack_gathered(
        len(packs), lambda s, t_full: spmm_batched(*packs[s], t_full), x,
        cheb_k, group)


def cheb_aggregate_node_ell_sharded(pack, x: torch.Tensor, cheb_k: int,
                                    group: Group) -> torch.Tensor:
    """Node-partitioned Chebyshev stack: all-gather the x node blocks over
    ``group`` (the mesh's node group), gather-reduce on the local rows
    (``cheb_stack_gathered``). Output (B, n_loc, S*K, C), node-local.
    ``pack``: ``LocalNodeELL`` or ``LocalBucketedNodeELL``."""
    return cheb_stack_gathered(len(pack.nbr), functools.partial(
        apply_local_node_ell, pack), x, cheb_k, group)


def _on_nodes_first(apply, t_full: torch.Tensor) -> torch.Tensor:
    """``apply`` ((N, B*C) -> (n_loc, B*C), the learned products' layout)
    on a (B, N, C) block, giving (B, n_loc, C)."""
    b, n, c = t_full.shape
    y = apply(t_full.permute(1, 0, 2).reshape(n, b * c))
    return y.view(-1, b, c).permute(1, 0, 2)


def cheb_aggregate_learned_node_sharded(weights, local, x: torch.Tensor,
                                        cheb_k: int,
                                        group: Group) -> torch.Tensor:
    """Node-partitioned Chebyshev stack over learned node-ELL supports:
    ``weights`` are this rank's rows of each support
    (``kernels.sparse_graph_node.sparse_meta_graph_node`` of the rank's
    ``LocalNodePattern`` ``local``); x: (B, n_loc, C) -> (B, n_loc,
    S*cheb_k, C). The weights' gradients stay on the rank (its rows only);
    x's come back through the gathers' reduce-scatters."""
    apply = learned_node_apply(local.pattern)
    return cheb_stack_gathered(
        len(weights), lambda s, t_full: _on_nodes_first(
            lambda v: apply(weights[s], v), t_full), x, cheb_k, group)


def cheb_aggregate_learned_sparse_sharded(tiles, local, x: torch.Tensor,
                                          cheb_k: int,
                                          group: Group) -> torch.Tensor:
    """The same stack over learned 128x128-tile supports: ``tiles`` are
    this rank's (``kernels.sparse_graph.sparse_meta_graph`` of its
    ``LocalBlockPattern`` ``local``)."""
    return cheb_stack_gathered(
        len(tiles), lambda s, t_full: _on_nodes_first(
            lambda v: spmm_blocks(tiles[s], local, v), t_full), x, cheb_k,
        group)
