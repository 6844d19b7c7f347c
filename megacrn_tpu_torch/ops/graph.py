"""Graph aggregation ops: Chebyshev neighbourhood aggregation and the learned
meta-graph (counterpart of ``megacrn_tpu/ops/graph.py``).

Semantics reproduce the reference AGCN support construction
(``model/MegaCRN.py:16-27``) and the hypernetwork meta-graph
(``model/MegaCRN.py:168-173``). Chebyshev polynomials are applied to the
features, ``t_k(x) = 2 A @ t_{k-1}(x) - t_{k-2}(x)``, never built as N x N
matrices. Every stack is ``(B, N, S*K, C)`` in the reference's support-major
order ``[I, g1, T2(g1), ..., I, g2, T2(g2), ...]`` so that a flat reshape
matches the reference weight layout.
"""
from __future__ import annotations

import numpy as np
import torch


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
    from megacrn_tpu_torch.kernels.spmm_coo import (SpmmCOOFunction,
                                                    spmm_coo_reference)

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
    from megacrn_tpu_torch.kernels.spmm import spmm_batched

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
