"""Node-level ELL SpMM: the gather-based road-graph path (counterpart of the
single-device part of ``megacrn_tpu/kernels/spmm_ell_node.py``).

A sparse matrix is stored as its rows padded to the graph's largest degree
D (``nbr``: (R, D) neighbour ids, ``w``: (R, D) edge weights, 0 at the
pads), and ``y[r] = sum_d w[r, d] * x[nbr[r, d]]``. Pack bytes are O(N*D)
where a 128x128 tile pack pays for every touched tile. The degree-bucketed
variant sorts rows by degree and pads each of up to ``max_buckets`` groups
only to its own largest degree.

The Chebyshev recursion over S supports runs on ONE stacked pack
(``diag(A_1 .. A_S)``, column ids offset by ``s * n``). The backward is
``dx = A^T dy`` through the transposed pack, a gather with no scatter; the
packs get no gradient (they are graph constants).

The JAX package writes all of this as XLA gathers and reductions, not as a
Pallas kernel, and so does the port, in plain PyTorch. The numpy builders
are copies of the JAX ones; the index arrays become int64 tensors once,
here, and never per call.

The node-partitioned half (``shard_node_ell``, ``local_node_ell``,
``apply_local_node_ell``) gives each rank of the mesh's node axis the ELL
rows of its node block, with GLOBAL column ids: the x node blocks are
all-gathered over the axis (``parallel.ring``) and the gather-reduce runs
on the local rows only; autograd's index backward and the gather's
reduce-scatter carry dx back.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch


def _index(a) -> torch.Tensor:
    """A numpy index array as an int64 tensor (torch gathers take int64)."""
    return torch.from_numpy(np.asarray(a, np.int64))


def _values(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


class NodeELL(NamedTuple):
    """Row-padded neighbour lists of a sparse matrix (possibly rectangular).

    nbr / w: (n_rows, D) int64 / float; pads have w == 0 and nbr == 0.
    n_cols: number of columns of the ORIGINAL matrix (gather source length).
    """

    nbr: torch.Tensor
    w: torch.Tensor
    n_cols: int

    def to(self, device=None, dtype=None) -> "NodeELL":
        """Move both arrays; cast only the weights."""
        return self._replace(nbr=self.nbr.to(device),
                             w=self.w.to(device=device, dtype=dtype))


class StackedNodeELL(NamedTuple):
    """Stacked block-diagonal ``diag(A_1..A_S)`` node-ELL pack (+ transpose
    for the backward). Column ids in ``pack`` are offset by ``s * n`` so the
    Chebyshev recursion runs on (S*n, F) stacked features in ONE gather."""

    pack: NodeELL
    pack_t: NodeELL
    num_supports: int
    n: int  # per-support node count (no padding at node granularity)

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "StackedNodeELL":
        """Move and cast ``pack``, and ``pack_t`` too when ``transpose`` is
        set (only a backward reads it)."""
        out = self._replace(pack=self.pack.to(device, dtype))
        if transpose:
            out = out._replace(pack_t=self.pack_t.to(device, dtype))
        return out


class BucketedStackedNodeELL(NamedTuple):
    """Degree-bucketed stacked node-ELL pack (+ transpose for the backward).

    Rows are sorted by degree and split into up to ``max_buckets`` groups,
    each padded only to its own max; the per-bucket outputs are
    concatenated and un-permuted by ONE gather (``inv``: original row ->
    sorted position).

    fwd_nbr / fwd_w: per-bucket tuples of (n_b, D_b) arrays (sorted order);
    fwd_inv: (R,) int64 with ``y = cat(parts)[fwd_inv]``. The same trio for
    the transposed pack (in-degree distribution). Column ids are stacked
    (offset by s*n) exactly like StackedNodeELL.
    """

    fwd_nbr: tuple
    fwd_w: tuple
    fwd_inv: torch.Tensor
    bwd_nbr: tuple
    bwd_w: tuple
    bwd_inv: torch.Tensor
    num_supports: int
    n: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "BucketedStackedNodeELL":
        """Move the index arrays, move and cast the weights; the transposed
        side only when ``transpose`` is set."""
        sides = ("fwd", "bwd") if transpose else ("fwd",)
        out = {}
        for side in sides:
            out[f"{side}_nbr"] = tuple(a.to(device)
                                       for a in getattr(self, f"{side}_nbr"))
            out[f"{side}_w"] = tuple(a.to(device=device, dtype=dtype)
                                     for a in getattr(self, f"{side}_w"))
            out[f"{side}_inv"] = getattr(self, f"{side}_inv").to(device)
        return self._replace(**out)


def _to_node_ell(rows, cols, vals, n_rows, n_cols):
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    d = max(1, int(counts.max()))
    nbr = np.zeros((n_rows, d), np.int32)
    w = np.zeros((n_rows, d), np.float32)
    slot = np.concatenate([np.arange(c) for c in counts]) if len(rows) else \
        np.zeros((0,), np.int64)
    nbr[rows, slot] = cols
    w[rows, slot] = vals
    return NodeELL(_index(nbr), _values(w), n_cols)


def _bucket_splits(deg_sorted, max_buckets):
    """Optimal bucket cut points: minimise total padded slots
    ``sum_b n_b * max_deg_b`` by DP over the (few) distinct degree values.
    Returns (slots, a list of end indices (exclusive) into the sorted row
    order)."""
    # Candidate cut positions: after the last row of each distinct degree.
    ends = list(np.searchsorted(deg_sorted, np.unique(deg_sorted),
                                side="right"))

    # dp(i, k) = (min slots covering rows [0, ends[i]) with k buckets, cuts)
    @functools.lru_cache(maxsize=None)
    def dp(i, k):
        end = ends[i]
        if k == 1:
            return int(end) * int(deg_sorted[end - 1]), (i,)
        best, best_cuts = dp(i, 1)
        for j in range(i):
            left, cuts = dp(j, k - 1)
            cost = left + (end - ends[j]) * int(deg_sorted[end - 1])
            if cost < best:
                best, best_cuts = cost, cuts + (i,)
        return best, best_cuts

    best, cuts = dp(len(ends) - 1, 1)
    for k in range(2, max_buckets + 1):
        c, cut_ids = dp(len(ends) - 1, k)
        if c < best:
            best, cuts = c, cut_ids
    return best, [ends[i] for i in cuts]


def _slots_for(rows):
    """Per-edge slot index within its (sorted) row run."""
    if not len(rows):
        return np.zeros((0,), np.int64)
    change = np.concatenate([[True], rows[1:] != rows[:-1]])
    idx = np.arange(len(rows))
    run_start = np.maximum.accumulate(np.where(change, idx, 0))
    return idx - run_start


def _to_bucketed(rows, cols, vals, n_rows, max_buckets):
    """COO (stacked ids, lexsorted) -> per-bucket (nbr, w) + inverse
    permutation."""
    counts = np.bincount(rows, minlength=n_rows)
    order = np.argsort(counts, kind="stable")  # rows sorted by degree
    deg_sorted = counts[order]
    _, cut_ends = _bucket_splits(deg_sorted, max_buckets)
    rank = np.empty(n_rows, np.int64)
    rank[order] = np.arange(n_rows)
    slot = _slots_for(rows)
    nbrs, ws = [], []
    start = 0
    for end in cut_ends:
        d_b = max(1, int(deg_sorted[end - 1]))
        nbrs.append(np.zeros((end - start, d_b), np.int32))
        ws.append(np.zeros((end - start, d_b), np.float32))
        start = end
    starts = np.concatenate([[0], np.asarray(cut_ends[:-1])])
    bucket_of = np.searchsorted(np.asarray(cut_ends), rank[rows],
                                side="right")
    local_row = rank[rows] - starts[bucket_of]
    for b in range(len(cut_ends)):
        m = bucket_of == b
        nbrs[b][local_row[m], slot[m]] = cols[m]
        ws[b][local_row[m], slot[m]] = vals[m]
    # y_original[r] = cat(parts)[rank[r]]
    return (tuple(_index(a) for a in nbrs), tuple(_values(a) for a in ws),
            _index(rank))


def _stacked_coo(supports):
    sups = [np.asarray(s, np.float32) for s in supports]
    n = sups[0].shape[0]
    rf, cf, vf = [], [], []
    rt, ct, vt = [], [], []
    for i, a in enumerate(sups):
        r, c = np.nonzero(a)
        v = a[r, c]
        rf.append(r + i * n)
        cf.append(c + i * n)
        vf.append(v)
        rt.append(c + i * n)  # transpose
        ct.append(r + i * n)
        vt.append(v)
    cat = np.concatenate
    return n, len(sups), (cat(rf), cat(cf), cat(vf)), (cat(rt), cat(ct),
                                                       cat(vt))


def _lexsorted(rows, cols, vals):
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def build_stacked_node_ell(supports, max_buckets: int = 4,
                           min_saving: float = 0.10):
    """supports: list of (N, N) numpy arrays (``dual_random_walk_supports``
    of the road adjacency). Builds the stacked forward and transposed packs
    from the nonzeros, never a block-diagonal dense matrix (O(nnz) host
    memory).

    When degree-bucketing (``max_buckets`` > 1) saves at least
    ``min_saving`` of the padded gather slots over both packs, returns a
    ``BucketedStackedNodeELL``; otherwise the flat ``StackedNodeELL``. Both
    run through ``cheb_aggregate_node_ell``. Host-side; the arrays are CPU
    tensors (``.to`` moves them)."""
    n, s_num, fwd_coo, bwd_coo = _stacked_coo(supports)
    r_total = s_num * n
    rf, cf, vf = _lexsorted(*fwd_coo)
    rt, ct, vt = _lexsorted(*bwd_coo)

    # Savings estimate over BOTH packs (the forward buckets by out-degree,
    # the transpose by in-degree; they differ on asymmetric supports).
    flat_slots = 0
    best_slots = 0
    for r_side in (rf, rt):
        counts = np.bincount(r_side, minlength=r_total)
        flat_slots += r_total * max(1, int(counts.max()))
        s, _ = _bucket_splits(np.sort(counts), max_buckets)
        best_slots += s
    if max_buckets > 1 and best_slots <= (1.0 - min_saving) * flat_slots:
        f_nbr, f_w, f_inv = _to_bucketed(rf, cf, vf, r_total, max_buckets)
        b_nbr, b_w, b_inv = _to_bucketed(rt, ct, vt, r_total, max_buckets)
        return BucketedStackedNodeELL(f_nbr, f_w, f_inv, b_nbr, b_w, b_inv,
                                      s_num, n)
    fwd = _to_node_ell(rf, cf, vf, r_total, r_total)
    bwd = _to_node_ell(rt, ct, vt, r_total, r_total)
    return StackedNodeELL(fwd, bwd, s_num, n)


def _occupied(nbr, w) -> int:
    """Occupied-slot count of one (R, D) pack: builders store only nonzero
    values, and only pads have nbr == 0 AND w == 0 (the ``nbr`` half keeps
    the count right after a cast underflows an edge weight)."""
    return int(((w != 0) | (nbr != 0)).sum())


def pack_nnz(pack) -> int:
    """True stored edge count of a stacked node-ELL pack (both variants)."""
    if isinstance(pack, BucketedStackedNodeELL):
        return sum(_occupied(nbr, w)
                   for nbr, w in zip(pack.fwd_nbr, pack.fwd_w))
    return _occupied(pack.pack.nbr, pack.pack.w)


# Max neighbour-slot count to unroll: road graphs sit well under this; a
# wide bucket takes the einsum form instead.
_UNROLL_MAX_D = 32


def _ell_apply(nbr, w, x):
    """y = sum_d w[:, d] * x[nbr[:, d]]: gather + weighted reduce.

    For D <= ``_UNROLL_MAX_D`` the reduction is unrolled into per-slot
    (R, F) gathers accumulated in slot order, the JAX package's order, so
    f32 sums match it; wider rows take ``_ell_einsum``."""
    if nbr.shape[1] <= _UNROLL_MAX_D:
        acc = None
        for d in range(nbr.shape[1]):
            t = w[:, d:d + 1].to(x.dtype) * x[nbr[:, d]]
            acc = t if acc is None else acc + t
        return acc
    return _ell_einsum(nbr, w, x)


def _ell_einsum(nbr, w, x):
    """The same product as one einsum over the (R, D, F) gather."""
    return torch.einsum("rd,rdf->rf", w.to(x.dtype), x[nbr])


class SpmmNodeELLFunction(torch.autograd.Function):
    """y = A @ x through a flat node-ELL pack, differentiable in x:
    ``SpmmNodeELLFunction.apply(x, nbr, w, nbr_t, w_t)``. The backward is
    ``dx = A^T dy`` through the transposed pack, a gather with no scatter;
    the packs get no gradient (the JAX custom VJP ``spmm_node_ell``)."""

    @staticmethod
    def forward(ctx, x, nbr, w, nbr_t, w_t):
        ctx.pack_t = (nbr_t, w_t)
        return _ell_apply(nbr, w, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        nbr_t, w_t = ctx.pack_t
        return _ell_apply(nbr_t, w_t, dy.contiguous()), None, None, None, None


def spmm_node_ell(nbr, w, nbr_t, w_t, x):
    """The JAX ``spmm_node_ell(nbr, w, nbr_t, w_t, x)``: y = A @ x with the
    transposed pack for the backward."""
    return SpmmNodeELLFunction.apply(x, nbr, w, nbr_t, w_t)


def _bucketed_apply(nbrs, ws, inv, x):
    """Per-bucket gather + weighted reduce, concatenated, un-permuted."""
    parts = [_ell_apply(nbr, w, x) for nbr, w in zip(nbrs, ws)]
    return torch.cat(parts, 0)[inv]


class SpmmNodeELLBucketedFunction(torch.autograd.Function):
    """The bucketed counterpart of ``SpmmNodeELLFunction``:
    ``apply(x, fwd_nbr, fwd_w, fwd_inv, bwd_nbr, bwd_w, bwd_inv)`` with the
    fields of a ``BucketedStackedNodeELL``."""

    @staticmethod
    def forward(ctx, x, fwd_nbr, fwd_w, fwd_inv, bwd_nbr, bwd_w, bwd_inv):
        ctx.pack_t = (bwd_nbr, bwd_w, bwd_inv)
        return _bucketed_apply(fwd_nbr, fwd_w, fwd_inv, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return ((_bucketed_apply(*ctx.pack_t, dy.contiguous()),)
                + (None,) * 6)


def spmm_node_ell_bucketed(fwd_nbr, fwd_w, fwd_inv, bwd_nbr, bwd_w, bwd_inv,
                           x):
    """The JAX ``spmm_node_ell_bucketed``: y = A @ x over the bucketed
    layout, with the transposed buckets for the backward."""
    return SpmmNodeELLBucketedFunction.apply(
        x, tuple(fwd_nbr), tuple(fwd_w), fwd_inv, tuple(bwd_nbr),
        tuple(bwd_w), bwd_inv)


def cheb_aggregate_node_ell(packs, x: torch.Tensor,
                            cheb_k: int) -> torch.Tensor:
    """Chebyshev feature stack over static sparse supports through the
    stacked node-ELL pack (flat ``StackedNodeELL`` or bucketed
    ``BucketedStackedNodeELL``). Output layout identical to
    ``ops.graph.cheb_aggregate``: (B, N, S*K, C), support-major
    ``[I, A, T2(A), ...]``."""
    s_num, n = packs.num_supports, packs.n
    b, n_in, c = x.shape
    if n_in != n:
        raise ValueError(f"x has {n_in} nodes, pack expects {n}")
    flat = x.permute(1, 0, 2).reshape(n, b * c)
    x_stack = flat.repeat(s_num, 1)  # (S*n, F)
    if isinstance(packs, BucketedStackedNodeELL):
        def apply(v):
            return spmm_node_ell_bucketed(packs.fwd_nbr, packs.fwd_w,
                                          packs.fwd_inv, packs.bwd_nbr,
                                          packs.bwd_w, packs.bwd_inv, v)
    else:
        def apply(v):
            return spmm_node_ell(packs.pack.nbr, packs.pack.w,
                                 packs.pack_t.nbr, packs.pack_t.w, v)
    levels = [None]
    t_prev, t_cur = x_stack, apply(x_stack)
    levels.append(t_cur)
    for _ in range(2, cheb_k):
        t_prev, t_cur = t_cur, 2.0 * apply(t_cur) - t_prev
        levels.append(t_cur)
    terms = [flat if k == 0 else levels[k][s * n:(s + 1) * n]
             for s in range(s_num) for k in range(cheb_k)]
    stack = torch.stack(terms, 1)  # (N, S*K, F)
    return stack.view(n, s_num * cheb_k, b, c).permute(2, 0, 1, 3)


# ---------------------------------------------------------------------------
# Node-partitioned (mesh) half: each rank owns the ELL rows of its node block.
# ---------------------------------------------------------------------------

class ShardedNodeELL(NamedTuple):
    """Row-partitioned flat node-ELL supports: nbr / w (n_shards, S, n_loc,
    D), every (rank, support) slice padded to one global max degree D;
    column ids are global node ids in [0, n_full)."""

    nbr: torch.Tensor
    w: torch.Tensor
    n_loc: int
    n_full: int


class LocalNodeELL(NamedTuple):
    """One rank's rows: nbr / w (S, n_loc, D)."""

    nbr: torch.Tensor
    w: torch.Tensor
    n_full: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "LocalNodeELL":
        """Move both arrays, cast the weights (no transposed side: the
        backward is autograd's)."""
        return self._replace(nbr=self.nbr.to(device),
                             w=self.w.to(device=device, dtype=dtype))


class BucketedShardedNodeELL(NamedTuple):
    """Degree-bucketed row-partitioned node-ELL supports with one bucket
    layout on every rank: the buckets are cut on the ENVELOPE of the ranks'
    sorted degree profiles (``env[r]`` = the largest r-th smallest local
    degree over the ranks), so bucket b holds the same sorted ranks
    [start_b, end_b) on every rank, padded to the envelope's max D_b.

    nbr / w: per support, per bucket (n_shards, n_b, D_b) arrays; inv: per
    support (n_shards, n_loc) with ``y_local = cat_b(bucket outputs)[inv]``
    (each rank's own un-permute). Column ids are global."""

    nbr: tuple
    w: tuple
    inv: tuple
    n_loc: int
    n_full: int


class LocalBucketedNodeELL(NamedTuple):
    """One rank's buckets: per support, per bucket (n_b, D_b) nbr / w, and
    the (n_loc,) un-permute."""

    nbr: tuple
    w: tuple
    inv: tuple
    n_full: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "LocalBucketedNodeELL":
        return self._replace(
            nbr=tuple(tuple(a.to(device) for a in t) for t in self.nbr),
            w=tuple(tuple(a.to(device=device, dtype=dtype) for a in t)
                    for t in self.w),
            inv=tuple(a.to(device) for a in self.inv))


def shard_node_ell(supports, n_shards: int, max_buckets: int = 4,
                   min_saving: float = 0.10):
    """Row-partition dense numpy supports for the node-partitioned ELL path;
    N must divide by ``n_shards``. When degree bucketing on the envelope
    saves at least ``min_saving`` of the padded gather slots over the flat
    global-max-degree layout, returns a ``BucketedShardedNodeELL``, else (or
    with ``max_buckets=1``) the flat ``ShardedNodeELL``."""
    sups = [np.asarray(s, np.float32) for s in supports]
    n = sups[0].shape[0]
    if n % n_shards:
        raise ValueError(f"num_nodes {n} not divisible by {n_shards}")
    n_loc = n // n_shards
    d_max = 1
    degs = []  # per support: (n_shards, n_loc) local row degrees
    for a in sups:
        deg = (a != 0).sum(1).reshape(n_shards, n_loc)
        degs.append(deg)
        d_max = max(d_max, int(deg.max()))
    flat_slots = len(sups) * n_shards * n_loc * d_max

    if max_buckets > 1:
        plans = []  # per support: (cut_ends, widths) on the envelope
        bucket_slots = 0
        for deg in degs:
            env = np.sort(deg, axis=1).max(axis=0)  # nondecreasing envelope
            _, cut_ends = _bucket_splits(env, max_buckets)
            widths = [max(1, int(env[e - 1])) for e in cut_ends]
            starts = [0] + list(cut_ends[:-1])
            bucket_slots += n_shards * sum(
                (e - s) * d for s, e, d in zip(starts, cut_ends, widths))
            plans.append((cut_ends, widths))
        if bucket_slots <= (1.0 - min_saving) * flat_slots:
            return _shard_node_ell_bucketed(sups, n_shards, degs, plans)

    nbr = np.zeros((n_shards, len(sups), n_loc, d_max), np.int32)
    w = np.zeros((n_shards, len(sups), n_loc, d_max), np.float32)
    for si, a in enumerate(sups):
        for dev in range(n_shards):
            blk = a[dev * n_loc:(dev + 1) * n_loc]
            rows, cols = np.nonzero(blk)
            slot = _slots_for(rows)
            nbr[dev, si][rows, slot] = cols
            w[dev, si][rows, slot] = blk[rows, cols]
    return ShardedNodeELL(_index(nbr), _values(w), n_loc, n)


def _shard_node_ell_bucketed(sups, n_shards, degs, plans):
    """Pack every rank's degree-sorted local rows into the shared envelope
    buckets (``plans``: per support (cut_ends, widths))."""
    n = sups[0].shape[0]
    n_loc = n // n_shards
    all_nbr, all_w, all_inv = [], [], []
    for a, deg, (cut_ends, widths) in zip(sups, degs, plans):
        starts = [0] + list(cut_ends[:-1])
        nbrs = [np.zeros((n_shards, e - s, d), np.int32)
                for s, e, d in zip(starts, cut_ends, widths)]
        ws = [np.zeros((n_shards, e - s, d), np.float32)
              for s, e, d in zip(starts, cut_ends, widths)]
        inv = np.zeros((n_shards, n_loc), np.int64)
        starts_a, ends_a = np.asarray(starts), np.asarray(cut_ends)
        for dev in range(n_shards):
            order = np.argsort(deg[dev], kind="stable")
            rank = np.empty(n_loc, np.int64)
            rank[order] = np.arange(n_loc)
            inv[dev] = rank
            blk = a[dev * n_loc:(dev + 1) * n_loc]
            rows, cols = np.nonzero(blk)  # row-major: rows nondecreasing
            vals = blk[rows, cols]
            slot = _slots_for(rows)
            r_rank = rank[rows]
            bucket_of = np.searchsorted(ends_a, r_rank, side="right")
            local_row = r_rank - starts_a[bucket_of]
            for b in range(len(cut_ends)):
                m = bucket_of == b
                nbrs[b][dev][local_row[m], slot[m]] = cols[m]
                ws[b][dev][local_row[m], slot[m]] = vals[m]
        all_nbr.append(tuple(_index(x) for x in nbrs))
        all_w.append(tuple(_values(x) for x in ws))
        all_inv.append(_index(inv))
    return BucketedShardedNodeELL(tuple(all_nbr), tuple(all_w),
                                  tuple(all_inv), n_loc, n)


def local_node_ell(sp, index: int):
    """Rank ``index``'s rows of a ``ShardedNodeELL`` or
    ``BucketedShardedNodeELL``."""
    if isinstance(sp, BucketedShardedNodeELL):
        pick = lambda t: tuple(a[index] for a in t)
        return LocalBucketedNodeELL(tuple(pick(t) for t in sp.nbr),
                                    tuple(pick(t) for t in sp.w),
                                    pick(sp.inv), sp.n_full)
    return LocalNodeELL(sp.nbr[index], sp.w[index], sp.n_full)


def _apply_batched(nbr, w, t_full):
    """y[b, r] = sum_d w[r, d] * t_full[b, nbr[r, d]]: the batch-first form
    of ``_ell_apply``, unrolled in slot order for small D like the JAX
    package (its f32 sums), one einsum above ``_UNROLL_MAX_D``."""
    if nbr.shape[1] <= _UNROLL_MAX_D:
        acc = None
        for d in range(nbr.shape[1]):
            t = w[:, d, None].to(t_full.dtype) * t_full[:, nbr[:, d]]
            acc = t if acc is None else acc + t
        return acc
    return torch.einsum("rd,brdc->brc", w.to(t_full.dtype), t_full[:, nbr])


def apply_local_node_ell(pack, s: int, t_full):
    """Support ``s`` of one rank's rows (``LocalNodeELL``, or
    ``LocalBucketedNodeELL``: per-bucket gather-reduce, concatenated, one
    un-permute) on the all-gathered x: (B, N, C) -> (B, n_loc, C)."""
    if isinstance(pack, LocalBucketedNodeELL):
        return torch.cat([_apply_batched(nbr_b, w_b, t_full) for nbr_b, w_b
                          in zip(pack.nbr[s], pack.w[s])], 1)[:, pack.inv[s]]
    return _apply_batched(pack.nbr[s], pack.w[s], t_full)
