"""Node-granular differentiable sparse graph ops for the learned
``sparse_meta`` backend: SDDMM, masked row softmax and a learned-support
SpMM (counterpart of ``megacrn_tpu/kernels/sparse_graph_node.py``).

Every op works at (row, neighbour-slot) granularity on a static edge
pattern, so pattern bytes are O(nnz):

* ``sddmm_node``: ``scores[r, d] = e1[r] . e2[nbr[r, d]]`` on the edge
  slots only. Plain autograd (the gather's backward is the scatter-add for
  d_e2, as in the JAX package).
* ``node_row_softmax``: masked softmax over each row's valid slots; empty
  rows give 0.
* ``spmm_node``: ``y[r] = sum_d w[r, d] * x[nbr[r, d]]``, an autograd
  Function whose backward is scatter-free in both inputs: dx rides the
  transposed pattern (its values are the forward weights gathered through a
  precomputed slot map), dw is the SDDMM ``dy . x[nbr]``.
* ``sparse_meta_graph_node`` / ``cheb_aggregate_learned_node``: the learned
  sparse supports of the meta-graph hypernetwork (``model/MegaCRN.py:
  168-173``) and the Chebyshev stack in the reference order
  (``model/MegaCRN.py:17-26``).

The softmax spans a row's edges only, where the reference's spans all N
columns: the two are equal on a complete pattern. On a node-partitioned
mesh each rank holds a ``LocalNodePattern`` (``local_node_pattern``): its
contiguous rows of the pattern, flat or bucketed again among themselves,
with the (N x n_loc) transpose of those rows for the backward. The JAX
package writes these ops in XLA, not Pallas, and the port in plain
PyTorch. The numpy builders are copies of the JAX ones; index arrays are
int64 tensors from the start.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from megacrn_tpu_torch.kernels.spmm_ell_node import (_UNROLL_MAX_D,
                                                     _bucket_splits,
                                                     _ell_apply, _index,
                                                     _values)


def _move(t, device, dtype=None):
    """A tensor, or a tuple of them, moved (and cast, for values)."""
    if isinstance(t, tuple):
        return tuple(a.to(device=device, dtype=dtype) for a in t)
    return t.to(device=device, dtype=dtype)


class NodeELLPattern(NamedTuple):
    """Static edge pattern as row-padded neighbour lists + transpose map.

    nbr / mask: (N, D) int64 / float, column id per slot, 1 on real edges
      (pads point at column 0 with mask 0).
    t_nbr / t_slot / t_mask: (N, Dt), the TRANSPOSED pattern: row c of the
      transpose lists the source rows r of edges (r, c), and ``t_slot``
      holds each edge's flat index r*D+d into the forward (N, D) value
      array, so the transposed weights of a learned support are one gather
      ``w.reshape(-1)[t_slot] * t_mask`` away (no scatter).
    n_orig: node count (no padding at node granularity).
    """

    nbr: torch.Tensor
    mask: torch.Tensor
    t_nbr: torch.Tensor
    t_slot: torch.Tensor
    t_mask: torch.Tensor
    n_orig: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "NodeELLPattern":
        """Move the index arrays, move and cast the masks; the transposed
        side only when ``transpose`` is set (only a backward reads it)."""
        out = self._replace(nbr=_move(self.nbr, device),
                            mask=_move(self.mask, device, dtype))
        if transpose:
            out = out._replace(t_nbr=_move(self.t_nbr, device),
                               t_slot=_move(self.t_slot, device),
                               t_mask=_move(self.t_mask, device, dtype))
        return out


class BucketedNodeELLPattern(NamedTuple):
    """Degree-bucketed edge pattern for the learned sparse path.

    Rows sorted by degree, each bucket padded only to its own max degree,
    with per-bucket original ``rows`` ids (so SDDMM can gather e1 rows) and
    a transpose slot map whose indices address the CONCATENATED per-bucket
    flat weight layout (so the backward's dx stays scatter-free).

    Per-bucket tuples (sorted-row order): nbr / mask (n_b, D_b), rows (n_b,).
    inv: (N,), ``y_original = cat(per-bucket outputs)[inv]``.
    Transpose side: t_nbr / t_slot / t_mask per-bucket tuples + t_inv, with
    ``t_slot`` flat indices into ``cat_b(w_b.reshape(-1))``.
    """

    nbr: tuple
    mask: tuple
    rows: tuple
    inv: torch.Tensor
    t_nbr: tuple
    t_slot: tuple
    t_mask: tuple
    t_inv: torch.Tensor
    n_orig: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "BucketedNodeELLPattern":
        """As ``NodeELLPattern.to``."""
        out = self._replace(nbr=_move(self.nbr, device),
                            mask=_move(self.mask, device, dtype),
                            rows=_move(self.rows, device),
                            inv=_move(self.inv, device))
        if transpose:
            out = out._replace(t_nbr=_move(self.t_nbr, device),
                               t_slot=_move(self.t_slot, device),
                               t_mask=_move(self.t_mask, device, dtype),
                               t_inv=_move(self.t_inv, device))
        return out


def _slots(counts):
    return (np.concatenate([np.arange(c) for c in counts])
            if counts.sum() else np.zeros((0,), np.int64))


def build_node_pattern(adj: np.ndarray, max_buckets: int = 4,
                       min_saving: float = 0.10):
    """The node-level pattern (+ transpose slot map) of a 0/1 numpy
    adjacency; O(nnz) host work and pattern bytes.

    When degree-bucketing saves at least ``min_saving`` of the padded slots
    over both sides (the forward buckets by out-degree, the transpose by
    in-degree), returns a ``BucketedNodeELLPattern``; otherwise the flat
    ``NodeELLPattern``. ``max_buckets=1`` forces the flat layout."""
    a = np.asarray(adj) != 0
    if max_buckets > 1:
        flat_slots = 0
        best_slots = 0
        for counts in (np.bincount(np.nonzero(a)[0], minlength=a.shape[0]),
                       np.bincount(np.nonzero(a)[1], minlength=a.shape[0])):
            flat_slots += len(counts) * max(1, int(counts.max()))
            s, _ = _bucket_splits(np.sort(counts), max_buckets)
            best_slots += s
        if best_slots <= (1.0 - min_saving) * flat_slots:
            return build_node_pattern_bucketed(adj, max_buckets)
    n = a.shape[0]
    rows, cols = np.nonzero(a)
    return _flat_pattern(rows, cols, n, n)


def _flat_pattern(rows, cols, n_rows: int, n_cols: int) -> NodeELLPattern:
    """The flat pattern of the edges (rows[e], cols[e]) of an (n_rows x
    n_cols) matrix; its transposed side has n_cols rows."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    counts = np.bincount(rows, minlength=n_rows)
    d = max(1, int(counts.max()))
    nbr = np.zeros((n_rows, d), np.int64)
    mask = np.zeros((n_rows, d), np.float32)
    slot = _slots(counts)
    nbr[rows, slot] = cols
    mask[rows, slot] = 1.0
    flat = rows.astype(np.int64) * d + slot  # edge position in w.reshape(-1)

    t_order = np.lexsort((rows, cols))
    tr, tc, tf = cols[t_order], rows[t_order], flat[t_order]
    t_counts = np.bincount(tr, minlength=n_cols)
    dt = max(1, int(t_counts.max()))
    t_nbr = np.zeros((n_cols, dt), np.int64)
    t_slot = np.zeros((n_cols, dt), np.int64)
    t_mask = np.zeros((n_cols, dt), np.float32)
    ts = _slots(t_counts)
    t_nbr[tr, ts] = tc
    t_slot[tr, ts] = tf
    t_mask[tr, ts] = 1.0
    return NodeELLPattern(_index(nbr), _values(mask), _index(t_nbr),
                          _index(t_slot), _values(t_mask), n_rows)


def build_node_pattern_bucketed(adj: np.ndarray,
                                max_buckets: int = 4) -> BucketedNodeELLPattern:
    """Bucketed variant of ``build_node_pattern`` (same 0/1 adjacency in)."""
    a = np.asarray(adj) != 0
    rows, cols = np.nonzero(a)
    return _bucketed_pattern(rows, cols, a.shape[0], a.shape[0],
                             max_buckets)


def _bucketed_pattern(rows, cols, n_rows: int, n_cols: int,
                      max_buckets: int) -> BucketedNodeELLPattern:
    """The bucketed pattern of the edges (rows[e], cols[e]) of an (n_rows x
    n_cols) matrix; its transposed side buckets the n_cols columns."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]

    def bucketize(r, c, payload, n):
        """r sorted-major; payload (len(r),) carried into the slot arrays.
        Returns (nbr, mask, rows, payload tuples, inv, the flat index of
        every edge's slot in the concatenated layout)."""
        counts = np.bincount(r, minlength=n)
        order_rows = np.argsort(counts, kind="stable")
        deg_sorted = counts[order_rows]
        _, cut_ends = _bucket_splits(deg_sorted, max_buckets)
        rank = np.empty(n, np.int64)
        rank[order_rows] = np.arange(n)
        # r is sorted, so slot positions are run offsets.
        idx = np.arange(len(r))
        if len(r):
            change = np.concatenate([[True], r[1:] != r[:-1]])
            run_start = np.maximum.accumulate(np.where(change, idx, 0))
            slot = idx - run_start
        else:
            slot = idx
        starts = np.concatenate([[0], np.asarray(cut_ends[:-1])])
        d_bs = [max(1, int(deg_sorted[end - 1])) for end in cut_ends]
        # flat offset of each bucket's value block in cat(w_b.ravel())
        flat_off = np.concatenate(
            [[0], np.cumsum([(e - s) * d
                             for s, e, d in zip(starts, cut_ends, d_bs)])])
        bucket_of = np.searchsorted(np.asarray(cut_ends), rank[r],
                                    side="right")
        local_row = rank[r] - starts[bucket_of]
        edge_flat = (flat_off[bucket_of] +
                     local_row * np.asarray(d_bs)[bucket_of] + slot)
        nbrs, masks, rows_ids, pay = [], [], [], []
        for b, (s, e, d_b) in enumerate(zip(starts, cut_ends, d_bs)):
            m = bucket_of == b
            nbr_b = np.zeros((e - s, d_b), np.int64)
            mask_b = np.zeros((e - s, d_b), np.float32)
            pay_b = np.zeros((e - s, d_b), np.int64)
            nbr_b[local_row[m], slot[m]] = c[m]
            mask_b[local_row[m], slot[m]] = 1.0
            if payload is not None:
                pay_b[local_row[m], slot[m]] = payload[m]
            nbrs.append(_index(nbr_b))
            masks.append(_values(mask_b))
            pay.append(_index(pay_b))
            rows_ids.append(_index(order_rows[s:e]))
        return (tuple(nbrs), tuple(masks), tuple(rows_ids), tuple(pay),
                _index(rank), edge_flat)

    f_nbr, f_mask, f_rows, _, f_inv, edge_flat = bucketize(rows, cols, None,
                                                           n_rows)
    # Transpose: edge (r, c) lives in t-row c; its t_slot points at the
    # edge's flat position in the FORWARD concatenated weight layout.
    t_order = np.lexsort((rows, cols))
    t_nbr, t_mask, _, t_slot, t_inv, _ = bucketize(
        cols[t_order], rows[t_order], edge_flat[t_order], n_cols)
    return BucketedNodeELLPattern(f_nbr, f_mask, f_rows, f_inv,
                                  t_nbr, t_slot, t_mask, t_inv, n_rows)


class LocalNodePattern(NamedTuple):
    """One rank's rows ``lo:lo + n_loc`` of a node pattern: ``pattern``
    is a ``NodeELLPattern`` or ``BucketedNodeELLPattern`` of the rank's
    (n_loc x N) rows, its row ids local (0 is row ``lo``) and its column
    ids global; its transposed side has N rows, listing the local rows of
    each column's edges."""

    pattern: object
    lo: int

    @property
    def n_loc(self) -> int:
        return self.pattern.n_orig

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "LocalNodePattern":
        return self._replace(pattern=self.pattern.to(device, dtype,
                                                     transpose=transpose))


def _edges(pattern):
    """(rows, cols) of a node pattern's edges, as numpy arrays."""
    if isinstance(pattern, BucketedNodeELLPattern):
        rows, cols = [], []
        for nbr, mask, ids in zip(pattern.nbr, pattern.mask, pattern.rows):
            i, d = np.nonzero(mask.float().cpu().numpy())
            rows.append(ids.cpu().numpy()[i])
            cols.append(nbr.cpu().numpy()[i, d])
        return np.concatenate(rows), np.concatenate(cols)
    r, d = np.nonzero(pattern.mask.float().cpu().numpy())
    return r, pattern.nbr.cpu().numpy()[r, d]


def local_node_pattern(pattern, index: int,
                       n_shards: int) -> LocalNodePattern:
    """Rank ``index``'s rows of a ``NodeELLPattern`` or
    ``BucketedNodeELLPattern`` when ``n_shards`` ranks split its nodes into
    equal contiguous blocks. A bucketed pattern's rows are bucketed again
    among the rank's own rows (up to 4 buckets, ``build_node_pattern``'s
    default), as the sharded node-ELL road packs are; each row keeps its
    edges in column order, so every row sums as on one device."""
    n = pattern.n_orig
    if n % n_shards:
        raise ValueError(f"num_nodes {n} does not divide by the node axis "
                         f"{n_shards}")
    n_loc = n // n_shards
    lo = index * n_loc
    rows, cols = _edges(pattern)
    keep = (rows >= lo) & (rows < lo + n_loc)
    rows, cols = rows[keep] - lo, cols[keep]
    if isinstance(pattern, BucketedNodeELLPattern):
        local = _bucketed_pattern(rows, cols, n_loc, n, 4)
    else:
        local = _flat_pattern(rows, cols, n_loc, n)
    return LocalNodePattern(local, lo)


def _slot_spmm(w, nbr, x):
    """y = sum_d w[:, d] * x[nbr[:, d]]; w (R, D), x (N, F) -> (R, F): the
    one implementation of the unroll policy, ``spmm_ell_node._ell_apply``."""
    return _ell_apply(nbr, w, x)


def _slot_sddmm(a, nbr, b):
    """scores[:, d] = a . b[nbr[:, d]]; a (R, K), b (N, K) -> (R, D)."""
    if nbr.shape[1] <= _UNROLL_MAX_D:
        return torch.stack([torch.sum(a * b[nbr[:, d]], dim=-1)
                            for d in range(nbr.shape[1])], dim=1)
    return torch.einsum("rk,rdk->rd", a, b[nbr])


def sddmm_node(e1: torch.Tensor, e2: torch.Tensor, nbr: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """scores[r, d] = e1[r] . e2[nbr[r, d]] (masked). e1/e2: (N, dim)."""
    return _slot_sddmm(e1, nbr, e2) * mask


def node_row_softmax(scores: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax over each row's valid slots; empty rows give 0. The
    masked slots take ``finfo(scores.dtype).min`` and the row max is clamped
    at half of it, so an empty row's exp underflows to 0 in every dtype."""
    neg = torch.finfo(scores.dtype).min
    z = torch.where(mask > 0, scores, neg)
    row_max = z.amax(dim=-1, keepdim=True)
    e = torch.exp(z - row_max.clamp_min(neg / 2)) * mask
    denom = e.sum(dim=-1, keepdim=True)
    return e / denom.clamp_min(1e-30)


class SpmmNodeFunction(torch.autograd.Function):
    """y[r] = sum_d w[r, d] * x[nbr[r, d]], differentiable in w AND x and
    scatter-free both ways: ``apply(w, x, nbr, mask, t_nbr, t_slot,
    t_mask)`` (the JAX custom VJP ``spmm_node``)."""

    @staticmethod
    def forward(ctx, w, x, nbr, mask, t_nbr, t_slot, t_mask):
        ctx.save_for_backward(w, x)
        ctx.pattern = (nbr, mask, t_nbr, t_slot, t_mask)
        return _slot_spmm(w, nbr, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        nbr, mask, t_nbr, t_slot, t_mask = ctx.pattern
        dy = dy.contiguous()
        dw = dx = None
        if ctx.needs_input_grad[1]:
            # dx = A^T dy: the transposed pattern's values are the forward
            # weights gathered through the precomputed slot map.
            w_t = w.reshape(-1)[t_slot] * t_mask.to(w.dtype)
            dx = _slot_spmm(w_t, t_nbr, dy)
        if ctx.needs_input_grad[0]:
            dw = _slot_sddmm(dy, nbr, x) * mask.to(dy.dtype)
        return dw, dx, None, None, None, None, None


def spmm_node(nbr, mask, t_nbr, t_slot, t_mask, w, x):
    """The JAX ``spmm_node``: y = A_w @ x on a flat pattern. w: (N, D);
    x: (N, F) -> (N, F)."""
    return SpmmNodeFunction.apply(w, x, nbr, mask, t_nbr, t_slot, t_mask)


def sddmm_node_bucketed(e1, e2, pattern: BucketedNodeELLPattern):
    """Per-bucket SDDMM: scores_b[i, d] = e1[rows_b[i]] . e2[nbr_b[i, d]].
    Returns a tuple of per-bucket (n_b, D_b) score arrays."""
    return tuple(
        _slot_sddmm(e1[rows], nbr, e2) * mask
        for nbr, mask, rows in zip(pattern.nbr, pattern.mask, pattern.rows))


def node_row_softmax_bucketed(scores, pattern: BucketedNodeELLPattern):
    """Masked softmax per row; rows never span buckets."""
    return tuple(node_row_softmax(s, m)
                 for s, m in zip(scores, pattern.mask))


class SpmmNodeBucketedFunction(torch.autograd.Function):
    """The bucketed counterpart of ``SpmmNodeFunction``:
    ``apply(pattern, x, *w)`` with ``w`` the per-bucket weights; returns
    (N, F) in the ORIGINAL row order."""

    @staticmethod
    def forward(ctx, pattern, x, *w):
        ctx.save_for_backward(x, *w)
        ctx.pattern = pattern
        parts = [_slot_spmm(w_b, nbr_b, x)
                 for w_b, nbr_b in zip(w, pattern.nbr)]
        return torch.cat(parts, 0)[pattern.inv]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, *w = ctx.saved_tensors
        p = ctx.pattern
        dy = dy.contiguous()
        dx = None
        if ctx.needs_input_grad[1]:
            # dx = A^T dy: transposed-pattern weights gathered from the
            # forward's concatenated layout through the flat slot map.
            w_flat = torch.cat([w_b.reshape(-1) for w_b in w])
            dx = torch.cat(
                [_slot_spmm(w_flat[ts] * tm.to(w_flat.dtype), tn, dy)
                 for tn, ts, tm in zip(p.t_nbr, p.t_slot, p.t_mask)],
                0)[p.t_inv]
        # dw_b = SDDMM(dy[rows_b], x[nbr_b]) on the pattern slots.
        dw = tuple(
            _slot_sddmm(dy[rows_b], nbr_b, x) * mask_b.to(dy.dtype)
            if ctx.needs_input_grad[2 + b] else None
            for b, (rows_b, nbr_b, mask_b) in enumerate(
                zip(p.rows, p.nbr, p.mask)))
        return (None, dx) + dw


def spmm_node_bucketed(nbr, mask, rows, inv, t_nbr, t_slot, t_mask, t_inv,
                       w, x):
    """The JAX ``spmm_node_bucketed``: y = A_w @ x over the bucketed layout,
    differentiable in w (a tuple of per-bucket arrays) and x."""
    pattern = BucketedNodeELLPattern(tuple(nbr), tuple(mask), tuple(rows),
                                     inv, tuple(t_nbr), tuple(t_slot),
                                     tuple(t_mask), t_inv, inv.shape[0])
    return SpmmNodeBucketedFunction.apply(pattern, x, *w)


def sparse_meta_graph_node(memory: torch.Tensor, we1: torch.Tensor,
                           we2: torch.Tensor, pattern) -> Tuple:
    """Edge-restricted learned supports at node granularity: the
    meta-graph hypernetwork (model/MegaCRN.py:168-173) on the pattern slots
    only, softmax over each row's edges. (w1, w2) as (N, D) arrays for a
    ``NodeELLPattern``, as per-bucket tuples for a
    ``BucketedNodeELLPattern``; both go to ``cheb_aggregate_learned_node``.
    Of a ``LocalNodePattern``, the rank's rows (the embeddings are small and
    computed whole on every rank)."""
    e1 = we1 @ memory
    e2 = we2 @ memory
    lo = 0
    if isinstance(pattern, LocalNodePattern):
        lo, pattern = pattern.lo, pattern.pattern
    rows = slice(lo, lo + pattern.n_orig)
    if isinstance(pattern, BucketedNodeELLPattern):
        def relu_t(t):
            return tuple(torch.relu(s) for s in t)
        s1 = relu_t(sddmm_node_bucketed(e1[rows], e2, pattern))
        s2 = relu_t(sddmm_node_bucketed(e2[rows], e1, pattern))
        return (node_row_softmax_bucketed(s1, pattern),
                node_row_softmax_bucketed(s2, pattern))
    s1 = torch.relu(sddmm_node(e1[rows], e2, pattern.nbr, pattern.mask))
    s2 = torch.relu(sddmm_node(e2[rows], e1, pattern.nbr, pattern.mask))
    return (node_row_softmax(s1, pattern.mask),
            node_row_softmax(s2, pattern.mask))


def learned_node_apply(pattern):
    """``(w, v) -> A_w @ v`` on a flat or bucketed pattern: v (columns, F)
    -> (rows, F), differentiable in w and v."""
    if isinstance(pattern, BucketedNodeELLPattern):
        def apply(w, v):
            return spmm_node_bucketed(
                pattern.nbr, tuple(m.to(v.dtype) for m in pattern.mask),
                pattern.rows, pattern.inv, pattern.t_nbr, pattern.t_slot,
                tuple(m.to(v.dtype) for m in pattern.t_mask), pattern.t_inv,
                tuple(a.to(v.dtype) for a in w), v)
    else:
        def apply(w, v):
            return spmm_node(pattern.nbr, pattern.mask.to(v.dtype),
                             pattern.t_nbr, pattern.t_slot,
                             pattern.t_mask.to(v.dtype), w, v)
    return apply


def cheb_aggregate_learned_node(weights, pattern, x: torch.Tensor,
                                cheb_k: int) -> torch.Tensor:
    """Chebyshev stack (reference order, model/MegaCRN.py:17-26) over
    learned node-ELL supports. weights: a sequence of (N, D) arrays (flat
    pattern) or of per-bucket tuples (bucketed pattern); x: (B, N, C) ->
    (B, N, S*K, C)."""
    b, n, c = x.shape
    flat = x.permute(1, 0, 2).reshape(n, b * c)
    apply = learned_node_apply(pattern)
    terms = []
    for w in weights:
        t_prev, t_cur = flat, apply(w, flat)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, 2.0 * apply(w, t_cur) - t_prev
            terms.append(t_cur)
    stack = torch.stack(terms, dim=1)  # (N, S*K, B*C)
    return stack.view(n, len(terms), b, c).permute(2, 0, 1, 3)
