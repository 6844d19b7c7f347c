"""Block-sparse differentiable graph ops for the learned ``sparse_meta``
backend at 128x128 tile granularity: SDDMM + learned-support SpMM
(counterpart of ``megacrn_tpu/kernels/sparse_graph.py``).

The learned meta-graph is restricted to a fixed edge-block pattern, and
gradients flow into the support values themselves. On the tile layout every
op is a gather and a batched 128x128 dense product, written with
``torch.einsum`` and differentiated by autograd (the gather's backward is a
scatter-add), as the JAX package writes them in XLA with plain autodiff.

* ``sddmm_blocks``: ``tiles[i, r] = E1_blk[i] @ E2_blk[cols[i, r]]^T`` for
  the stored blocks only.
* ``block_row_softmax``: masked softmax over each matrix row across its
  tiles (over the row's edges, where the reference's spans all N columns,
  model/MegaCRN.py:171-172).
* ``spmm_blocks``: ``y = A @ x`` with A given as (tiles, pattern),
  differentiable in both.
* ``sparse_meta_graph``: the composition, a learned sparse support pair.

Pattern layout: per row-block i, a list ``cols[i, r]`` of column-block
indices (padded by repeating a valid index with an all-zero mask tile).
On a node-partitioned mesh each rank holds a ``LocalBlockPattern``
(``local_block_pattern``): the tiles of its contiguous rows against every
column, built from its rows of the adjacency, so a rank whose rows straddle
a 128-row tile boundary gets tiles of its own rows only.
``build_block_pattern`` takes the adjacency in the order given; a caller
that wants fewer tiles reorders it first (``kernels.spmm.rcm_ordering``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

BLOCK = 128


class BlockPattern(NamedTuple):
    """Static sparsity pattern at 128x128 tile granularity + entry masks.

    cols: (nblk, R) int64 column-block per tile slot.
    mask: (nblk, R, BLOCK, BLOCK) float 0/1: which entries inside each tile
      are real edges (padded slots are all-zero, so they add nothing).
    n / n_orig: padded and original node counts.

    No transpose map: autograd's scatter-adds are the transposes.
    """

    cols: torch.Tensor
    mask: torch.Tensor
    n: int
    n_orig: int

    # The rows the pattern covers: all of them (a ``LocalBlockPattern``
    # covers one rank's).
    lo = 0

    @property
    def n_loc(self) -> int:
        return self.n_orig

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "BlockPattern":
        """Move ``cols``; move and cast ``mask``. ``transpose`` is accepted
        for the common mover and changes nothing: there is no transposed
        side."""
        return self._replace(cols=self.cols.to(device),
                             mask=self.mask.to(device=device, dtype=dtype))


class LocalBlockPattern(NamedTuple):
    """One rank's rows ``lo:lo + n_loc`` of a ``BlockPattern``: a
    rectangular pattern of ``ceil(n_loc / 128)`` row-blocks against the
    ``n / 128`` column blocks of the whole graph (``n`` padded, ``n_orig``
    real columns). Its tiles hold the rank's rows only, re-blocked from row
    ``lo``."""

    cols: torch.Tensor
    mask: torch.Tensor
    n: int
    n_orig: int
    lo: int
    n_loc: int

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "LocalBlockPattern":
        """As ``BlockPattern.to``."""
        return self._replace(cols=self.cols.to(device),
                             mask=self.mask.to(device=device, dtype=dtype))


def _tile_pattern(ap: np.ndarray):
    """(cols, mask) of a 0/1 array whose sides are multiples of BLOCK: per
    row-block, its nonzero column blocks in order, padded to the widest
    row-block by repeating its first one under an all-zero mask tile."""
    rb, cb = ap.shape[0] // BLOCK, ap.shape[1] // BLOCK
    tiles = ap.reshape(rb, BLOCK, cb, BLOCK).transpose(0, 2, 1, 3)
    nz = tiles.sum(axis=(2, 3)) > 0
    r_max = max(1, int(nz.sum(1).max()))
    cols = np.zeros((rb, r_max), np.int64)
    mask = np.zeros((rb, r_max, BLOCK, BLOCK), np.float32)
    for i in range(rb):
        cs = np.nonzero(nz[i])[0]
        for r, j in enumerate(cs):
            cols[i, r] = j
            mask[i, r] = tiles[i, j]
        cols[i, len(cs):] = cs[0] if len(cs) else 0
    return torch.from_numpy(cols), torch.from_numpy(mask)


def _padded(n: int) -> int:
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


def build_block_pattern(adj: np.ndarray) -> BlockPattern:
    """The tile pattern of a 0/1 numpy adjacency. Host-side; the arrays are
    CPU tensors (``.to`` moves them)."""
    n_orig = adj.shape[0]
    n = _padded(n_orig)
    ap = np.zeros((n, n), np.float32)
    ap[:n_orig, :n_orig] = (np.asarray(adj) != 0).astype(np.float32)
    return BlockPattern(*_tile_pattern(ap), n, n_orig)


def local_block_pattern(pattern: BlockPattern, index: int,
                        n_shards: int) -> LocalBlockPattern:
    """Rank ``index``'s rows of ``pattern`` when ``n_shards`` ranks split
    its nodes into equal contiguous blocks: its rows of the adjacency, read
    back from the tiles, packed again from its first row."""
    n_orig = pattern.n_orig
    if n_orig % n_shards:
        raise ValueError(f"num_nodes {n_orig} does not divide by the node "
                         f"axis {n_shards}")
    n_loc = n_orig // n_shards
    lo = index * n_loc
    cols = pattern.cols.cpu().numpy()
    mask = pattern.mask.float().cpu().numpy()
    # The row-blocks that hold the rank's rows, as a dense strip.
    b0, b1 = lo // BLOCK, (lo + n_loc - 1) // BLOCK + 1
    strip = np.zeros(((b1 - b0) * BLOCK, pattern.n), np.float32)
    for i in range(b0, b1):
        for r, j in enumerate(cols[i]):  # pad slots add zero tiles
            strip[(i - b0) * BLOCK:(i - b0 + 1) * BLOCK,
                  j * BLOCK:(j + 1) * BLOCK] += mask[i, r]
    ap = np.zeros((_padded(n_loc), pattern.n), np.float32)
    ap[:n_loc] = strip[lo - b0 * BLOCK:lo - b0 * BLOCK + n_loc]
    return LocalBlockPattern(*_tile_pattern(ap), pattern.n, n_orig, lo,
                             n_loc)


def _pad_nodes(x: torch.Tensor, n: int) -> torch.Tensor:
    """x with zero rows appended up to n rows."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros((n - x.shape[0],) + x.shape[1:])])


def sddmm_blocks(e1: torch.Tensor, e2: torch.Tensor,
                 pattern: BlockPattern) -> torch.Tensor:
    """tiles[i, r] = E1_blk[i] @ E2_blk[cols[i, r]]^T (masked).

    e1: (n_loc, d), the pattern's rows; e2: (N, d). Returns
    (nblk, R, BLOCK, BLOCK).
    """
    e1 = _pad_nodes(e1, pattern.mask.shape[0] * BLOCK).reshape(
        -1, BLOCK, e1.shape[-1])
    e2 = _pad_nodes(e2, pattern.n).reshape(-1, BLOCK, e2.shape[-1])
    e2_g = e2[pattern.cols]  # (nblk, R, BLOCK, d)
    tiles = torch.einsum("ibk,irck->irbc", e1, e2_g)
    return tiles * pattern.mask


def spmm_blocks(tiles: torch.Tensor, pattern: BlockPattern,
                x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with A = (tiles, pattern); differentiable in tiles and x.

    x: (N, f) -> (n_loc, f), the pattern's rows. Autograd gives the
    transpose product for dx and the SDDMM-shaped product for dtiles.
    """
    f = x.shape[1]
    xp = _pad_nodes(x, pattern.n).reshape(-1, BLOCK, f)  # (nblk, BLOCK, f)
    x_g = xp[pattern.cols]  # (nblk, R, BLOCK, f)
    y = torch.einsum("irbc,ircf->ibf", tiles, x_g)  # over slots and cols
    return y.reshape(-1, f)[:pattern.n_loc]


def block_row_softmax(tiles: torch.Tensor, pattern: BlockPattern,
                      scale: float = 1.0) -> torch.Tensor:
    """Masked softmax over each matrix row spanning its stored tiles.

    Non-edge entries (mask 0) get probability 0; rows with no edges give 0.
    """
    neg = torch.finfo(tiles.dtype).min
    z = torch.where(pattern.mask > 0, tiles * scale, neg)
    row_max = z.amax(dim=(1, 3), keepdim=True)  # over slots and cols
    e = torch.exp(z - row_max.clamp_min(neg / 2)) * pattern.mask
    denom = e.sum(dim=(1, 3), keepdim=True)
    return e / denom.clamp_min(1e-30)


def sparse_meta_graph(memory: torch.Tensor, we1: torch.Tensor,
                      we2: torch.Tensor, pattern: BlockPattern
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-restricted learned supports: the meta-graph hypernetwork
    (model/MegaCRN.py:168-173) on a static edge pattern only, softmax over
    each row's edges. Returns (tiles_g1, tiles_g2) for ``spmm_blocks``; of
    a ``LocalBlockPattern``, the rank's rows (the embeddings are small and
    computed whole on every rank)."""
    e1 = we1 @ memory
    e2 = we2 @ memory
    rows = slice(pattern.lo, pattern.lo + pattern.n_loc)
    t1 = torch.relu(sddmm_blocks(e1[rows], e2, pattern))
    t2 = torch.relu(sddmm_blocks(e2[rows], e1, pattern))
    return (block_row_softmax(t1, pattern), block_row_softmax(t2, pattern))


def cheb_aggregate_learned_sparse(supports_tiles, pattern: BlockPattern,
                                  x: torch.Tensor,
                                  cheb_k: int) -> torch.Tensor:
    """Chebyshev stack (reference order) over learned sparse supports.

    supports_tiles: sequence of tile arrays; x: (B, N, C) ->
    (B, N, S*K, C).
    """
    b, n, c = x.shape
    flat = x.permute(1, 0, 2).reshape(n, b * c)
    terms = []
    for tiles in supports_tiles:
        t_prev, t_cur = flat, spmm_blocks(tiles, pattern, flat)
        terms += [t_prev, t_cur]
        for _ in range(2, cheb_k):
            t_prev, t_cur = t_cur, (
                2.0 * spmm_blocks(tiles, pattern, t_cur) - t_prev)
            terms.append(t_cur)
    stack = torch.stack(terms, dim=1)  # (N, S*K, B*C)
    return stack.view(n, len(terms), b, c).permute(2, 0, 1, 3)
