"""Block-ELL SpMM for static road supports (counterpart of
``megacrn_tpu/kernels/spmm.py``).

A sparse matrix is stored per row-block as ``max_blocks`` 128x128 tiles and
their column-block indices, with ``nnz_blocks`` real tiles per row-block;
padding entries repeat a valid column index with a zero tile, exactly as
the JAX package packs it. ``graph_backend="road_sparse"`` with a list of
``(BlockELL, BlockELL_t)`` pairs, one per support, aggregates through it
(``ops.graph.cheb_aggregate_sparse``). Beside the tiles each pack carries
the nonzero list the CUDA kernel reads (``nz_row_ptr``, ``nz_cols``,
``nz_vals``: a CSR of the entries ``!= 0`` of the real tiles,
``r < nnz_blocks[i]``, built once on the host by
``row_spmm.nonzero_rows``).

Two implementations of ``y = A @ x``:

* ``spmm_reference``: the plain PyTorch version (gather the x tiles by
  ``cols``, one batched matmul, sum over the tile axis, accumulating in at
  least f32). The CPU tests use it and ``chip_smoke.py`` holds the kernel
  against it on the card.
* ``spmm``: the wrapper of the hand-written Hopper kernel
  ``kernels/csrc/spmm_ell.cu``, which reads only the nonzero list, so
  neither padding tiles nor the zeros inside a tile cost it anything. A CPU
  tensor takes the plain version; a CUDA tensor launches the kernel or
  raises. On finite x the two agree; a non-finite value in x reaches only
  the rows that reference it in the kernel, its whole row-block in the
  plain version (which multiplies the zeros too).

``SpmmELLFunction`` makes ``spmm`` differentiable in x (backward: the same
kernel on the transposed pack); ``spmm_batched`` folds a batch into the
feature axis.

The node-partitioned half (``shard_road_packs``, ``local_packs``,
``rcm_ordering``) cuts each support into the row blocks of the mesh's node
axis: rank d multiplies its rectangular (n_loc x N) pack by the gathered x
(``parallel.ring.cheb_aggregate_sparse_sharded``) and its (N x n_loc)
transpose carries the backward, through the same kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from megacrn_tpu_torch.kernels import row_spmm
from megacrn_tpu_torch.kernels.row_spmm import BLOCK


class BlockELL(NamedTuple):
    """Block-ELL sparse matrix (possibly rectangular).

    data: (nblk_rows, max_blocks, BLOCK, BLOCK) tiles per row-block, padded
      with zero tiles.
    cols: (nblk_rows, max_blocks) int32 column-block index per tile; padding
      entries repeat a valid index.
    nnz_blocks: (nblk_rows,) int32 number of real tiles per row-block.
    n / n_orig: padded and original ROW dims; n_col / n_col_orig: column dims
      (-1 = square).
    impl: how ``ops.graph.cheb_aggregate_sparse`` multiplies by it:
      ``"kernel"`` (``spmm``: the CUDA kernel on the card, the plain version
      on the CPU) or ``"reference"`` (``spmm_reference`` on any device, for
      holding the kernel against it).
    nz_row_ptr / nz_cols / nz_vals: the nonzero list the kernel reads, a CSR
      over the n padded rows (see ``row_spmm``); ``to_block_ell`` fills it.
    """

    data: torch.Tensor
    cols: torch.Tensor
    nnz_blocks: torch.Tensor
    n: int
    n_orig: int
    n_col: int = -1
    n_col_orig: int = -1
    impl: str = "kernel"
    nz_row_ptr: torch.Tensor = None
    nz_cols: torch.Tensor = None
    nz_vals: torch.Tensor = None

    @property
    def col_dim(self):
        return self.n if self.n_col == -1 else self.n_col

    @property
    def col_dim_orig(self):
        return self.n_orig if self.n_col_orig == -1 else self.n_col_orig

    def to(self, device=None, dtype=None) -> "BlockELL":
        """Move the arrays to ``device``; cast only the tile data and
        ``nz_vals`` to ``dtype`` (indices stay int32)."""
        return self._replace(data=self.data.to(device=device, dtype=dtype),
                             cols=self.cols.to(device),
                             nnz_blocks=self.nnz_blocks.to(device),
                             **row_spmm.move_nonzeros(self, device, dtype))


def to_block_ell(a: np.ndarray) -> BlockELL:
    """Pack a (possibly non-multiple-of-128, possibly rectangular) dense
    numpy matrix with a sparse pattern into BlockELL. Host-side; the arrays
    are CPU tensors (``BlockELL.to`` moves them)."""
    r_orig, c_orig = a.shape
    n = ((r_orig + BLOCK - 1) // BLOCK) * BLOCK
    nc = ((c_orig + BLOCK - 1) // BLOCK) * BLOCK
    ap = np.zeros((n, nc), a.dtype)
    ap[:r_orig, :c_orig] = a
    nblk, ncblk = n // BLOCK, nc // BLOCK
    tiles = ap.reshape(nblk, BLOCK, ncblk, BLOCK).transpose(0, 2, 1, 3)
    nz = np.abs(tiles).sum(axis=(2, 3)) > 0  # (nblk, ncblk) block mask
    max_blocks = max(1, int(nz.sum(1).max()))
    data = np.zeros((nblk, max_blocks, BLOCK, BLOCK), np.float32)
    cols = np.zeros((nblk, max_blocks), np.int32)
    nnz = np.zeros((nblk,), np.int32)
    for i in range(nblk):
        cs = np.nonzero(nz[i])[0]
        nnz[i] = len(cs)
        for r, c in enumerate(cs):
            data[i, r] = tiles[i, c]
            cols[i, r] = c
        # pad with a repeated valid index pointing at zero data
        cols[i, len(cs):] = cs[0] if len(cs) else 0
    real = np.arange(max_blocks)[None, :] < nnz[:, None]  # no padding tile
    nonzeros = row_spmm.nonzero_rows(np.nonzero(real)[0], cols[real],
                                     data[real], n, c_orig)
    return BlockELL(torch.from_numpy(data), torch.from_numpy(cols),
                    torch.from_numpy(nnz), n, r_orig, nc, c_orig, "kernel",
                    *nonzeros)


def transpose_block_ell(a: np.ndarray) -> BlockELL:
    return to_block_ell(np.ascontiguousarray(a.T))


def build_road_ell_pairs(supports, impl: str = "kernel") -> list:
    """The ``(BlockELL, BlockELL_t)`` pair of each support, the block-ELL
    road-graph constant of ``graph_backend="road_sparse"``. supports: list
    of (N, N) numpy arrays (e.g. ``dual_random_walk_supports``). Host-side;
    move with ``BlockELL.to``."""
    if impl not in ("kernel", "reference"):
        raise ValueError(f"unknown road SpMM impl {impl!r}")
    sups = [np.asarray(s, np.float32) for s in supports]
    return [(to_block_ell(s)._replace(impl=impl),
             transpose_block_ell(s)._replace(impl=impl)) for s in sups]


class ShardedRoadPacks(NamedTuple):
    """Row-partitioned road supports for the node axis of a mesh (the JAX
    ``ShardedRoadPacks``). ``fwd[s][d]``: rank d's rows of support s, a
    rectangular (n_loc x N) ``BlockELL``; ``bwd[s][d]``: its transpose
    (N x n_loc), which the backward reads. Each pack carries its nonzero
    list; the column ids stay global. Every rank builds the whole set and
    takes its own with ``local_packs``."""

    fwd: tuple
    bwd: tuple
    n_loc: int
    n_full: int


def _stack_ragged(packs) -> list:
    """Equalize ``max_blocks`` across the shards' packs (zero tiles, column
    0), as the JAX package stacks them; the nonzero lists are unchanged."""
    maxb = max(int(p.cols.shape[1]) for p in packs)
    out = []
    for p in packs:
        pad = maxb - p.cols.shape[1]
        if pad:
            p = p._replace(
                data=torch.nn.functional.pad(p.data, (0, 0, 0, 0, 0, pad)),
                cols=torch.nn.functional.pad(p.cols, (0, pad)))
        out.append(p)
    return out


def shard_road_packs(supports, n_shards: int,
                     impl: str = "kernel") -> ShardedRoadPacks:
    """Row-partition dense numpy supports for the node-partitioned path.
    supports: list of (N, N) numpy arrays; N must divide by ``n_shards``
    (the node-axis split of the activations). Host-side; move a rank's
    packs with ``BlockELL.to``."""
    n = supports[0].shape[0]
    if n % n_shards:
        raise ValueError(f"num_nodes {n} not divisible by {n_shards}")
    n_loc = n // n_shards
    fwd, bwd = [], []
    for s in supports:
        s = np.asarray(s, np.float32)
        rows = [s[d * n_loc:(d + 1) * n_loc, :] for d in range(n_shards)]
        fwd.append(tuple(p._replace(impl=impl) for p in _stack_ragged(
            [to_block_ell(r) for r in rows])))
        bwd.append(tuple(p._replace(impl=impl) for p in _stack_ragged(
            [transpose_block_ell(r) for r in rows])))
    return ShardedRoadPacks(tuple(fwd), tuple(bwd), n_loc, n)


def local_packs(sp: ShardedRoadPacks, index: int) -> list:
    """Rank ``index``'s ``(BlockELL, BlockELL_t)`` pair of each support."""
    return [(f[index], b[index]) for f, b in zip(sp.fwd, sp.bwd)]


def rcm_ordering(adj: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering (BFS by ascending degree).

    Road graphs have spatial locality but arbitrary node numbering; RCM
    reduces bandwidth so nonzeros cluster near the diagonal and the 128x128
    block pack touches far fewer tiles. Apply as
    ``adj[perm][:, perm]`` (and permute node features consistently).
    """
    n = adj.shape[0]
    pattern = (np.abs(adj) + np.abs(adj.T)) > 0
    degree = pattern.sum(1)
    visited = np.zeros(n, bool)
    order = []
    while len(order) < n:
        # start each component from its minimum-degree unvisited node
        start = int(np.argmin(np.where(visited, np.iinfo(np.int64).max,
                                       degree)))
        queue = [start]
        visited[start] = True
        while queue:
            u = queue.pop(0)
            order.append(u)
            nbrs = np.nonzero(pattern[u] & ~visited)[0]
            nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
            for v in nbrs:
                visited[v] = True
                queue.append(int(v))
    return np.asarray(order[::-1], np.int64)


def spmm_reference(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, plain PyTorch: gather the x tiles by ``cols``, one batched
    matmul over every stored tile (padding tiles are zero), sum over the
    tile axis, accumulating in at least f32."""
    n_in, f = x.shape
    if n_in != a.col_dim_orig:
        raise ValueError(f"x has {n_in} rows, pack expects {a.col_dim_orig}")
    acc = torch.promote_types(torch.float32, x.dtype)
    xp = x.new_zeros((a.col_dim, f))
    xp[:n_in] = x
    x_g = xp.view(a.col_dim // BLOCK, BLOCK, f)[a.cols.long()]  # (R,M,B,f)
    y = torch.matmul(a.data.to(acc), x_g.to(acc)).sum(1)  # (R, B, f)
    return y.reshape(a.n, f)[:a.n_orig].to(x.dtype)


def spmm(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a static-pattern sparse A in block-ELL form.

    x: (a.col_dim_orig, f) -> (a.n_orig, f), in x.dtype. A CPU tensor takes
    ``spmm_reference``; a CUDA tensor launches the hand-written kernel (f32
    or bf16, f32 accumulation) or raises. ``spmm.launches`` counts kernel
    launches.
    """
    if x.dim() != 2 or x.shape[0] != a.col_dim_orig:
        raise ValueError(f"x must be ({a.col_dim_orig}, f), got "
                         f"{tuple(x.shape)}")
    if x.dtype != a.data.dtype:
        raise TypeError(f"x is {x.dtype} but the pack data is "
                        f"{a.data.dtype}")
    devices = {t.device for t in (x, a.data, a.cols, a.nnz_blocks)}
    if len(devices) != 1:
        raise ValueError(f"x and the pack lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return spmm_reference(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm runs on CPU or CUDA tensors, got {x.device}")
    y = row_spmm.launch("spmm_ell", a, x)
    spmm.launches += 1
    return y


spmm.launches = 0


class SpmmELLFunction(torch.autograd.Function):
    """y = A @ x through ``spmm``, differentiable in x:
    ``SpmmELLFunction.apply(x, a, a_t)``. The backward is ``dx = A^T g``
    through ``spmm`` on ``a_t`` (the kernel on the card, one launch), and the
    packs get no gradient (counterpart of the JAX custom VJP ``_spmm_cv``)."""

    @staticmethod
    def forward(ctx, x, a: BlockELL, a_t: BlockELL):
        ctx.a_t = a_t
        return spmm(a, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return spmm(ctx.a_t, g.contiguous()), None, None


def spmm_batched(a: BlockELL, a_t: BlockELL, x: torch.Tensor) -> torch.Tensor:
    """Batched aggregation ``einsum('nm,bmc->bnc')`` through the SpMM:
    (B, m, C) -> fold (B, C) into the feature axis -> one SpMM ->
    (B, a.n_orig, C). ``a.impl == "kernel"`` goes through
    ``SpmmELLFunction``; ``"reference"`` through ``spmm_reference``, which
    autograd differentiates by itself."""
    b, n, c = x.shape
    flat = x.permute(1, 0, 2).reshape(n, b * c)
    if a.impl == "kernel":
        y = SpmmELLFunction.apply(flat, a, a_t)
    else:
        y = spmm_reference(a, flat)
    return y.view(a.n_orig, b, c).permute(1, 0, 2)

