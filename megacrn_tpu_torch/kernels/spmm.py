"""Block-ELL SpMM for static road supports (counterpart of
``megacrn_tpu/kernels/spmm.py``).

A sparse matrix is stored per row-block as ``max_blocks`` 128x128 tiles and
their column-block indices, with ``nnz_blocks`` real tiles per row-block;
padding entries repeat a valid column index with a zero tile, exactly as
the JAX package packs it. ``graph_backend="road_sparse"`` with a list of
``(BlockELL, BlockELL_t)`` pairs, one per support, aggregates through it
(``ops.graph.cheb_aggregate_sparse``).

Two implementations of ``y = A @ x``:

* ``spmm_reference``: the plain PyTorch version (gather the x tiles by
  ``cols``, one batched matmul, sum over the tile axis, accumulating in at
  least f32). The CPU tests use it and ``chip_smoke.py`` holds the kernel
  against it on the card.
* ``spmm``: the wrapper of the hand-written Hopper kernel
  ``kernels/csrc/spmm_ell.cu``, which stops at ``nnz_blocks`` instead of
  running through the padding. A CPU tensor takes the plain version; a CUDA
  tensor launches the kernel or raises.

``SpmmELLFunction`` makes ``spmm`` differentiable in x (backward: the same
kernel on the transposed pack); ``spmm_batched`` folds a batch into the
feature axis. The node-partitioned helpers (``shard_road_packs``,
``local_packs``, ``rcm_ordering``) come with the mesh slice.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 128  # tile edge, as in megacrn_tpu/kernels/spmm.py


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
    """

    data: torch.Tensor
    cols: torch.Tensor
    nnz_blocks: torch.Tensor
    n: int
    n_orig: int
    n_col: int = -1
    n_col_orig: int = -1
    impl: str = "kernel"

    @property
    def col_dim(self):
        return self.n if self.n_col == -1 else self.n_col

    @property
    def col_dim_orig(self):
        return self.n_orig if self.n_col_orig == -1 else self.n_col_orig

    def to(self, device=None, dtype=None) -> "BlockELL":
        """Move the arrays to ``device``; cast only the tile data to
        ``dtype`` (indices stay int32)."""
        return self._replace(data=self.data.to(device=device, dtype=dtype),
                             cols=self.cols.to(device),
                             nnz_blocks=self.nnz_blocks.to(device))


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
    return BlockELL(torch.from_numpy(data), torch.from_numpy(cols),
                    torch.from_numpy(nnz), n, r_orig, nc, c_orig)


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


_KERNEL_DTYPES = {torch.float32: "spmm_ell_f32",
                  torch.bfloat16: "spmm_ell_bf16"}


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
    return _launch(a, x)


spmm.launches = 0


def _launch(a: BlockELL, x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the spmm_ell kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not (x.is_contiguous() and a.data.is_contiguous()):
        raise ValueError("spmm_ell kernel needs contiguous x and tile data")
    nblk, max_blocks = a.cols.shape if a.cols.dim() == 2 else (-1, -1)
    if (nblk * BLOCK != a.n
            or a.data.shape != (nblk, max_blocks, BLOCK, BLOCK)
            or a.cols.dtype != torch.int32
            or a.nnz_blocks.dtype != torch.int32
            or a.nnz_blocks.shape != (nblk,)
            or not (a.cols.is_contiguous()
                    and a.nnz_blocks.is_contiguous())):
        raise ValueError("malformed BlockELL pack for the spmm_ell kernel")
    from megacrn_tpu_torch.kernels import _build

    lib = _build.load("spmm_ell", _declare)
    f = x.shape[1]
    y = torch.empty((a.n_orig, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
            a.cols.data_ptr(), a.nnz_blocks.data_ptr(), a.data.data_ptr(),
            x.data_ptr(), y.data_ptr(), nblk, max_blocks, a.n_orig,
            a.col_dim_orig, f, stream)
    if rc != 0:
        raise RuntimeError(f"spmm_ell kernel launch failed: CUDA error {rc} "
                           f"({lib.spmm_ell_error_string(rc).decode()})")
    spmm.launches += 1
    return y


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


def _declare(lib: ctypes.CDLL) -> None:
    """ctypes signatures of ``csrc/spmm_ell.cu``'s C interface."""
    for name in _KERNEL_DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.spmm_ell_error_string.argtypes = [ctypes.c_int]
    lib.spmm_ell_error_string.restype = ctypes.c_char_p
