"""Block-COO SpMM for static road supports (counterpart of
``megacrn_tpu/kernels/spmm_coo.py``).

A sparse matrix is a row-sorted flat list of its nonzero 128x128 tiles
(``rows``, ``cols``, ``data``), with one zero tile for each empty row-block,
exactly as the JAX package packs it. The port adds ``row_ptr``, a CSR over
the sorted tiles, so that each row-block of the product is computed by its
own CUDA blocks with no cross-block order (the TPU kernel instead relied on
its grid running in order and flushed when the row index changed).

``stack_supports_block_coo`` packs ``diag(A_1 .. A_S)``: the model's
Chebyshev recursion over S supports becomes one product per level on
stacked features (``ops.graph.cheb_aggregate_sparse_stacked``).

Two implementations of ``y = A @ x``:

* ``spmm_coo_reference``: the plain PyTorch version (gather the x tiles,
  one batched matmul, ``index_add_`` into row blocks). The CPU tests use it
  and ``chip_smoke.py`` holds the kernel against it on the card.
* ``spmm_coo``: the wrapper of the hand-written Hopper kernel
  ``kernels/csrc/spmm_coo.cu``. A CPU tensor takes the plain version; a
  CUDA tensor launches the kernel or raises.

``SpmmCOOFunction`` makes ``spmm_coo`` differentiable in x: its backward
is ``dx = A^T g`` through the same wrapper (and so the same kernel) on the
transposed pack, and gives the pack no gradient (it is a graph constant).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

BLOCK = 128  # tile edge, as in megacrn_tpu/kernels/spmm.py


class BlockCOO(NamedTuple):
    """Sorted flattened block-COO sparse matrix (possibly rectangular).

    rows / cols: (T,) int32 row/column BLOCK indices per tile, sorted by row
      (ties by col). Every row-block appears at least once (empty rows carry
      one all-zero tile, as in the JAX package).
    data: (T, BLOCK, BLOCK) tile values.
    row_ptr: (n // BLOCK + 1,) int32, tiles of row-block r are
      ``[row_ptr[r], row_ptr[r+1])``.
    n / n_orig: padded and original ROW dims; n_col / n_col_orig: column dims
      (-1 = square).
    """

    rows: torch.Tensor
    cols: torch.Tensor
    data: torch.Tensor
    row_ptr: torch.Tensor
    n: int
    n_orig: int
    n_col: int = -1
    n_col_orig: int = -1

    @property
    def col_dim(self):
        return self.n if self.n_col == -1 else self.n_col

    @property
    def col_dim_orig(self):
        return self.n_orig if self.n_col_orig == -1 else self.n_col_orig

    def to(self, device=None, dtype=None) -> "BlockCOO":
        """Move the arrays to ``device``; cast only the tile data to
        ``dtype`` (indices stay int32)."""
        return self._replace(rows=self.rows.to(device),
                             cols=self.cols.to(device),
                             data=self.data.to(device=device, dtype=dtype),
                             row_ptr=self.row_ptr.to(device))


def to_block_coo(a: np.ndarray) -> BlockCOO:
    """Pack a dense numpy matrix with a sparse pattern into sorted BlockCOO
    (row-major tile order, one zero tile inserted per empty row-block).
    Host-side; the arrays are CPU tensors (``BlockCOO.to`` moves them)."""
    r_orig, c_orig = a.shape
    n = ((r_orig + BLOCK - 1) // BLOCK) * BLOCK
    nc = ((c_orig + BLOCK - 1) // BLOCK) * BLOCK
    ap = np.zeros((n, nc), np.float32)
    ap[:r_orig, :c_orig] = a
    nblk, ncblk = n // BLOCK, nc // BLOCK
    tiles = ap.reshape(nblk, BLOCK, ncblk, BLOCK).transpose(0, 2, 1, 3)
    nz = np.abs(tiles).sum(axis=(2, 3)) > 0  # (nblk, ncblk)
    rows, cols, data = [], [], []
    for i in range(nblk):
        cs = np.nonzero(nz[i])[0]
        if len(cs) == 0:
            cs = [0]  # zero tile, as in the JAX pack
        for c in cs:
            rows.append(i)
            cols.append(int(c))
            data.append(tiles[i, c])
    rows = np.asarray(rows, np.int32)
    row_ptr = np.zeros(nblk + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=nblk))
    return BlockCOO(torch.from_numpy(rows),
                    torch.from_numpy(np.asarray(cols, np.int32)),
                    torch.from_numpy(np.stack(data)),
                    torch.from_numpy(row_ptr), n, r_orig, nc, c_orig)


def transpose_block_coo(a: np.ndarray) -> BlockCOO:
    return to_block_coo(np.ascontiguousarray(a.T))


def stack_supports_block_coo(supports) -> tuple:
    """(fwd, bwd) BlockCOO packs of ``diag(A_1 .. A_S)`` for the stacked
    Chebyshev recursion. supports: list of (N, N) numpy arrays. Each A_s is
    padded to a BLOCK multiple independently so stacked feature rows align
    with per-support slices of the padded stack."""
    sups = [np.asarray(s, np.float32) for s in supports]
    n_orig = sups[0].shape[0]
    n = ((n_orig + BLOCK - 1) // BLOCK) * BLOCK
    big = np.zeros((n * len(sups), n * len(sups)), np.float32)
    for i, s in enumerate(sups):
        big[i * n:i * n + n_orig, i * n:i * n + n_orig] = s
    return to_block_coo(big), transpose_block_coo(big)


class StackedRoadPack(NamedTuple):
    """The road-graph constant of ``graph_backend="road_sparse"``:
    block-diagonal ``diag(A_1..A_S)`` COO packs (+ transpose, for the
    backward of the training slice) and the static dims the stacked
    Chebyshev recursion needs.

    ``impl``: ``"kernel"`` runs ``spmm_coo`` (the CUDA kernel on the card,
    the plain version on the CPU); ``"reference"`` runs
    ``spmm_coo_reference`` on any device, for holding the kernel against it.
    """

    pack: BlockCOO
    pack_t: BlockCOO
    num_supports: int
    n_pad: int  # per-support padded node count (slice stride in the stack)
    impl: str = "kernel"

    def to(self, device=None, dtype=None,
           transpose: bool = False) -> "StackedRoadPack":
        """Move and cast the forward ``pack``, and ``pack_t`` too when
        ``transpose`` is set. ``pack_t`` is read only by the backward, so
        serving leaves it where it is (on the host); training moves it."""
        out = self._replace(pack=self.pack.to(device, dtype))
        if transpose:
            out = out._replace(pack_t=self.pack_t.to(device, dtype))
        return out


def build_stacked_road_pack(supports, impl: str = "kernel") -> StackedRoadPack:
    """supports: list of (N, N) numpy arrays (e.g. dual_random_walk_supports
    of the road adjacency). Host-side; move with ``StackedRoadPack.to``."""
    if impl not in ("kernel", "reference"):
        raise ValueError(f"unknown road SpMM impl {impl!r}")
    n_orig = supports[0].shape[0]
    n_pad = ((n_orig + BLOCK - 1) // BLOCK) * BLOCK
    fwd, bwd = stack_supports_block_coo(supports)
    return StackedRoadPack(fwd, bwd, len(supports), n_pad, impl)


def spmm_coo_reference(a: BlockCOO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, plain PyTorch (mirror of the JAX ``spmm_coo_xla``): gather
    the referenced x tiles, one batched matmul over all tiles, ``index_add_``
    into row blocks, accumulating in at least f32."""
    n_in, f = x.shape
    if n_in != a.col_dim_orig:
        raise ValueError(f"x has {n_in} rows, pack expects {a.col_dim_orig}")
    acc = torch.promote_types(torch.float32, x.dtype)
    xp = x.new_zeros((a.col_dim, f))
    xp[:n_in] = x
    x_g = xp.view(a.col_dim // BLOCK, BLOCK, f)[a.cols.long()]  # (T, B, f)
    y_t = torch.bmm(a.data.to(acc), x_g.to(acc))
    y = torch.zeros((a.n // BLOCK, BLOCK, f), dtype=acc, device=x.device)
    y.index_add_(0, a.rows.long(), y_t)
    return y.view(a.n, f)[:a.n_orig].to(x.dtype)


_KERNEL_DTYPES = {torch.float32: "spmm_coo_f32",
                  torch.bfloat16: "spmm_coo_bf16"}


def spmm_coo(a: BlockCOO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a static-pattern sparse A in sorted block-COO form.

    x: (a.col_dim_orig, f) -> (a.n_orig, f), in x.dtype. A CPU tensor takes
    ``spmm_coo_reference``; a CUDA tensor launches the hand-written kernel
    (f32 or bf16, f32 accumulation) or raises. ``spmm_coo.launches`` counts
    kernel launches.
    """
    if x.dim() != 2 or x.shape[0] != a.col_dim_orig:
        raise ValueError(f"x must be ({a.col_dim_orig}, f), got "
                         f"{tuple(x.shape)}")
    if x.dtype != a.data.dtype:
        raise TypeError(f"x is {x.dtype} but the pack data is "
                        f"{a.data.dtype}")
    devices = {t.device for t in (x, a.data, a.cols, a.row_ptr)}
    if len(devices) != 1:
        raise ValueError(f"x and the pack lie on different devices: "
                         f"{sorted(map(str, devices))}")
    if x.device.type == "cpu":
        return spmm_coo_reference(a, x)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_coo runs on CPU or CUDA tensors, got "
                         f"{x.device}")
    return _launch(a, x)


spmm_coo.launches = 0


def _launch(a: BlockCOO, x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the spmm_coo kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if not (x.is_contiguous() and a.data.is_contiguous()):
        raise ValueError("spmm_coo kernel needs contiguous x and tile data")
    nblk = a.n // BLOCK
    if (a.data.shape[1:] != (BLOCK, BLOCK)
            or a.cols.shape != (a.data.shape[0],)
            or a.cols.dtype != torch.int32
            or a.row_ptr.dtype != torch.int32
            or a.row_ptr.shape != (nblk + 1,)
            or not (a.cols.is_contiguous() and a.row_ptr.is_contiguous())):
        raise ValueError("malformed BlockCOO pack for the spmm_coo kernel")
    from megacrn_tpu_torch.kernels import _build

    lib = _build.load("spmm_coo", _declare)
    f = x.shape[1]
    y = torch.empty((a.n_orig, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, _KERNEL_DTYPES[x.dtype])(
            a.row_ptr.data_ptr(), a.cols.data_ptr(), a.data.data_ptr(),
            x.data_ptr(), y.data_ptr(), nblk, a.n_orig, a.col_dim_orig, f,
            stream)
    if rc != 0:
        raise RuntimeError(f"spmm_coo kernel launch failed: CUDA error {rc} "
                           f"({lib.spmm_coo_error_string(rc).decode()})")
    spmm_coo.launches += 1
    return y


class SpmmCOOFunction(torch.autograd.Function):
    """y = A @ x through ``spmm_coo``, differentiable in x:
    ``SpmmCOOFunction.apply(x, a, a_t)``. The backward is ``dx = A^T g``
    through ``spmm_coo`` on ``a_t`` (the kernel on the card, one launch), and
    the packs get no gradient (counterpart of the JAX custom VJP
    ``_spmm_coo_cv``)."""

    @staticmethod
    def forward(ctx, x, a: BlockCOO, a_t: BlockCOO):
        ctx.a_t = a_t
        return spmm_coo(a, x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return spmm_coo(ctx.a_t, g.contiguous()), None, None


def _declare(lib: ctypes.CDLL) -> None:
    """ctypes signatures of ``csrc/spmm_coo.cu``'s C interface."""
    for name in _KERNEL_DTYPES.values():
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.spmm_coo_error_string.argtypes = [ctypes.c_int]
    lib.spmm_coo_error_string.restype = ctypes.c_char_p
