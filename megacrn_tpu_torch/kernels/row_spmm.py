"""The nonzero list both SpMM kernels read, and their shared launch.

Each pack (``spmm_coo.BlockCOO``, ``spmm.BlockELL``) keeps its 128x128
tiles, which the plain versions and the parity tests read, and carries
beside them its nonzeros as a CSR over its padded rows: ``nz_row_ptr``
``(n + 1,)`` int32, ``nz_cols`` ``(nnz,)`` int32 global columns, always
below ``col_dim_orig``, and ``nz_vals`` ``(nnz,)`` in the tile dtype. The
pack builders fill them once on the host with ``nonzero_rows``; the CUDA
kernels (``csrc/spmm_coo.cu``, ``csrc/spmm_ell.cu``, both on
``csrc/row_spmm.cuh``) read only these three arrays, x and y.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

BLOCK = 128  # tile edge, as in megacrn_tpu/kernels/spmm.py

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def nonzero_rows(tile_rows: np.ndarray, tile_cols: np.ndarray,
                 tiles: np.ndarray, n: int, n_col_orig: int) -> tuple:
    """``(nz_row_ptr, nz_cols, nz_vals)`` CPU tensors of the matrix that the
    tiles hold. tile_rows / tile_cols: (T,) row- and column-block index of
    each tile; tiles: (T, BLOCK, BLOCK), sorted by row block. Only entries
    ``!= 0`` are kept; within a row they follow the tiles' order, then the
    column. n: the pack's padded row count."""
    t, r, c = np.nonzero(tiles)  # ordered by tile, row, column
    rows = tile_rows[t].astype(np.int64) * BLOCK + r
    order = np.argsort(rows, kind="stable")
    cols = (tile_cols[t].astype(np.int64) * BLOCK + c)[order]
    if cols.size and cols.max() >= n_col_orig:
        raise ValueError("a nonzero lies in the pack's padded columns")
    row_ptr = np.zeros(n + 1, np.int32)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return (torch.from_numpy(row_ptr),
            torch.from_numpy(cols.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(tiles[t, r, c][order])))


def move_nonzeros(pack, device=None, dtype=None) -> dict:
    """The pack's nonzero list moved to ``device``, only ``nz_vals`` cast to
    ``dtype``, as ``_replace`` keywords (a field left unset stays None)."""
    def move(t, dt=None):
        return None if t is None else t.to(device=device, dtype=dt)

    return {"nz_row_ptr": move(pack.nz_row_ptr),
            "nz_cols": move(pack.nz_cols),
            "nz_vals": move(pack.nz_vals, dtype)}


def launch(name: str, a, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, (a.n_orig, f) in x.dtype, through ``csrc/<name>.cu`` on
    x's card and current stream. Checks the nonzero list and x first and
    raises on anything the kernel does not take; builds the kernel at first
    use (raises if it cannot)."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"the {name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    arrays = (a.nz_row_ptr, a.nz_cols, a.nz_vals)
    if any(t is None for t in arrays):
        raise ValueError(f"the {name} kernel needs the pack's nonzero list "
                         f"(build the pack with its to_block_* builder)")
    if (a.nz_row_ptr.dtype != torch.int32 or a.nz_cols.dtype != torch.int32
            or a.nz_vals.dtype != x.dtype):
        raise TypeError(f"{name}: nz_row_ptr and nz_cols must be int32 and "
                        f"nz_vals {x.dtype}; got {a.nz_row_ptr.dtype}, "
                        f"{a.nz_cols.dtype}, {a.nz_vals.dtype}")
    if (a.nz_row_ptr.shape != (a.n + 1,) or a.nz_cols.dim() != 1
            or a.nz_vals.shape != a.nz_cols.shape):
        raise ValueError(f"malformed nonzero list for the {name} kernel")
    if x.dim() != 2 or x.shape[0] != a.col_dim_orig:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, the pack "
                         f"expects ({a.col_dim_orig}, f)")
    if not all(t.is_contiguous() for t in (x, *arrays)):
        raise ValueError(f"the {name} kernel needs contiguous x and nonzero "
                         f"list")
    if any(t.device != x.device for t in arrays):
        raise ValueError(f"{name}: x and the nonzero list lie on different "
                         f"devices")
    from megacrn_tpu_torch.kernels import _build

    lib = _build.load(name, _declare(name))
    f = x.shape[1]
    y = torch.empty((a.n_orig, f), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        # The raw handle, far cheaper than a Stream object: the wrapper's
        # host time is as long as the kernel's time on the card.
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        rc = getattr(lib, f"{name}_{_SUFFIX[x.dtype]}")(
            a.nz_row_ptr.data_ptr(), a.nz_cols.data_ptr(),
            a.nz_vals.data_ptr(), x.data_ptr(), y.data_ptr(), a.n_orig, f,
            stream)
    if rc != 0:
        error = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({error})")
    return y


def _declare(name: str):
    """The ctypes signatures of ``csrc/<name>.cu``'s C interface."""
    def declare(lib: ctypes.CDLL) -> None:
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p

    return declare
