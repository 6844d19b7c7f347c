"""ctypes binding of the repository's host-pipeline library,
``native/megacrn_data.cc`` (counterpart of ``megacrn_tpu/data/native.py``).

At first use the library is compiled with g++ into
``build/megacrn_data-<hash>.so`` at the root of the checkout (the hash
covers the source and the flags, so an edited source is rebuilt); the
source is read, never written, and the JAX package's own build is not
touched. Every entry has a numpy path, taken when no compiler or no
source is found; ``available()`` says which one runs. The numpy paths give
the library's results bit for bit: ``scale_channel_inplace`` computes
``(x - f32 mean) * f32(1 / std)`` as the library does (the JAX package's
numpy fallback divides instead, one rounding apart).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "megacrn_data.cc"
BUILD_DIR = _ROOT / "build"
# No -march=native: the library is memcpy-bound, and a build that a copied
# checkout carries to another machine must still run there.
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"megacrn_data-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    """Compile the library to ``lib`` (a per-process temporary file, then
    renamed, so concurrent builders never load a half-written one)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
        return True
    except (subprocess.SubprocessError, OSError):
        if tmp.exists():
            tmp.unlink()
        return False


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    if not SOURCE.exists():
        return None
    lib_path = library_path()
    if not lib_path.exists() and not _build(lib_path):
        return None
    try:
        lib = ctypes.CDLL(str(lib_path))
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.mcrn_window_gather.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, i64p, ctypes.c_int64, f32p]
    lib.mcrn_window_gather.restype = None
    lib.mcrn_index_gather.argtypes = [
        f32p, ctypes.c_int64, i64p, ctypes.c_int64, f32p]
    lib.mcrn_index_gather.restype = None
    lib.mcrn_scale_channel.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float]
    lib.mcrn_scale_channel.restype = None
    lib.mcrn_prepare_xy.argtypes = [f32p, f32p] + [ctypes.c_int64] * 6 + [
        f32p, f32p, f32p]
    lib.mcrn_prepare_xy.restype = None
    lib.mcrn_version.argtypes = []
    lib.mcrn_version.restype = ctypes.c_int64
    return lib


def available() -> bool:
    """Whether the library runs (else every entry takes its numpy path)."""
    return _load() is not None


def _check_rows(indices: np.ndarray, rows: int, what: str) -> None:
    if indices.size and (indices.min() < 0 or indices.max() >= rows):
        raise IndexError(f"{what} out of range [0, {rows})")


def window_gather(data: np.ndarray, anchors: np.ndarray,
                  offsets: np.ndarray) -> np.ndarray:
    """data (T, N, C) -> (S, W, N, C) windows,
    ``data[anchors[:, None] + offsets[None, :]]``."""
    data = np.ascontiguousarray(data, np.float32)
    anchors = np.ascontiguousarray(anchors, np.int64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lib = _load()
    t, n, c = data.shape
    if lib is None:
        return data[anchors[:, None] + offsets[None, :]]
    _check_rows((anchors[:, None] + offsets[None, :]).reshape(-1), t,
                "window rows")
    out = np.empty((len(anchors), len(offsets), n, c), np.float32)
    lib.mcrn_window_gather(data.reshape(t, -1), n * c, anchors, len(anchors),
                           offsets, len(offsets),
                           out.reshape(len(anchors), len(offsets), -1))
    return out


def index_gather(src: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """src (S, ...) -> (len(indices), ...), ``src[indices]``."""
    src = np.ascontiguousarray(src, np.float32)
    indices = np.ascontiguousarray(indices, np.int64)
    lib = _load()
    if lib is None:
        return src[indices]
    _check_rows(indices, len(src), "indices")
    row = int(np.prod(src.shape[1:]))
    out = np.empty((len(indices),) + src.shape[1:], np.float32)
    lib.mcrn_index_gather(src.reshape(len(src), -1), row, indices,
                          len(indices), out.reshape(len(indices), -1))
    return out


def scale_channel_inplace(data: np.ndarray, channel: int, mean: float,
                          std: float) -> None:
    """In place, ``(x - f32 mean) * f32(1 / std)`` on ``data[..., channel]``
    of a C-contiguous float32 array."""
    if data.dtype != np.float32 or not data.flags.c_contiguous:
        raise ValueError("scale_channel_inplace needs a C-contiguous float32 "
                         f"array, got {data.dtype}")
    c = data.shape[-1]
    if not 0 <= channel < c:
        raise IndexError(f"channel {channel} out of range [0, {c})")
    lib = _load()
    if lib is None:
        data[..., channel] = ((data[..., channel] - np.float32(mean))
                              * np.float32(1.0 / std))
        return
    lib.mcrn_scale_channel(data.reshape(-1), data.size // c, c, channel,
                           ctypes.c_float(mean), ctypes.c_float(1.0 / std))


def prepare_xy(x: np.ndarray, y: np.ndarray, input_dim: int, output_dim: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The channel split of ``data.loader.prepare_x_y`` in one pass:
    (x[..., :input_dim], y[..., :output_dim], y[..., output_dim:])."""
    x = np.ascontiguousarray(x, np.float32)
    y = np.ascontiguousarray(y, np.float32)
    lib = _load()
    if lib is None:
        return (np.ascontiguousarray(x[..., :input_dim]),
                np.ascontiguousarray(y[..., :output_dim]),
                np.ascontiguousarray(y[..., output_dim:]))
    if x.shape != y.shape:
        raise ValueError(f"x {x.shape} and y {y.shape} differ")
    b, t, n, c = x.shape
    if not (0 < input_dim <= c and 0 < output_dim <= c):
        raise ValueError(f"input_dim {input_dim} / output_dim {output_dim} "
                         f"out of range for {c} channels")
    x0 = np.empty((b, t, n, input_dim), np.float32)
    y0 = np.empty((b, t, n, output_dim), np.float32)
    ycov = np.empty((b, t, n, c - output_dim), np.float32)
    lib.mcrn_prepare_xy(x, y, b, t, n, c, input_dim, output_dim, x0, y0, ycov)
    return x0, y0, ycov
