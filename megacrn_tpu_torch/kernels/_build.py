"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` at the root of the
checkout, at first use; the hash covers the source, the shared headers
``csrc/*.cuh`` it may include, and the flags, so an edited kernel or header
is rebuilt and an unchanged one is reused. ``build_many`` starts one
``nvcc`` per source, all at once. The library is loaded with ``ctypes``. A
failed build raises with the compiler's output.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def build_many(names: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """Compile each ``csrc/<name>.cu`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: (seconds, compiler
    output)}`` (ptxas reports registers and shared memory per kernel); a
    library that was already there gives ``(0.0, "")``.
    Raises with the compiler's output if any build fails."""
    procs = {}
    out: Dict[str, Tuple[float, str]] = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        procs[name] = (lib, tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return out


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed;
    ``declare`` sets its functions' ctypes signatures."""
    lib = _loaded.get(name)
    if lib is None:
        build_many([name])
        lib = ctypes.CDLL(str(library_path(name)))
        declare(lib)
        _loaded[name] = lib
    return lib
