"""Observability: step timing, throughput accounting, profiler hooks
(counterpart of ``megacrn_tpu/train/telemetry.py``).

A step timer with EMA and edges/s derivation, a ``torch.profiler`` trace
around a block of steps (written as a Chrome trace), and the peak device
memory of the card, which stands in for the JAX package's compiled-program
memory statistics (PyTorch compiles no program to ask).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def edge_traversals_per_step(num_nodes: int, cheb_k: int, seq_len: int,
                             horizon: int, batch: int,
                             num_supports: int = 2,
                             nnz: Optional[int] = None) -> int:
    """Forward-pass A@x edge traversals per train step (documented formula,
    see bench.py): nnz * (cheb_k-1) applications per support * 2 Chebyshev
    stacks per cell ([x||h] and z*h) * cells * batch."""
    nnz = nnz if nnz is not None else num_supports * num_nodes * num_nodes
    apps = cheb_k - 1
    stacks_per_cell = 2
    return nnz * apps * stacks_per_cell * (seq_len + horizon) * batch


class StepTimer:
    """Wall-clock per-step telemetry with EMA; call ``tick()`` after each
    synchronized step."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.avg: Optional[float] = None
        self.count = 0
        self._last = time.time()

    def tick(self) -> float:
        now = time.time()
        dt = now - self._last
        self._last = now
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        self.count += 1
        return dt

    def stats(self, edges_per_step: Optional[int] = None) -> Dict:
        out = {"steps": self.count, "sec_per_step_ema": self.avg}
        if edges_per_step and self.avg:
            out["edges_per_sec"] = edges_per_step / self.avg
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, when the card is
    in use, its kernels around a block of steps; written to
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def peak_device_memory(device: torch.device) -> Optional[Dict]:
    """The card's peak allocated and reserved bytes since the last
    ``torch.cuda.reset_peak_memory_stats``; None off the card."""
    if device.type != "cuda":
        return None
    return {"max_memory_allocated_bytes":
            torch.cuda.max_memory_allocated(device),
            "max_memory_reserved_bytes":
            torch.cuda.max_memory_reserved(device)}
