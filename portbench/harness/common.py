"""What every kind of traffic shares: the run's arguments, its outcome,
and the steps that free the program before the reference runs."""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from portbench.harness.cell import Cell
from portbench.harness.trace import Trace


@dataclass
class RunArgs:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # perf_counter at process start
    # Not set by the benchmark's own runs: a fault planted in the program
    # (tests and calibration), and the control (the reference in the next
    # lower precision, read beside the program).
    fault: Optional[str] = None
    control: bool = False


@dataclass
class Outcome:
    quantities: Dict[str, float]  # end-to-end quantities by base name
    attempted: int
    failed: int
    readings: Dict[str, float]  # the numbers the check compares
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    layer: Dict[str, object] = field(default_factory=dict)
    control_readings: Optional[Dict[str, float]] = None

    def compared(self, limits: dict) -> Dict[str, Tuple[float, float]]:
        return {k: (v, limits[k]) for k, v in self.readings.items()}


def synchronizer(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def memory_peak(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device: torch.device) -> None:
    """Return the program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def window(seconds: float, one, end=lambda: None):
    """Call ``one()`` until ``seconds`` have passed since the first call,
    then ``end()`` (a synchronisation where the work is queued); returns
    (calls, seconds from the first call to the end)."""
    t0 = time.perf_counter()
    n = 0
    while True:
        one()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            end()
            return n, time.perf_counter() - t0
