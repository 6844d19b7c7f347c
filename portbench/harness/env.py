"""The run around a cell: the card check, the settings the configuration
states, the kind's driver, and the result line."""
from __future__ import annotations

import importlib
import sys

import torch

from portbench.harness import cell as cells
from portbench.harness.common import Outcome, RunArgs

HOST_THREADS = 2


def require_cards(count: int) -> torch.device:
    """The first card, or exit (no result) where fewer than ``count``
    CUDA cards are visible."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {count} CUDA card(s); {found} visible",
              file=sys.stderr)
        sys.exit(2)
    return torch.device("cuda", 0)


def configure(config: dict) -> None:
    """float32 as the configuration states it, with TF32 off, and few host
    threads (one process's load, steadier)."""
    if config["model"]["compute_dtype"] != "float32":
        raise ValueError("the harness runs float32 configurations")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(HOST_THREADS)


def run_kind(args: RunArgs) -> Outcome:
    kind = args.cell.traffic["kind"]
    return importlib.import_module(
        f"portbench.harness.kinds.{kind}").run(args)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, **extra):
    """(outcome, result line as a dict)."""
    configure(cell.config)
    outcome = run_kind(RunArgs(cell, seed, seconds, trace, device, t_start,
                               **extra))
    return outcome, result_line(cell, outcome, trace, device)


def result_line(cell: cells.Cell, outcome: Outcome, trace: bool,
                device: torch.device) -> dict:
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            base = m["name"].split(".")[0]
            metrics[m["name"]] = {"value": outcome.quantities[base],
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = cells.reader(m["name"])(cell, outcome)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    compared = outcome.compared(cell.limits)
    correct = (outcome.failed == 0 and outcome.attempted > 0
               and all(v <= lim for v, lim in compared.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace:
        t = outcome.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                             "idle_gaps": [list(x) for x in t.idle_gaps]}
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in compared.items()}
    return line
