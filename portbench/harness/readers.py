"""The arithmetic of the per-layer metrics; each ``metrics/<name>.py``
names the one it reads. A reader returns None where its run has nothing
to read, and the metric is then left out of the result line."""
from __future__ import annotations

import statistics
import sys
from typing import Optional

from portbench.counts import megacrn, spmm
from portbench.counts.peaks import PEAK_FLOPS
from portbench.harness import data

SPMM_KERNEL = "row_spmm_kernel"  # the block-COO kernel's device name


def device_idle_pct(cell, out) -> Optional[float]:
    """Share of the traced span's wall time in which the card runs no
    kernel, copy or memset (%): its busy time and its wall time, both of
    the one span that the device-only profile records."""
    t = out.trace
    if t is None:
        return None
    idle = 1.0 - t.busy_s / t.window_s
    if not 0.0 <= idle < 1.0:
        raise RuntimeError(f"device busy {t.busy_s!r} s in a span of "
                           f"{t.window_s!r} s: not an idle share")
    return 100.0 * idle


def _nnz(cell) -> Optional[int]:
    supports = data.graph_supports(cell.config)
    return None if supports is None else int((supports != 0).sum())


def train_mfu_pct(cell, out) -> Optional[float]:
    """One train step's operations (``counts.megacrn``) over the window's
    time per step and the card's float32 peak (%)."""
    step_ms = out.quantities.get("train_step_ms")
    if step_ms is None:
        return None
    m = cell.config["model"]
    flops = megacrn.train_step_flops(m, cell.config["train"]["batch_size"],
                                     _nnz(cell))
    return 100.0 * flops / (step_ms * 1e-3) / PEAK_FLOPS["float32"]


def spmm_coo_roofline_pct(cell, out) -> Optional[float]:
    """The block-COO launches' least time (``counts.spmm``, at each launch's
    pack and width) over their summed device time in the traced span (%).
    Silent where the profile's launches, the program's counter and the
    count of a step's launches disagree."""
    t = out.trace
    steps = out.layer.get("span_units")
    supports = data.graph_supports(cell.config)
    if t is None or not steps or supports is None:
        return None
    launches, seconds = t.kernel_time(SPMM_KERNEL)
    m, batch = cell.config["model"], cell.config["train"]["batch_size"]
    expected = steps * len(spmm.train_step_launches(m, batch))
    counted = out.layer.get("span_spmm_launches")
    if not launches or launches != expected or counted != expected:
        print(f"spmm_coo_roofline: {launches} kernels in the profile, "
              f"{counted} counted by the program, {expected} expected; "
              "not read", file=sys.stderr)
        return None
    bound = steps * spmm.train_step_bound_s(supports, m, batch)
    return 100.0 * bound / seconds


def latency_median_ms(cell, out) -> Optional[float]:
    lat = out.layer.get("latencies_ms")
    return statistics.median(lat) if lat else None
