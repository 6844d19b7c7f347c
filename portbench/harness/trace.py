"""The traced span: ``torch.profiler`` over a steady stretch of work, read
back from its Chrome trace.

``capture(work, synchronize)`` profiles ``work()`` twice. First with the
device's activity alone, which costs the host little, so that the span's
wall time (host clock, between two synchronisations) and the device's busy
time (the union of its kernels, copies and memsets) are the run's own.
Then with the host's operations too, inside a ``portbench.span``
annotation, for what the host was doing in each of the device's idle gaps
(recording every host operation slows the host, so this second span is
read for that alone). A profile with no device time raises: a card that
yields none is a fault of the measurement, never an idle share of 100 %.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN = "portbench.span"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 64


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]  # (name, seconds) per kernel launch
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    counted: Optional[int] = None  # the caller's counter over the span
    busy: list = field(default_factory=list, repr=False)  # intervals, us

    def kernel_time(self, contains: str) -> Tuple[int, float]:
        """(launches, seconds) of the kernels whose name contains
        ``contains``."""
        hits = [d for n, d in self.kernels if contains in n]
        return len(hits), sum(hits)


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def capture(work, synchronize, count=None) -> Trace:
    """Profile ``work()`` on the card; ``synchronize()`` brackets it.
    ``count()``, if given, is read before and after the device span."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        raise RuntimeError("the profile holds no device time: no CUDA card")
    synchronize()
    before = count() if count else None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        synchronize()
        window_s = time.perf_counter() - t0
    counted = count() - before if count else None
    dev = _device(_events(prof), None, None)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        synchronize()
        with record_function(SPAN):
            work()
            synchronize()
    gaps = read(_events(prof)).idle_gaps
    return Trace(window_s, dev.busy_s, dev.kernels, dev.device_ops, gaps,
                 counted)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device(events: List[dict], t0, t1) -> Trace:
    """Busy time, kernels and the longest device operations of the device
    events, clipped to [t0, t1] where given (us)."""
    lo = -float("inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    dev = []
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            if s + d > lo and s < hi:
                dev.append((max(s, lo), min(s + d, hi), e["cat"], e["name"]))
    if not dev:
        raise RuntimeError("the profile holds no device time in the traced "
                           "span: the card's activity was not recorded")
    busy = _union([(s, e) for s, e, _, _ in dev])
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, _, n in dev:
        by_name[n[:NAME_CHARS]] += (e - s) * 1e-6
    window = 0.0 if t0 is None else (hi - lo) * 1e-6  # capture() times it
    return Trace(window, sum(e - s for s, e in busy) * 1e-6,
                 [(n, (e - s) * 1e-6) for s, e, c, n in dev if c == "kernel"],
                 _top(by_name), busy=busy)


def read(events: List[dict]) -> Trace:
    """A ``Trace`` of the ``portbench.span`` annotation in Chrome-trace
    events (``ts`` and ``dur`` in us), with the host's operations."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == SPAN
             and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"the profile holds {len(spans)} {SPAN} "
                           "annotations, not one")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    t = _device(events, t0, t1)
    host, notes = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") == "user_annotation":
            if e.get("name") != SPAN:
                notes.append((s, s + d, e["name"]))
        elif e.get("cat") in HOST_CATS:
            host.append((s, s + d, e["name"]))
    gaps = []
    edge = t0
    for s, e in t.busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        gaps.append((edge, t1))
    t.idle_gaps = _top(_gaps_by_host(gaps, host, notes))
    return t


def _gaps_by_host(gaps, host, notes) -> Dict[str, float]:
    """Idle seconds by what the host was doing at each gap's midpoint: the
    innermost host event then (the one that started last), under the
    benchmark's annotation of the call it belongs to."""
    host.sort()
    notes.sort()
    starts = [s for s, _, _ in host]
    note_starts = [s for s, _, _ in notes]
    out: Dict[str, float] = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label = "python"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(-1, i - 200), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        k = bisect.bisect_right(note_starts, mid)
        for j in range(k - 1, max(-1, k - 50), -1):
            if notes[j][1] >= mid:
                label = f"{notes[j][2]}/{label}"
                break
        out[label[:NAME_CHARS]] += (g1 - g0) * 1e-6
    return out


def _top(d: Dict[str, float], k: int = 10) -> List[Tuple[str, float]]:
    return sorted(d.items(), key=lambda kv: -kv[1])[:k]
