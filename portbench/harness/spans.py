"""The program's spans (``megacrn_tpu_torch.train.telemetry``) in a run's
untraced window, and the arithmetic of the per-layer metrics that read
them. Besides ``program.py``, the one module of the benchmark that imports
the program.

A run is one process (``run.py``), so the recorder holds that run's spans
alone. The window's spans are those recorded with no profiler running that
start after the end of the set-up's last unit: the ``setup``-th top-level
span of the unit the traffic counts (a train step, a push, a request).
Where the program records no spans (one older than its recorder), or the
recorder's ring is full (it may have dropped set-up units), there is
nothing to read: None.
"""
from __future__ import annotations

import statistics
from collections import defaultdict
from typing import List, Optional

COPY_BACK = "serve.copy_back"  # where the serving host waits for the card


def recorded() -> Optional[list]:
    from megacrn_tpu_torch.train import telemetry

    if not hasattr(telemetry, "spans"):
        return None
    out = telemetry.spans()
    return None if len(out) >= telemetry.RING else out


def window(unit: str, setup: int) -> Optional[list]:
    """The untraced window's spans: after the ``setup``-th top-level
    ``unit`` span, with no profiler running; None where no ``unit`` span
    follows the set-up."""
    spans = recorded()
    if not spans:
        return None
    units = sorted((s for s in spans if s.name == unit and s.parent is None
                    and not s.profiled), key=lambda s: s.start_ns)
    if len(units) <= setup:
        return None
    since = units[setup - 1].end_ns if setup else units[0].start_ns
    return [s for s in spans if not s.profiled and s.start_ns >= since]


def _top(spans: List, name: str) -> List:
    return [s for s in spans if s.name == name and s.parent is None]


def host_ms(spans: Optional[list], unit: str) -> Optional[float]:
    """Median over the top-level ``unit`` spans of each one's time less
    the ``serve.copy_back`` spans of its request, where the host blocks on
    the card (ms)."""
    if not spans:
        return None
    waited = defaultdict(int)
    for s in spans:
        if s.name == COPY_BACK:
            waited[s.request] += s.end_ns - s.start_ns
    host = [1e-6 * (s.end_ns - s.start_ns - waited[s.id])
            for s in _top(spans, unit)]
    return statistics.median(host) if host else None


def pad_share_pct(spans: Optional[list]) -> Optional[float]:
    """Padded windows over all the windows the chunks computed (%)."""
    chunks = [s for s in spans or () if s.name == "serve.chunk"]
    done = sum(s.counts["windows"] + s.counts["padded"] for s in chunks)
    if not done:
        return None
    return 100.0 * sum(s.counts["padded"] for s in chunks) / done


def per_step_ms(spans: Optional[list], prefix: str) -> Optional[float]:
    """The time of the spans whose name starts with ``prefix`` over the
    number of train steps (ms)."""
    if not spans:
        return None
    steps = len(_top(spans, "train.step"))
    if not steps:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans
                      if s.name.startswith(prefix)) / steps
