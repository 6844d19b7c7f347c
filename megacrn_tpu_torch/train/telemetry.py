"""Observability: spans of the program's layers, throughput accounting,
profiler hooks (counterpart of ``megacrn_tpu/train/telemetry.py``).

Spans: ``with span("serve.chunk", windows=1, padded=0): ...`` records
the span's name, start and end, its parent (the innermost span open on
the same thread), its request (a top-level span's own id, inherited by
its descendants), its thread, the counts passed in, and whether a torch
profiler was running. The stamps are ``time.time_ns()``, the clock of
``torch.profiler``'s Chrome trace (an event's ``ts``, in us, plus the
trace's ``baseTimeNanoseconds``). Under a profiler a span also enters
``torch.profiler.record_function(name)``, so the trace names the
program's layers; otherwise a span costs two clock reads and an append.
The last ``RING`` spans are kept in memory (``spans()``), never written
out; ``ENABLED = False`` records nothing.

Besides: the edges a dense train step traverses, a ``torch.profiler``
trace around a block of steps (written as a Chrome trace), and the peak
device memory of the card, which stands in for the JAX package's
compiled-program memory statistics (PyTorch compiles no program to ask).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

ENABLED = True
# Room for 20 s of one-window pushes at about 0.5 ms each, six spans a
# push, so a benchmark window's spans are all kept (about 440 bytes each).
RING = 262_144

_ring: collections.deque = collections.deque(maxlen=RING)
_ids = itertools.count(1)
_local = threading.local()
_OFF = contextlib.nullcontext()

clock_ns = time.time_ns  # the profiler's Chrome-trace clock


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One recorded span; ``start_ns``/``end_ns`` on ``clock_ns``."""

    __slots__ = ("name", "counts", "id", "parent", "request", "thread",
                 "profiled", "start_ns", "end_ns", "_note")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name = name
        self.counts = counts
        self.end_ns: Optional[int] = None
        self._note = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.request = self.id if up is None else up.request
        self.thread = threading.get_ident()
        self.profiled = _autograd_profiler._is_profiler_enabled
        stack.append(self)
        self.start_ns = clock_ns()
        if self.profiled:
            self._note = torch.profiler.record_function(self.name)
            self._note.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._note is not None:
            self._note.__exit__(*exc)
            self._note = None
        self.end_ns = clock_ns()
        _stack().pop()
        _ring.append(self)


def span(name: str, **counts):
    """A context manager recording one span of ``name`` with ``counts``
    (it yields the ``Span``; nothing when ``ENABLED`` is off)."""
    if not ENABLED:
        return _OFF
    return Span(name, counts)


def spans() -> List[Span]:
    """The recorded spans, oldest first by their end (a child before its
    parent); at most ``RING``, the oldest dropped."""
    return list(_ring)


def clear() -> None:
    _ring.clear()


def self_time(s: Span) -> float:
    """Seconds of ``s`` less the part its child spans cover; a span's
    children run on its thread, one after another."""
    return s.seconds - sum(c.seconds for c in spans() if c.parent == s.id)


def total_seconds(prefix: str, since_ns: int, until_ns: int) -> float:
    """Summed seconds of the caller's thread's recorded spans whose name
    starts with ``prefix`` and that ran wholly within [since_ns,
    until_ns]."""
    thread = threading.get_ident()
    return sum(s.seconds for s in spans()
               if s.name.startswith(prefix) and s.thread == thread
               and s.start_ns >= since_ns and s.end_ns <= until_ns)


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


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the host and, when the card is
    in use, its kernels around a block of steps; written to
    ``<log_dir>/trace.json`` (open it in chrome://tracing or Perfetto).
    The program's spans show in it as ``user_annotation`` events."""
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
