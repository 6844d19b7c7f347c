"""The readers of the program's spans (``harness/spans.py`` and the five
``metrics/*.py`` that use it): given a recorder filled by hand with set-up,
window and profiled spans, each reads the window alone; a program without
a recorder, or a ring that may have dropped spans, gives nothing; and on a
tiny run on the CPU each finds the run's own window."""
import itertools
import time

import pytest
import torch

from conftest import tiny_cell
from portbench.harness import cell as cells
from portbench.harness import env, spans
from megacrn_tpu_torch.train import telemetry

MS = 1_000_000  # ns


class Recorder:
    """Spans made by hand, on a clock that only moves forward."""

    def __init__(self):
        self.spans = []
        self.ids = itertools.count(1)
        self.now = 0

    def put(self, name, ms, parent=None, profiled=False, at=None, **counts):
        """A span of ``ms`` starting at ``at`` (default: now), recorded at
        its end; the clock moves to its end."""
        s = telemetry.Span(name, counts)
        s.id = next(self.ids)
        s.parent = None if parent is None else parent.id
        s.request = s.id if parent is None else parent.request
        s.thread, s.profiled = 1, profiled
        s.start_ns = self.now if at is None else at
        s.end_ns = s.start_ns + int(ms * MS)
        self.now = max(self.now, s.end_ns) + MS
        self.spans.append(s)
        return s

    def chunk(self, parent, windows, padded, back_ms, profiled=False):
        """A serving chunk inside ``parent``, 1 ms from its start: its
        upload, forward and copy back (``back_ms``)."""
        c = self.put("serve.chunk", 2 + back_ms, parent, profiled,
                     at=self.now, windows=windows, padded=padded)
        self.now = c.start_ns
        for name, ms in (("serve.upload", 0.5), ("serve.forward", 0.5),
                         (spans.COPY_BACK, back_ms)):
            self.put(name, ms, c, profiled, at=self.now + MS // 4)
        return c

    def request(self, name, host_ms, chunks, profiled=False):
        """A top-level ``name`` span whose host time is ``host_ms``
        besides its chunks' copies back ``[(windows, padded, back_ms)]``."""
        top = telemetry.Span(name, {})
        top.id = next(self.ids)
        top.parent, top.request, top.thread = None, top.id, 1
        top.profiled, top.start_ns = profiled, self.now
        self.now += MS
        for w, p, b in chunks:
            self.chunk(top, w, p, b, profiled)
        top.end_ns = top.start_ns + int(
            (host_ms + sum(b for *_, b in chunks)) * MS)
        self.now = max(self.now, top.end_ns) + MS
        self.spans.append(top)
        return top

    def step(self, data_ms, upload_ms, profiled=False, reshuffle_ms=None):
        if reshuffle_ms is not None:
            self.put("data.reshuffle", reshuffle_ms, None, profiled,
                     bytes=10)
        self.put("data.prepare", data_ms, None, profiled)
        self.put("train.upload", upload_ms, None, profiled, bytes=10)
        st = self.put("train.step", 50, None, profiled)
        self.now = st.start_ns
        for name in ("train.forward", "train.backward", "train.optimizer"):
            self.put(name, 10, st, profiled)
        self.now = st.end_ns + MS
        return st


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(telemetry, "spans", lambda: list(rec.spans))
    return rec


def _read(metric, workload):
    return cells.reader(metric)(cells.load(workload), None)


STREAM, BULK, TRAIN = ("expytky-road.serve-stream", "expytky-road.serve-bulk",
                       "expytky-road.train")


def test_stream_readers_read_the_window_alone(recorder):
    warm = cells.load(STREAM).traffic["warm_pushes"]
    for _ in range(warm):  # set-up: slow, little padding
        recorder.request("serve.push", 90.0, [(2, 6, 40.0)])
    for host in (4.0, 6.0, 5.0, 7.0, 3.0):
        recorder.request("serve.push", host, [(1, 63, 20.0)])
    for _ in range(3):  # the traced span
        recorder.request("serve.push", 50.0, [(1, 7, 1.0)], profiled=True)
    assert _read("serve_host_ms.stream", STREAM) == pytest.approx(5.0)
    assert _read("serve_pad_share.stream", STREAM) == 98.4375


def test_bulk_reader_subtracts_every_chunks_copy_back(recorder):
    warm = cells.load(BULK).traffic["warm_requests"]
    for _ in range(warm):
        recorder.request("serve.predict", 900.0, [(64, 0, 5.0)] * 2)
    for host in (120.0, 100.0, 110.0):
        recorder.request("serve.predict", host,
                         [(64, 0, 20.0), (64, 0, 21.0), (48, 16, 15.0)])
    recorder.request("serve.predict", 1.0, [(64, 0, 300.0)], profiled=True)
    assert _read("serve_host_ms.bulk", BULK) == pytest.approx(110.0)


def test_train_readers_read_the_window_alone(recorder):
    setup = cells.load(TRAIN).traffic["check_steps"]
    recorder.step(100.0, 100.0, reshuffle_ms=500.0)
    for _ in range(setup - 1):
        recorder.step(100.0, 100.0)
    for i in range(4):  # a reshuffle at the window's third step
        recorder.step(1.0, 2.0, reshuffle_ms=6.0 if i == 2 else None)
    for _ in range(2):
        recorder.step(1000.0, 1000.0, profiled=True)
    assert _read("loader_ms.road", TRAIN) == pytest.approx((4 + 6) / 4)
    assert _read("upload_ms.road", TRAIN) == pytest.approx(2.0)


@pytest.mark.parametrize("metric,workload", [
    ("serve_host_ms.stream", STREAM), ("serve_pad_share.stream", STREAM),
    ("serve_host_ms.bulk", BULK), ("loader_ms.road", TRAIN),
    ("upload_ms.road", TRAIN)])
def test_nothing_to_read(recorder, monkeypatch, metric, workload):
    # Only set-up units: no window.
    recorder.request("serve.push", 1.0, [(1, 63, 1.0)])
    recorder.request("serve.predict", 1.0, [(1, 63, 1.0)])
    recorder.step(1.0, 1.0)
    assert _read(metric, workload) is None
    # A ring that may have dropped set-up spans.
    monkeypatch.setattr(telemetry, "RING", len(recorder.spans))
    assert _read(metric, workload) is None
    # A program without the recorder.
    monkeypatch.delattr(telemetry, "spans")
    assert _read(metric, workload) is None


@pytest.mark.parametrize("workload,metrics", [
    (STREAM, ("serve_host_ms.stream", "serve_pad_share.stream")),
    (BULK, ("serve_host_ms.bulk",)),
    (TRAIN, ("loader_ms.road", "upload_ms.road"))])
def test_a_tiny_run_reads_its_window(workload, metrics):
    telemetry.clear()
    cell = tiny_cell(workload)
    out, line = env.run_cell(cell, 2 ** 31 + 11, 0.3, False,
                             torch.device("cpu"), time.perf_counter())
    assert line["correct"], line["compared"]
    values = {m: cells.reader(m)(cell, out) for m in metrics}
    assert all(v is not None and v > 0 for v in values.values()), values
    if workload == STREAM:
        win = spans.window("serve.push", cell.traffic["warm_pushes"])
        assert len(spans._top(win, "serve.push")) == out.attempted
        batch = cell.config["serve_batch"]
        assert values["serve_pad_share.stream"] == 100 * (batch - 1) / batch
    elif workload == BULK:
        win = spans.window("serve.predict", cell.traffic["warm_requests"])
        assert len(spans._top(win, "serve.predict")) == out.attempted
    else:
        win = spans.window("train.step", cell.traffic["check_steps"])
        steps = len(spans._top(win, "train.step"))
        assert steps == out.attempted - cell.traffic["check_steps"]
        assert len(spans._top(win, "train.upload")) == steps
    telemetry.clear()
