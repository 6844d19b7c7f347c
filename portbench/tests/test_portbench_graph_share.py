"""``serve_graph_share.stream``: the share of the window's serving forwards
that replayed a CUDA graph, read from the ``graphed`` count of the
program's ``serve.forward`` spans; nothing where the forwards count none
(a program older than the count), or where there is no window."""
import itertools

import pytest

from portbench.harness import cell as cells
from megacrn_tpu_torch.train import telemetry

STREAM = "expytky-road.serve-stream"


def _pushes(graphed, profiled=False, start=0):
    """A ``serve.push`` for each entry of ``graphed``, each with one
    ``serve.forward`` that counts it (no count where the entry is None)."""
    ids, out, t = itertools.count(start + 1), [], start * 10
    for g in graphed:
        push = telemetry.Span("serve.push", {})
        fwd = telemetry.Span("serve.forward",
                             {} if g is None else {"graphed": g})
        push.id, fwd.id = next(ids), next(ids)
        push.parent, fwd.parent = None, push.id
        push.request = fwd.request = push.id
        for s in (push, fwd):
            s.thread, s.profiled = 1, profiled
        push.start_ns, fwd.start_ns = t, t + 1
        fwd.end_ns, push.end_ns = t + 2, t + 3
        t += 10
        out += [fwd, push]
    return out


def _read(monkeypatch, recorded):
    monkeypatch.setattr(telemetry, "spans", lambda: list(recorded))
    return cells.reader("serve_graph_share.stream")(cells.load(STREAM), None)


def test_reads_the_window_s_graphed_share(monkeypatch):
    warm = cells.load(STREAM).traffic["warm_pushes"]
    setup = _pushes([0] * warm)
    window = _pushes([1, 1, 0, 1], start=100)
    traced = _pushes([0, 0], profiled=True, start=200)
    assert _read(monkeypatch, setup + window + traced) == pytest.approx(75.0)
    every = _pushes([1] * 6, start=100)
    assert _read(monkeypatch, setup + every) == 100.0


@pytest.mark.parametrize("window", [[None, None], []])
def test_nothing_to_read(monkeypatch, window):
    warm = cells.load(STREAM).traffic["warm_pushes"]
    recorded = _pushes([None] * warm) + _pushes(window, start=100)
    assert _read(monkeypatch, recorded) is None
