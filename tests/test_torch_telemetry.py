"""The port's span recorder (megacrn_tpu_torch/train/telemetry.py) and the
spans of its serving, train-step and input paths: nesting, parents, self
time and requests; one stack a thread; the ring's bound; the off switch;
the serving chunks' counts; the spans of a CPU ``fit``; and the profiler's
clock, which the spans share."""
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from megacrn_tpu_torch import serve
from megacrn_tpu_torch.config import MegaCRNConfig, train_config_for
from megacrn_tpu_torch.data import datasets
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.train import logs
from megacrn_tpu_torch.train import loop
from megacrn_tpu_torch.train import telemetry as tele

torch.set_num_threads(1)
N = 12


@pytest.fixture(autouse=True)
def fresh_ring():
    tele.clear()
    yield
    tele.clear()


def _by_name(recorded):
    out = {}
    for s in recorded:
        out.setdefault(s.name, []).append(s)
    return out


def test_spans_nest_with_parents_self_time_and_requests():
    with tele.span("a", n=3) as a:
        with tele.span("b") as b:
            with tele.span("c") as c:
                pass
        with tele.span("d") as d:
            pass
    with tele.span("e") as e:
        pass
    recorded = tele.spans()
    assert [s.name for s in recorded] == ["c", "b", "d", "a", "e"]
    assert a.parent is None and e.parent is None
    assert b.parent == d.parent == a.id and c.parent == b.id
    assert a.request == b.request == c.request == d.request == a.id
    assert e.request == e.id != a.id
    assert a.counts == {"n": 3} and b.counts == {}
    assert all(s.thread == threading.get_ident() for s in recorded)
    assert all(s.start_ns <= s.end_ns for s in recorded)
    assert a.start_ns <= b.start_ns and b.end_ns <= d.start_ns
    assert d.end_ns <= a.end_ns
    assert tele.self_time(a) == pytest.approx(
        a.seconds - b.seconds - d.seconds, abs=1e-12)
    assert tele.self_time(b) == pytest.approx(b.seconds - c.seconds,
                                              abs=1e-12)
    assert tele.self_time(c) == c.seconds


def test_each_thread_keeps_its_own_stack():
    both_open = threading.Barrier(2, timeout=10)
    ids = {}

    def work(name):
        with tele.span(name) as top:
            both_open.wait()  # the other thread's span is open too
            with tele.span(name + ".child") as child:
                both_open.wait()
        ids[name] = (top, child)

    threads = [threading.Thread(target=work, args=(n,)) for n in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    for name, (top, child) in ids.items():
        assert top.parent is None
        assert child.parent == top.id and child.request == top.id
        assert child.thread == top.thread
    assert ids["x"][0].thread != ids["y"][0].thread
    assert ids["x"][0].request != ids["y"][0].request


def test_the_ring_keeps_the_newest_spans():
    for i in range(tele.RING + 10):
        with tele.span("s", i=i):
            pass
    recorded = tele.spans()
    assert len(recorded) == tele.RING
    assert recorded[0].counts["i"] == 10
    assert recorded[-1].counts["i"] == tele.RING + 9


def test_disabled_records_nothing(monkeypatch):
    monkeypatch.setattr(tele, "ENABLED", False)
    with tele.span("off", n=1) as s:
        with tele.span("inner"):
            pass
    assert s is None and tele.spans() == []


def test_no_record_function_outside_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tele.span("quiet"):
        pass
    (s,) = tele.spans()
    assert s.name == "quiet" and s.profiled is False


def test_spans_share_the_profilers_clock(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tele.span(f"clock.{i}"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    notes = {e["name"]: e for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    recorded = tele.spans()
    assert len(recorded) == 5 and all(s.profiled for s in recorded)
    for s in recorded:
        e = notes[s.name]
        start_ns = float(e["ts"]) * 1e3 + base
        assert abs(start_ns - s.start_ns) < 1e6, s.name  # within 1 ms
        end_ns = start_ns + float(e["dur"]) * 1e3
        assert abs(end_ns - s.end_ns) < 1e6, s.name


def _predictor(max_batch):
    cfg = MegaCRNConfig(num_nodes=N, rnn_units=8, mem_num=4, mem_dim=8,
                        horizon=3, seq_len=4)
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    return serve.Predictor(model, cfg, 50.0, 10.0, max_batch, device="cpu")


@pytest.mark.parametrize("windows, chunks", [
    (1, [(1, 0)]),
    (9, [(4, 0), (4, 0), (1, 0)]),
])
def test_serving_chunks_count_windows_and_padding(windows, chunks):
    pred = _predictor(max_batch=4)
    x = np.random.RandomState(0).rand(windows, 4, N, 1).astype(np.float32)
    out = pred.predict(70 * x)
    assert out.shape == (windows, 3, N, 1)
    by = _by_name(tele.spans())
    (request,) = by["serve.predict"]
    assert request.parent is None and request.counts == {"windows": windows}
    got = [(c.counts["windows"], c.counts["padded"])
           for c in by["serve.chunk"]]
    assert got == chunks
    for c in by["serve.chunk"]:
        assert c.parent == request.id and c.request == request.id
    for name in ("serve.upload", "serve.forward", "serve.copy_back"):
        assert len(by[name]) == len(chunks)
        assert {s.parent for s in by[name]} == {
            c.id for c in by["serve.chunk"]}
    # x and y_cov of each chunk's own windows go up; its forecasts come
    # back.
    for (nb, _), up, back in zip(chunks, by["serve.upload"],
                                 by["serve.copy_back"]):
        assert up.counts["bytes"] == nb * (4 + 3) * N * 4
        assert back.counts["bytes"] == nb * 3 * N * 4


def test_streaming_push_is_spanned_once_the_window_is_warm():
    stream = serve.StreamingForecaster(_predictor(max_batch=4))
    rs = np.random.RandomState(1)
    for _ in range(6):  # seq_len 4: 3 warming pushes, then 3 forecasts
        stream.push(70 * rs.rand(N).astype(np.float32))
    by = _by_name(tele.spans())
    pushes = by["serve.push"]
    assert len(pushes) == 3 and all(p.parent is None for p in pushes)
    assert [p.id for p in pushes] == [s.parent for s in by["serve.predict"]]
    assert [c.counts for c in by["serve.chunk"]] == [
        {"windows": 1, "padded": 0}] * 3
    for p in pushes:
        family = [s for s in tele.spans() if s.request == p.id]
        # The dense model's forward adds its meta-graph and aggregations.
        assert {s.name for s in family} == {
            "serve.push", "serve.predict", "serve.chunk", "serve.upload",
            "serve.forward", "serve.copy_back", "graph.meta",
            "graph.aggregate"}


def test_fit_records_the_step_its_children_the_loader_and_the_upload(
        tmp_path):
    cfg = MegaCRNConfig(num_nodes=N, rnn_units=8, mem_num=4, mem_dim=8,
                        horizon=4, seq_len=4)
    train = train_config_for("METRLA", batch_size=16, epochs=1, patience=2,
                             seed=0)
    data = datasets.build_synthetic(
        num_nodes=N, num_steps=200, seq_len=4, horizon=4, batch_size=16,
        seed=3, shuffle_rng=np.random.default_rng(1),
        reshuffle_each_epoch=True)
    run = logs.RunDir(str(tmp_path), "T", snapshot_sources=False,
                      timestring="0")
    loop.fit(cfg, train, data, run, test_every_epoch=False, device="cpu")
    by = _by_name(tele.spans())
    steps = by["train.step"]
    assert len(steps) == len(data["train_loader"])
    for name in ("train.forward", "train.backward", "train.optimizer"):
        assert [s.parent for s in by[name]] == [s.id for s in steps]
    children = {s.name for s in tele.spans()
                if s.parent in {t.id for t in steps}}
    assert children == {"train.forward", "train.backward",
                        "train.optimizer"}
    assert len(by["data.reshuffle"]) == 1
    assert by["data.reshuffle"][0].counts["bytes"] > 0
    assert len(by["data.prepare"]) >= len(steps)  # and the evals'
    assert len(by["train.upload"]) >= len(steps)
    with open(run.metrics_path) as f:
        (epoch,) = [r for r in map(json.loads, f) if "train_loss" in r]
    assert epoch["upload_seconds"] > 0 and epoch["loader_seconds"] > 0
    uploads = [s for s in by["train.upload"]
               if s.end_ns <= steps[-1].end_ns]
    assert len(uploads) == len(steps)
    assert epoch["upload_seconds"] == pytest.approx(
        sum(s.seconds for s in uploads))
