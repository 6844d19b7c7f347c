"""The traced span's reader on hand-made Chrome-trace events."""
import pytest

from portbench.harness import trace


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_busy_idle_kernels_and_gaps():
    events = [
        ev("user_annotation", trace.SPAN, 100.0, 100.0),
        ev("user_annotation", "train_step", 100.0, 60.0),
        ev("cpu_op", "aten::mm", 100.0, 20.0),
        ev("cpu_op", "aten::cat", 150.0, 5.0),
        ev("kernel", "void row_spmm_kernel<float, true>", 110.0, 20.0),
        ev("kernel", "gemm", 120.0, 20.0),  # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoH", 170.0, 10.0),
        ev("kernel", "outside", 300.0, 10.0),  # after the span
    ]
    t = trace.read(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)  # 110-140 and 170-180
    assert len(t.kernels) == 2
    assert t.kernel_time("row_spmm") == (1, pytest.approx(20e-6))
    gaps = dict(t.idle_gaps)
    # 100-110 under aten::mm; 140-170 (mid 155: aten::cat); 180-200 none.
    assert gaps["train_step/aten::mm"] == pytest.approx(10e-6)
    assert gaps["train_step/aten::cat"] == pytest.approx(30e-6)
    assert gaps["python"] == pytest.approx(20e-6)
    assert dict(t.device_ops)["gemm"] == pytest.approx(20e-6)


def test_no_device_time_raises():
    with pytest.raises(RuntimeError, match="no device time"):
        trace.read([ev("user_annotation", trace.SPAN, 0.0, 10.0),
                    ev("cpu_op", "aten::mm", 0.0, 5.0)])


def test_cpu_profile_yields_no_device_time():
    """On a machine without a card the profiler records no kernel: the
    traced run fails, it never reads an idle share of 100 %."""
    with pytest.raises(RuntimeError, match="no device time"):
        trace.capture(lambda: sum(range(1000)), lambda: None)


def test_idle_share_reads_one_span():
    """Busy time and wall time of the same traced span: 30 ms busy in
    80 ms is 62.5 % idle; a span busier than its wall time fails."""
    from portbench.harness import readers
    from portbench.harness.common import Outcome

    t = trace.Trace(window_s=0.08, busy_s=0.03, kernels=[("k", 0.01)] * 6)
    out = Outcome({"train_step_ms": 20.0}, 1, 0, {}, 0, t,
                  {"span_units": 2})
    assert readers.device_idle_pct(None, out) == pytest.approx(62.5)
    out.trace = trace.Trace(window_s=0.02, busy_s=0.03, kernels=[])
    with pytest.raises(RuntimeError, match="not an idle share"):
        readers.device_idle_pct(None, out)
    out.trace = None
    assert readers.device_idle_pct(None, out) is None
