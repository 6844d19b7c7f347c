"""Streaming traffic: one stream in a closed loop. Each new observation
step of every sensor (raw speeds, from a start drawn from the seed in the
month, wrapping at its end) goes to ``StreamingForecaster.push`` with a
covariate function for the horizon ahead; the next push goes out when the
forecast is back in host memory, so no queue forms. Each push is timed on
the host clock, from the call to the forecast returned.

The pushes that warm the window (which return None) and ``warm_pushes``
more belong to set-up. After the window the reference forecasts every
push's window again, in blocks, and each forecast is compared. The traced
span is ``trace_pushes`` more pushes.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import check, common, data, trace
from portbench.harness.kinds.serve_bulk import (build_predictor,
                                                reference_forecasts)


def plant(fault, forecaster):
    """The program with a fault planted: a forecast altered where it is
    produced, or a stream whose window stops advancing once it is full."""
    if fault is None:
        return
    push = forecaster.push
    if fault == "answer_altered":
        def altered(obs):
            out = push(obs)
            if out is not None:
                out = np.array(out)
                out[0, 0] += 1.0
            return out
        forecaster.push = altered
    elif fault == "state_unchanged":
        def stale(obs):
            if len(forecaster._window) < forecaster.cfg.seq_len:
                return push(obs)
            forecaster._t += 1
            return forecaster.predictor.predict(
                np.stack(forecaster._window)[None],
                forecaster._cov_fn(forecaster._t)[None])[0]
        forecaster.push = stale
    else:
        raise ValueError(f"unknown fault {fault!r}")


def run(a: common.RunArgs) -> common.Outcome:
    cfg, tr, dev = a.cell.config, a.cell.traffic, a.device
    m = cfg["model"]
    his, hor = m["seq_len"], m["horizon"]
    sync = common.synchronizer(dev)
    prog, predictor, speeds, cov, mean, std, supports, init = \
        build_predictor(a)
    steps = len(speeds)
    start = int(np.random.default_rng(data.seed_stream(a.seed, 6))
                .integers(0, steps))

    def cov_fn(t):
        return cov[(start + t + np.arange(hor)) % steps][..., None]

    forecaster = prog.stream(predictor, cov_fn)
    plant(a.fault, forecaster)
    pushed = 0

    def push():
        nonlocal pushed
        out = forecaster.push(speeds[(start + pushed) % steps])
        pushed += 1
        return out

    for _ in range(his - 1 + tr["warm_pushes"]):
        push()
    sync()
    first = pushed
    lat, outs = [], []

    def one():
        t = time.perf_counter()
        out = push()
        lat.append(time.perf_counter() - t)
        outs.append(out)

    setup_s = time.perf_counter() - a.t_start
    n, _ = common.window(a.seconds, one)
    lat_ms = [1e3 * v for v in lat]
    tr_ = None
    if a.trace:
        def work():
            for _ in range(tr["trace_pushes"]):
                with record_function("push"):
                    push()

        tr_ = trace.capture(work, sync)
    layer = {"latencies_ms": lat_ms, "span_units": tr["trace_pushes"]}
    peak = common.memory_peak(dev)
    failed = sum(o is None or o.shape != (hor, m["num_nodes"],
                                          m["output_dim"])
                 or not np.isfinite(o).all() for o in outs)
    del predictor, forecaster
    common.free(dev)

    ends = np.arange(first, first + n)  # the push index of each forecast
    rows = (start + ends[:, None] + np.arange(-his + 1, 1)) % steps
    x_raw = np.ascontiguousarray(speeds[rows][..., None])
    y_cov = np.ascontiguousarray(cov[(start + ends[:, None] + 1
                                      + np.arange(hor)) % steps][..., None])
    p95 = statistics.quantiles(lat_ms, n=100, method="inclusive")[94]
    quantities = {"serve_p95_ms": p95, "setup_s": setup_s}
    if failed:  # a missing or malformed forecast: nothing to compare
        return common.Outcome(quantities, n, failed,
                              {"out_err": check.NOT_COMPARED}, peak, tr_,
                              layer)
    got = [torch.from_numpy(np.stack(outs))]

    def forecasts(mode):
        return [reference_forecasts(init, m, x_raw, y_cov, mean, std,
                                    supports, dev, mode).cpu()]

    want = forecasts("float32")
    readings = {"out_err": check.out_err(got, want)}
    control = ({"out_err": check.out_err(forecasts("tf32"), want)}
               if a.control else None)
    return common.Outcome(quantities, n, failed, readings, peak, tr_, layer,
                          control)
