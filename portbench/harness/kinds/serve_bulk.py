"""Bulk serving traffic: one client in a closed loop, each request
``Predictor.predict`` on ``request_windows`` consecutive windows (raw
speeds and their covariates) from a start drawn from the seed in the
month; the next request goes out when the forecasts are back in host
memory.

After the window a sample of ``check_requests`` requests drawn from the
seed, the last one with them, is forecast again by the reference and
compared window by window. The traced span is ``trace_requests`` more
requests.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import check, common, data, trace, weights
from portbench.harness.program import Program
from portbench.reference import megacrn as ref


def build_predictor(a: common.RunArgs):
    """(program, predictor, speeds, cov, mean, std, supports, weights) of
    the cell's configuration, from the seed."""
    cfg, dev = a.cell.config, a.device
    prog = Program(cfg, dev)
    speeds, cov = data.month(cfg, a.cell.traffic, a.seed)
    mean, std = float(speeds.mean()), float(speeds.std())
    supports = data.graph_supports(cfg)
    init = weights.make(cfg, data.seed_stream(a.seed, 1), dev)
    predictor = prog.predictor(prog.model(init), mean, std,
                               prog.graph_constant(supports),
                               cfg["serve_batch"])
    return prog, predictor, speeds, cov, mean, std, supports, init


def plant(fault, predictor):
    """The program with a fault planted: a forecast altered where it is
    produced, or half of each chunk's windows never computed (their rows
    copied from the other half)."""
    if fault is None:
        return
    fwd = predictor._forward
    if fault == "answer_altered":
        def altered(*arrays):
            out = np.array(fwd(*arrays))
            out[0, 0, 0] += 1.0
            return out
        predictor._forward = altered
    elif fault == "half_batch":
        def half(*arrays):
            out = np.array(fwd(*arrays))
            b = out.shape[0] // 2
            out[b:2 * b] = out[:b]
            return out
        predictor._forward = half
    else:
        raise ValueError(f"unknown fault {fault!r}")


def reference_forecasts(init, m, x_raw, y_cov, mean, std, supports, dev,
                        mode):
    """The reference's raw-scale forecasts of numpy windows, on ``dev``."""
    sup = None if supports is None else torch.from_numpy(supports).to(dev)
    with ref.precision(mode):
        return ref.predict(init, m, torch.from_numpy(x_raw).to(dev),
                           torch.from_numpy(y_cov).to(dev), mean, std, sup)


def run(a: common.RunArgs) -> common.Outcome:
    cfg, tr, dev = a.cell.config, a.cell.traffic, a.device
    m = cfg["model"]
    his, hor, size = m["seq_len"], m["horizon"], tr["request_windows"]
    sync = common.synchronizer(dev)
    prog, predictor, speeds, cov, mean, std, supports, init = \
        build_predictor(a)
    plant(a.fault, predictor)
    xw = data.windows(speeds[..., None], his)
    cw = data.windows(cov[..., None], hor)
    rng = np.random.default_rng(data.seed_stream(a.seed, 4))
    last_start = len(speeds) - his - hor - size + 1

    def request():
        s = int(rng.integers(0, last_start))
        return s, predictor.predict(xw[s:s + size], cw[s + his:s + his + size])

    for _ in range(tr["warm_requests"]):
        request()
    sync()
    done = []
    setup_s = time.perf_counter() - a.t_start
    n, window_s = common.window(a.seconds, lambda: done.append(request()))
    layer, tr_ = {}, None
    if a.trace:
        def work():
            for _ in range(tr["trace_requests"]):
                with record_function("predict"):
                    request()

        tr_ = trace.capture(work, sync)
        layer["span_units"] = tr["trace_requests"]
    peak = common.memory_peak(dev)
    failed = sum(out.shape != (size, hor, m["num_nodes"], m["output_dim"])
                 or not np.isfinite(out).all() for _, out in done)
    del predictor
    common.free(dev)

    quantities = {"serve_windows_per_s": n * size / window_s,
                  "setup_s": setup_s}
    if failed:  # a malformed forecast: nothing to compare
        return common.Outcome(quantities, n, failed,
                              {"out_err": check.NOT_COMPARED}, peak, tr_)
    pick = np.random.default_rng(data.seed_stream(a.seed, 5)).choice(
        n, size=min(tr["check_requests"], n), replace=False)
    pick = sorted(set(pick.tolist()) | {n - 1})
    x_raw = [np.ascontiguousarray(xw[done[i][0]:done[i][0] + size])
             for i in pick]
    y_cov = [np.ascontiguousarray(cw[done[i][0] + his:
                                     done[i][0] + his + size]) for i in pick]
    outs = [torch.from_numpy(done[i][1]) for i in pick]

    def forecasts(mode):
        return [reference_forecasts(init, m, xr, yc, mean, std, supports,
                                    dev, mode).cpu()
                for xr, yc in zip(x_raw, y_cov)]

    want = forecasts("float32")
    readings = {"out_err": check.out_err(outs, want)}
    control = ({"out_err": check.out_err(forecasts("tf32"), want)}
               if a.control else None)
    return common.Outcome(quantities, n, failed, readings, peak, tr_, layer,
                          control)
