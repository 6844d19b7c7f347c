"""Training traffic: back-to-back train steps of the configuration's batch,
fed as the program's ``fit`` feeds them (its ``BatchLoader`` reshuffled
each epoch, a pinned, non-blocking upload), the losses kept on the card
until the window ends.

Set-up makes the month's windows and the weights from the seed, builds the
one train step (model and optimizer state) and drives it through its first
``check_steps`` steps, whose losses, first gradient and change the
reference follows after the window; that same step then runs the window.
The traced span is ``trace_steps`` more steps after it.
"""
from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import check, common, data, trace, weights
from portbench.harness.program import Program
from portbench.reference import megacrn as ref

BETA1 = 0.9  # Adam's, the program's default and the reference's


def _windows(speeds, cov, mean, std, his, hor):
    norm = ((speeds - mean) / std).astype(np.float32)
    count = len(speeds) - his - hor + 1
    x = np.ascontiguousarray(data.windows(norm[..., None], his)[:count])
    yv = np.stack([norm, cov], axis=-1)
    y = np.ascontiguousarray(data.windows(yv[his:], hor)[:count])
    return x, y


# Leaves whose gradients the few-leaf faults change before the update.
FEW_LEAVES = ("memory.Wq", "memory.Memory")
TURNED_LEAF = "decoder.dcrnn_cells.0.gate.weights"


def _plant(fault, step, opt, model):
    """The program with a fault planted: the step leaves its state as it
    was, trains on half of each batch, scales two leaves' gradients, or
    turns one leaf's gradient around (its norm unchanged)."""
    if fault is None:
        return step
    if fault == "state_unchanged":
        opt.step = lambda *a, **k: None
        return step
    if fault == "half_batch":
        def half(x, y, y_cov, batches_seen):
            b = x.shape[0] // 2
            return step(x[:b], y[:b], y_cov[:b], batches_seen)
        return half
    factors = {"few_leaves": dict.fromkeys(FEW_LEAVES, 1.5),
               "wrong_direction": {TURNED_LEAF: -1.0}}
    if fault not in factors:
        raise ValueError(f"unknown fault {fault!r}")
    params = dict(model.named_parameters())
    changed = [(params[k], f) for k, f in factors[fault].items()]
    update = opt.step

    def changed_update(*a, **k):
        for p, f in changed:
            p.grad.mul_(f)
        return update(*a, **k)

    opt.step = changed_update
    return step


def run(a: common.RunArgs) -> common.Outcome:
    cfg, tr, dev = a.cell.config, a.cell.traffic, a.device
    m = cfg["model"]
    sync = common.synchronizer(dev)
    prog = Program(cfg, dev)
    speeds, cov = data.month(cfg, tr, a.seed)
    mean, std = float(speeds.mean()), float(speeds.std())
    x, y = _windows(speeds, cov, mean, std, m["seq_len"], m["horizon"])
    supports = data.graph_supports(cfg)
    pack = prog.graph_constant(supports)
    init = weights.make(cfg, data.seed_stream(a.seed, 1), dev)
    model = prog.model(init)
    sampling_seed = data.seed_stream(a.seed, 2)
    step, opt = prog.train_step(model, sampling_seed, mean, std, pack)
    step = _plant(a.fault, step, opt, model)
    batches = prog.loader(x, y, data.seed_stream(a.seed, 3))
    names = [k for k, _ in model.named_parameters()]

    kept, losses0 = [], []
    for i in range(tr["check_steps"]):
        arrays = next(batches)
        kept.append(tuple(np.array(v) for v in arrays))
        losses0.append(step(*prog.upload(arrays), i))
        if i == 0:
            grad = {}
            for k, p in model.named_parameters():
                st = opt.state.get(p, {})
                grad[k] = (float(torch.linalg.vector_norm(
                    st["exp_avg"].double())) / (1 - BETA1)
                    if "exp_avg" in st else 0.0)
    delta = {k: float(torch.linalg.vector_norm((p.detach() - init[k])
                                               .double()))
             for k, p in zip(names, model.parameters())}
    losses0 = [float(v) for v in losses0]  # synchronises
    bs = len(kept)
    losses = []

    def one():
        nonlocal bs
        arrays = next(batches)
        losses.append(step(*prog.upload(arrays), bs))
        bs += 1

    setup_s = time.perf_counter() - a.t_start
    n, window_s = common.window(a.seconds, one, sync)
    step_ms = 1e3 * window_s / n
    layer = {}
    tr_ = None
    if a.trace:
        def work():
            nonlocal bs
            for _ in range(tr["trace_steps"]):
                with record_function("loader"):
                    arrays = next(batches)
                with record_function("upload"):
                    xb = prog.upload(arrays)
                with record_function("train_step"):
                    losses.append(step(*xb, bs))
                bs += 1

        tr_ = trace.capture(work, sync, prog.spmm_launches)
        layer.update(span_units=tr["trace_steps"],
                     span_spmm_launches=tr_.counted)
    peak = common.memory_peak(dev)
    all_losses = torch.stack(losses).float().cpu()
    failed = int((~torch.isfinite(all_losses)).sum()) + sum(
        not np.isfinite(v) for v in losses0)
    del step, opt, model, pack, batches, losses
    common.free(dev)

    sup_t = None if supports is None else torch.from_numpy(supports).to(dev)
    dev_batches = [tuple(torch.from_numpy(v).to(dev) for v in b)
                   for b in kept]

    def reference(mode):
        with ref.precision(mode):
            out = ref.train_steps(
                init, m, cfg["train"], dev_batches,
                torch.Generator(device=dev).manual_seed(sampling_seed),
                sup_t, mean, std)
        out["init"] = init
        return out

    want = reference("float32")
    readings, layer["worst"] = check.train_readings(losses0, grad, delta,
                                                    want)
    layer["quiet_leaves"] = check.quiet_leaves(want["grad"])
    control = None
    if a.control:
        tf = reference("tf32")
        control, layer["control_worst"] = check.train_readings(
            tf["losses"], check.norms(tf["grad"]),
            check.norms({k: tf["params"][k] - init[k] for k in init}),
            want)
    return common.Outcome(
        {"train_step_ms": step_ms, "setup_s": setup_s},
        bs, failed,
        readings, peak, tr_, layer, control)
