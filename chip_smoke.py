"""Drive the PyTorch/CUDA port (megacrn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs a card

Phases (any failure exits nonzero; nothing is caught and skipped):

1. Device: require CUDA, print the card's name and power limit, pin TF32 off.
2. Build the port's CUDA kernels (block-COO and block-ELL SpMM) from
   ``megacrn_tpu_torch/kernels/csrc`` with one nvcc each, all at once; print
   the build seconds and ptxas reports.
3. Each kernel against its plain PyTorch version on the card, in f32 and
   bf16, at edge shapes (long rows among them) and at the shapes of the
   slices' paths, with device times (CUDA events, the card held by a spin
   kernel while the host enqueues) and the wrappers' host times, the bound
   from the bytes and operations the nonzeros need, and a one-call library
   yardstick, a sparse CSR product (timed only; the port never calls it);
   the kernels on the transposed packs, as the backward runs them; and the
   backward of both autograd Functions against autograd through the plain
   versions.
4. The serving path: the EXPY-TKY preset MegaCRN (N=1843, 6->6, batch 64) on
   the road_sparse backend over the synthetic road graph, weights from a
   seed, written as a JAX-format checkpoint and served through
   ``Predictor.from_checkpoint``. Three requests (1, 64, 100 windows), the
   kernel launch count checked per chunk, forecasts checked against the
   same model on the plain SpMM, and a small model checked against the CPU.
5. Streaming: ``StreamingForecaster`` answers once its window is warm.
6. Dense branch: the METR-LA preset (learned meta-graph, no kernel) served
   once and checked against the CPU.
7. The training slice: train steps of the same preset (batch 64, scheduled
   sampling, EXPY-TKY protocol with the clip at 5) through
   ``train.steps.make_train_step``,
   once with the block-COO ``StackedRoadPack`` and once with block-ELL
   pairs: finite losses, kernel launches per step (forward and backward)
   against counts derived from the config, gradients against the same step
   on the plain versions, ms per step and one profiled step.

The last three lines: a JSON line of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM3 bandwidth, FP32 on the CUDA cores
# (TF32 is off here) and bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# Cycles of the spin kernel that holds the device while the host enqueues
# timed calls: about 25 ms at the H100's 1.98 GHz boost clock.
HOLD_CYCLES = 50_000_000
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
# Gradients of one train step, kernel path against plain path: f32, only
# the summation order differs (per array: rtol, atol relative to max|g|).
GRAD_TOL = (1e-4, 1e-5)


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, iters=10, warmup=2):
    """(device ms, host ms) per call over ``iters`` calls, after warm-up.

    A spin kernel enqueued first holds the device while the host enqueues
    the calls, so the CUDA events around them time the device's work alone
    and not the host's launch rate (a kernel of a few tens of microseconds
    takes less time on the card than its Python wrapper takes on the host).
    The hold doubles until the host is done before the device starts the
    first call. The host clock around the enqueue gives the host's ms per
    call."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES << attempt)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / iters
        held = not start.query()  # the device has not reached the calls yet
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / iters, host_ms
    require(False, "the spin kernel never outlasted the host's enqueue")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def slice_widths(cfg, batch):
    """{role: (f, forward launches, backward launches)} of one SpMM pack
    (the stacked COO pack, or one support's block-ELL pack) in one train
    step of a one-layer model (nn/cell.py): each cell step aggregates its
    gate input [x || h] and its candidate input, each through (cheb_k - 1)
    launches, at the feature width f = batch * channels. The backward
    launches once per forward launch but for the first encoder step's
    [x || h] aggregation: the input and the zero state need no gradient."""
    require(cfg.num_layers == 1, "slice_widths counts a one-layer model")
    lev = cfg.cheb_k - 1
    enc, dec = cfg.seq_len * lev, cfg.horizon * lev
    return {"enc_gate": (batch * (cfg.input_dim + cfg.rnn_units), enc,
                         enc - lev),
            "enc_cand": (batch * cfg.rnn_units, enc, enc),
            "dec_gate": (batch * (cfg.output_dim + cfg.ycov_dim
                                  + cfg.decoder_dim), dec, dec),
            "dec_cand": (batch * cfg.decoder_dim, dec, dec)}


def launches_per_step(cfg, kind, batch):
    """(forward, backward) kernel launches of one train step: the sums of
    ``slice_widths``, once for the stacked COO pack, which takes all
    supports at once, and once per support for block-ELL."""
    packs = 1 if kind == "stacked_coo" else cfg.num_supports
    widths = slice_widths(cfg, batch).values()
    return (packs * sum(n for _, n, _ in widths),
            packs * sum(n for _, _, n in widths))


def reset_launches(*kernels):
    for k in kernels:
        k.launches = 0


def read_launches(*kernels):
    """{kernel name: launches since the last reset}."""
    return {kernel_name(k): k.launches for k in kernels}


def kernel_name(kernel):
    """The name of the kernel a wrapper launches (its CUDA source)."""
    return {"spmm_coo": "spmm_coo", "spmm": "spmm_ell"}[kernel.__name__]


def spmm_bound(pack, f, dtype):
    """(bound_ms, bound_by) of y = A @ x for a BlockCOO or BlockELL pack,
    counted from what this run's matrix needs: its nonzeros (a value and a
    4-byte column each) and row pointers read once, the rows of x that a
    nonzero references read once, y written once, and 2*f flops a nonzero.
    The stored 128x128 tiles are not counted: their zeros, and block-ELL's
    padding tiles, are no work the function needs; nor are rows of x that
    no nonzero references (the stacked pack's per-support padding)."""
    es = torch.tensor([], dtype=dtype).element_size()
    nnz = pack.nz_vals.numel()
    x_rows = torch.unique(pack.nz_cols).numel()
    flops = 2.0 * nnz * f
    nbytes = (nnz * (es + 4) + 4 * pack.nz_row_ptr.numel()
              + x_rows * f * es + pack.n_orig * f * es)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def csr_of(pack):
    """The matrix a BlockCOO or BlockELL pack holds, as a torch sparse CSR
    tensor of its original dims (the library yardstick's input), from the
    pack's nonzero list; ``check_spmm`` holds its product against the plain
    version, which reads the tiles."""
    return torch.sparse_csr_tensor(
        pack.nz_row_ptr[:pack.n_orig + 1].long(), pack.nz_cols.long(),
        pack.nz_vals, size=(pack.n_orig, pack.col_dim_orig),
        check_invariants=True)


def check_spmm(kernel, plain, name, pack, x, csr):
    """Kernel vs plain version on one input; returns a result dict.
    ``csr``: A as a sparse CSR tensor for the library yardstick, one
    ``csr @ x`` (cuSPARSE), checked against the plain version too."""
    got = kernel(pack, x)
    want = plain(pack, x)
    lib = csr @ x
    torch.cuda.synchronize()
    rtol, atol_rel = TOL[x.dtype]
    g, w = got.float(), want.float()
    kname = kernel_name(kernel)
    require(g.shape == w.shape and torch.isfinite(g).all().item(),
            f"{kname} {name}: bad shape or non-finite output")
    err = (g - w).abs()
    atol = atol_rel * w.abs().max().item()
    ok = bool((err <= atol + rtol * w.abs()).all().item())
    res = {"name": name, "dtype": str(x.dtype).replace("torch.", ""),
           "f": x.shape[1], "max_abs_err": err.max().item(),
           "library_max_abs_err": (lib.float() - w).abs().max().item(),
           "tol": f"rtol {rtol:g}, atol {atol_rel:g}*max|y|"}
    require(ok, f"{kname} {name} {res['dtype']}: kernel disagrees with "
                f"the plain version, max abs err {res['max_abs_err']:.3e}")
    lib_ok = lib.shape == w.shape and (
        x.dtype != torch.float32 or bool(
            ((lib - w).abs() <= atol + rtol * w.abs()).all().item()))
    require(lib_ok, f"library yardstick {name}: computes another function "
                    f"(max abs err {res['library_max_abs_err']:.3e})")
    res["ms"], res["host_ms"] = cuda_ms(lambda: kernel(pack, x))
    res["plain_ms"] = cuda_ms(lambda: plain(pack, x))[0]
    res["library_ms"] = cuda_ms(lambda: csr @ x)[0]
    res["bound_ms"], res["bound_by"] = spmm_bound(pack, x.shape[1], x.dtype)
    # What the kernel gathers per nonzero (a row slab of x, mostly from L2),
    # over its device time: the rate that holds it above its bound.
    res["gather_TB_per_s"] = (pack.nz_vals.numel() * x.shape[1]
                              * x.element_size() / res["ms"] / 1e9)
    print(kname, json.dumps(res))
    return res


def edge_cases(to_pack):
    """(name, pack, x) at the shapes the CPU tests also cover: an empty
    row-block, a rectangular pack, a hub row-block (block-ELL pads the
    others), f = 6, 7, 19 (the kernels' scalar path), and rows of 110 and
    120 nonzeros (more than three of the kernels' 32-entry chunks) at
    f = 40 (their 16-byte path)."""
    cases = []
    for name, seed, (r, c), f in (("empty_row_block", 0, (300, 300), 6),
                                  ("rectangular", 2, (96, 384), 7),
                                  ("f19", 8, (300, 300), 19),
                                  ("hub_row", 3, (300, 300), 19),
                                  ("long_row", 4, (300, 300), 40)):
        rs = np.random.RandomState(seed)
        a = ((rs.rand(r, c) < 0.04) * rs.randn(r, c)).astype(np.float32)
        if name == "empty_row_block":
            a[128:256] = 0.0
        if name == "hub_row":
            a[128:] = 0.0
            a[200:, 200:] = ((rs.rand(100, 100) < 0.05)
                             * rs.randn(100, 100))
        if name == "long_row":
            a[5, rs.choice(c, 120, replace=False)] = rs.randn(120)
            a[rs.choice(r, 110, replace=False), 7] = rs.randn(110)
        cases.append((name, to_pack(a), rs.randn(c, f)))
    return cases


def time_packs(kernel, plain, packs, widths, dev, gen, dtype, tag):
    """Kernel vs plain (and the library call) on each pack at each slice
    width; returns totals over one train step's launches: forward (``ms``,
    ``plain_ms``, ``library_ms``, ``bound_ms``, and ``host_ms``, the
    wrapper's host time, per forward) and, for the transposed packs, the
    backward's kernel ms and bound ms."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "host_ms": 0.0, "max_abs_err": 0.0, "backward_ms": 0.0,
           "backward_bound_ms": 0.0}
    for i, (pack, pack_t) in enumerate(packs):
        pack, pack_t = pack.to(dev, dtype), pack_t.to(dev, dtype)
        csr = csr_of(pack)
        for role, (f, n_fwd, n_bwd) in widths.items():
            x = torch.randn((pack.col_dim_orig, f), generator=gen,
                            device=dev, dtype=torch.float32).to(dtype)
            res = check_spmm(kernel, plain, f"{tag}{i}_{role}", pack, x, csr)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms", "host_ms"):
                tot[k] += n_fwd * res[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
            tot["bound_by"] = res["bound_by"]
            if dtype == torch.float32:  # the backward's launches, on A^T
                g = torch.randn((pack_t.col_dim_orig, f), generator=gen,
                                device=dev)
                bwd_ms = cuda_ms(lambda: kernel(pack_t, g))[0]
                tot["backward_ms"] += n_bwd * bwd_ms
                tot["backward_bound_ms"] += n_bwd * spmm_bound(
                    pack_t, f, dtype)[0]
                print(f"{kernel_name(kernel)} {tag}{i}_{role} transposed pack "
                      f"(backward): {bwd_ms:.4f} ms per launch")
        del csr
    return tot


def phase_kernels(sp, se, stacked, pairs, cfg, batch, dev):
    """Phase 3; returns the JSON entries of spmm_coo and spmm_ell
    (launches filled later)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for kernel, plain, to_pack in (
                (sp.spmm_coo, sp.spmm_coo_reference, sp.to_block_coo),
                (se.spmm, se.spmm_reference, se.to_block_ell)):
            for name, pack, x in edge_cases(to_pack):
                pack = pack.to(dev, dtype)
                check_spmm(kernel, plain, name, pack,
                           torch.from_numpy(x).to(dev, dtype),
                           csr=csr_of(pack))
    print(f"slice pack: {stacked.pack.nz_vals.numel()} nonzeros in "
          f"{stacked.pack.data.shape[0]} stored 128x128 tiles")
    widths = slice_widths(cfg, batch)
    entries = {}
    for kernel, plain, packs, kind in (
            (sp.spmm_coo, sp.spmm_coo_reference,
             [(stacked.pack, stacked.pack_t)], "stacked_coo"),
            (se.spmm, se.spmm_reference, pairs, "block_ell")):
        n_fwd, n_bwd = launches_per_step(cfg, kind, batch)
        per_forward = {}
        for dtype in (torch.float32, torch.bfloat16):
            tot = time_packs(kernel, plain, packs, widths, dev, gen, dtype,
                             "slice_s" if kind == "block_ell" else "slice_")
            per_forward[dtype] = tot
            print(f"{kernel_name(kernel)} per batch-{batch} forward "
                  f"({str(dtype)[6:]}, {n_fwd} launches; backward {n_bwd} "
                  f"launches): "
                  + json.dumps(tot))
            print(f"{kernel_name(kernel)} ({str(dtype)[6:]}) share of its "
                  f"bound per forward: {tot['bound_ms'] / tot['ms']:.4f} "
                  f"(bound {tot['bound_ms']:.4f} ms, {tot['bound_by']}; "
                  f"kernel {tot['ms']:.4f} ms; library "
                  f"{tot['library_ms']:.4f} ms; the wrapper's host time "
                  f"{tot['host_ms']:.4f} ms)")
        f32 = per_forward[torch.float32]
        entries[kind] = {
            "name": kernel_name(kernel),
            "route": "cuda",
            "source": ("megacrn_tpu_torch/kernels/csrc/spmm_coo.cu"
                       if kind == "stacked_coo" else
                       "megacrn_tpu_torch/kernels/csrc/spmm_ell.cu"),
            "replaces": ("megacrn_tpu/kernels/spmm_coo.py:180"
                         if kind == "stacked_coo" else
                         "megacrn_tpu/kernels/spmm.py:209"),
            "launches": None, "max_abs_err": f32["max_abs_err"],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "bound_share": f32["bound_ms"] / f32["ms"],
            "library_ms": f32["library_ms"],
            "backward_ms": f32["backward_ms"],
            "backward_bound_ms": f32["backward_bound_ms"],
            "host_ms": f32["host_ms"],
            "bf16_ms": per_forward[torch.bfloat16]["ms"],
            "bf16_bound_ms": per_forward[torch.bfloat16]["bound_ms"]}
    return entries["stacked_coo"], entries["block_ell"]


def phase_backward(sp, se, stacked, pairs, cfg, batch, dev):
    """dx of both kernels' autograd Functions (one launch each on the
    transposed pack) against autograd through the plain versions, at the
    encoder gate's width, f32."""
    f = slice_widths(cfg, batch)["enc_gate"][0]
    gen = torch.Generator(device=dev).manual_seed(3)
    a_coo = (stacked.pack.to(dev), stacked.pack_t.to(dev))
    a_ell = tuple(p.to(dev) for p in pairs[0])
    for name, fn, plain, counter, (a, a_t) in (
            ("spmm_coo", sp.SpmmCOOFunction, sp.spmm_coo_reference,
             sp.spmm_coo, a_coo),
            ("spmm_ell", se.SpmmELLFunction, se.spmm_reference, se.spmm,
             a_ell)):
        x = torch.randn((a.col_dim_orig, f), generator=gen, device=dev)
        g = torch.randn((a.n_orig, f), generator=gen, device=dev)
        x1 = x.clone().requires_grad_()
        y = fn.apply(x1, a, a_t)
        before = counter.launches
        y.backward(g)
        require(counter.launches == before + 1,
                f"{name} backward: {counter.launches - before} launches")
        x2 = x.clone().requires_grad_()
        plain(a, x2).backward(g)
        torch.cuda.synchronize()
        w = x2.grad
        err = (x1.grad - w).abs()
        rtol, atol_rel = TOL[torch.float32]
        require(bool((err <= atol_rel * w.abs().max() + rtol * w.abs())
                     .all().item()),
                f"{name} backward: dx disagrees with autograd through the "
                f"plain version, max abs err {err.max().item():.3e}")
        print(f"{name} backward (autograd Function, f={f}, f32): dx vs "
              f"plain autograd max abs err {err.max().item():.3e} (rtol "
              f"{rtol:g}, atol {atol_rel:g}*max|dx|)")


def requests(rs, b, cfg):
    """Raw speeds in [0, 70] with 2% missing readings (exact zeros)."""
    x = rs.uniform(0.0, 70.0, (b, cfg.seq_len, cfg.num_nodes, 1))
    x[rs.rand(*x.shape) < 0.02] = 0.0
    return x.astype(np.float32)


def close(got, want, std, what):
    err = np.abs(got - want)
    ok = bool((err <= 1e-4 * std + 1e-4 * np.abs(want)).all())
    require(ok, f"{what}: max abs err {err.max():.3e} over atol "
                f"{1e-4 * std:.1e} + rtol 1e-4")
    return float(err.max())


def phase_slice(sp, se, stacked, cfg, batch):
    """Phase 4 and 5; returns {kernel name: launches} of the serving
    path."""
    from megacrn_tpu_torch.interop import flat_from_state_dict
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.serve import Predictor, StreamingForecaster
    from megacrn_tpu_torch.train.checkpoint import save_checkpoint

    mean, std = 45.0, 15.0
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "megacrn_expytky.npz")
        save_checkpoint(path, flat_from_state_dict(model.state_dict(),
                                                   cfg.num_layers),
                        metadata={"scaler_mean": mean, "scaler_std": std})
        pred = Predictor.from_checkpoint(path, cfg, max_batch=64,
                                         road_supports=stacked)
    require(pred.device.type == "cuda", "the Predictor is not on the card")
    plain = Predictor(pred.model, cfg, mean, std, 64,
                      road_supports=stacked._replace(impl="reference"))
    rs = np.random.RandomState(0)
    reqs = [requests(rs, b, cfg) for b in (1, 64, 100)]
    pred.predict(reqs[1])  # warm-up: library load, allocator, cuBLAS
    torch.cuda.synchronize()

    reset_launches(sp.spmm_coo, se.spmm)  # --- the serving path, counted ---
    outs, per_req = [], []
    for x in reqs:
        before = sp.spmm_coo.launches
        outs.append(pred.predict(x))
        per_req.append(sp.spmm_coo.launches - before)
    launches = read_launches(sp.spmm_coo, se.spmm)  # --- read just after ---
    require(launches["spmm_ell"] == 0,
            "the serving path on the StackedRoadPack launched spmm_ell")

    fwd, _ = launches_per_step(cfg, "stacked_coo", batch)
    for x, out, n in zip(reqs, outs, per_req):
        b = x.shape[0]
        chunks = -(-b // 64)
        require(out.shape == (b, cfg.horizon, cfg.num_nodes, 1),
                f"request of {b}: output shape {out.shape}")
        require(np.isfinite(out).all(), f"request of {b}: non-finite")
        require(n == fwd * chunks, f"request of {b}: {n} spmm_coo launches,"
                                   f" expected {fwd} x {chunks} chunks")
        err = close(out, plain.predict(x), std,
                    f"request of {b} vs plain SpMM")
        print(f"slice request of {b} windows: {chunks} chunk(s), {n} "
              f"spmm_coo launches, max abs err vs plain {err:.3e}")

    def chunk_ms(p, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            p.predict(reqs[1])  # ends in a device-to-host copy
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    ms, plain_ms = chunk_ms(pred), chunk_ms(plain)
    print(f"slice Predictor: {ms:.3f} ms per 64-window chunk "
          f"({64e3 / ms:.1f} windows/s); plain SpMM path {plain_ms:.3f} ms "
          f"(host clock, median of 5)")
    profile("one chunk", lambda: pred.predict(reqs[1]), ms)

    stream = StreamingForecaster(pred)
    obs = requests(rs, 1, cfg)[0, :, :, 0]
    extra = requests(rs, 1, cfg)[0, 0, :, 0]
    got = [stream.push(o) for o in list(obs) + [extra]]
    require(all(g is None for g in got[:cfg.seq_len - 1]),
            "streaming answered before its window was warm")
    for g in got[cfg.seq_len - 1:]:
        require(g is not None and g.shape == (cfg.horizon, cfg.num_nodes, 1)
                and np.isfinite(g).all(), "streaming forecast is wrong")
    print(f"streaming: warm after {cfg.seq_len} pushes, "
          f"{len(got) - cfg.seq_len + 1} forecasts")
    return launches


def profile(what, fn, unprofiled_ms):
    """Where one call's device time goes: kernel time by name from
    torch.profiler, and the device's idle share, both of the profiled
    call's wall time (which the profiler's own overhead inflates) and of
    ``unprofiled_ms``, the same call's time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not count:
        print(f"profile of {what}: the profiler saw no device time "
              f"(not measured)")
        return
    print(f"profile of {what}: {count} device kernels, busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms profiled wall, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; of the unprofiled "
          f"{unprofiled_ms:.3f} ms, idle share "
          f"{1 - busy_ms / unprofiled_ms:.4f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t:9.3f} ms  {100 * t / busy_ms:5.1f}%  {name[:90]}")
    # The same device time by the operator that launched it (a kernel name
    # such as elementwise_kernel serves many operators).
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:10]:
        t = e.self_device_time_total / 1e3
        print(f"  op {t:9.3f} ms  {100 * t / busy_ms:5.1f}%  {e.count:5d} "
              f"calls  {e.key[:60]}")


def phase_small_vs_cpu(dev):
    """A small road_sparse model and the dense METR-LA preset on the card,
    each against the same weights on the CPU."""
    from megacrn_tpu_torch.config import MegaCRNConfig, model_config_for
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
    from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
    from megacrn_tpu_torch.serve import Predictor

    small = MegaCRNConfig(num_nodes=300, rnn_units=8, mem_num=4, mem_dim=8,
                          horizon=3, seq_len=3, graph_backend="road_sparse")
    pack = build_stacked_road_pack(list(dual_random_walk_supports(
        synthetic_road_adjacency(300, avg_degree=8, seed=1))))
    metrla = model_config_for("METRLA")
    rs = np.random.RandomState(1)
    for name, cfg, sup, b in (("small road_sparse", small, pack, 5),
                              ("METR-LA dense", metrla, None, 8)):
        model = MegaCRN(cfg, generator=torch.Generator().manual_seed(2),
                        device="cpu")
        on_cpu = Predictor(model, cfg, 50.0, 10.0, 8, road_supports=sup,
                           device="cpu")
        x = requests(rs, b, cfg)
        want = on_cpu.predict(x)
        on_card = Predictor(copy.deepcopy(model), cfg, 50.0, 10.0, 8,
                            road_supports=sup, device=dev)
        got = on_card.predict(x)
        require(got.shape == (b, cfg.horizon, cfg.num_nodes, 1)
                and np.isfinite(got).all(), f"{name}: bad forecast")
        err = close(got, want, 10.0, f"{name} card vs CPU")
        print(f"{name}: card vs CPU on the same weights, max abs err "
              f"{err:.3e}")


def train_batches(cfg, batch, dev, n=2, seed=0):
    """Normalised (x, y, y_cov) batches on the card, from a seeded
    RandomState, with 2% exact zeros in the targets."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (requests(rs, batch, cfg) - 45.0) / 15.0
        y = (rs.uniform(0.0, 70.0, (batch, cfg.horizon, cfg.num_nodes, 1))
             - 45.0) / 15.0
        y[rs.rand(*y.shape) < 0.02] = 0.0
        yc = rs.uniform(0.0, 1.0, (batch, cfg.horizon, cfg.num_nodes, 1))
        out.append(tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                         for a in (x, y, yc)))
    return out


def _plain(road_supports):
    """The same graph constant on the plain SpMM versions."""
    if isinstance(road_supports, list):
        return [(a._replace(impl="reference"), a_t._replace(impl="reference"))
                for a, a_t in road_supports]
    return road_supports._replace(impl="reference")


def phase_train(sp, se, cfg, tcfg, constants, dev):
    """Phase 7: the training slice on each graph constant. Returns
    {kind: {"launches": {kernel name: launches in 5 steps}, "fwd", "bwd",
    "ms", "plain_ms"}}."""
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.train.optim import make_optimizer
    from megacrn_tpu_torch.train.steps import make_loss_fn, make_train_step

    require(cfg.use_curriculum_learning, "curriculum learning is off")
    require(tcfg.max_grad_norm is not None, "the clip is off")
    batches = train_batches(cfg, tcfg.batch_size, dev)
    counters = {"stacked_coo": sp.spmm_coo, "block_ell": se.spmm}
    # Threshold ~0.5: the decoder feeds the label at about half its steps.
    bs0 = float(cfg.cl_decay_steps * np.log(cfg.cl_decay_steps))
    results = {}
    for kind, const in constants.items():
        counter = counters[kind]
        others = [c for k, c in counters.items() if k != kind]
        want_fwd, want_bwd = launches_per_step(cfg, kind, tcfg.batch_size)
        base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)

        # One step's forward and backward launches, and its gradients
        # against the same step on the plain versions (same weights, batch
        # and teacher-forcing mask: the generators share a seed).
        grads, losses = [], []
        for sup in (const, _plain(const)):
            model = copy.deepcopy(base)
            loss_fn = make_loss_fn(model, tcfg, road_supports=sup)
            reset_launches(*counters.values())
            loss = loss_fn(*batches[0], bs0,
                           torch.Generator(device=dev).manual_seed(1))
            fwd = counter.launches
            loss.backward()
            bwd = counter.launches - fwd
            if sup is const:
                require((fwd, bwd) == (want_fwd, want_bwd),
                        f"{kind}: {fwd} forward and {bwd} backward "
                        f"{kernel_name(counter)} launches in a step, expected "
                        f"{want_fwd} and {want_bwd}")
                require(all(c.launches == 0 for c in others),
                        f"{kind}: another kernel was launched")
            else:
                require(counter.launches == 0,
                        f"{kind}: the plain path launched the kernel")
            losses.append(loss.item())
            grads.append({k: p.grad for k, p in model.named_parameters()})
        worst = 0.0
        for k, g in grads[0].items():
            w = grads[1][k]
            require((g is None) == (w is None), f"{kind}: grad of {k}")
            if g is None:
                continue
            rtol, atol_rel = GRAD_TOL
            err = (g - w).abs()
            require(bool(torch.isfinite(g).all().item()) and bool(
                (err <= atol_rel * w.abs().max() + rtol * w.abs())
                .all().item()),
                f"{kind}: grad of {k} disagrees with the plain step, max "
                f"abs err {err.max().item():.3e}")
            worst = max(worst, (err / w.abs().max()).max().item())
        require(abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1]),
                f"{kind}: loss {losses[0]} vs plain {losses[1]}")
        print(f"train {kind}: one step, {want_fwd} forward + {want_bwd} "
              f"backward {kernel_name(counter)} launches (derived from the "
              f"config); loss {losses[0]:.6f} vs plain {losses[1]:.6f}; "
              f"grads vs plain step: max |err|/max|g| {worst:.3e} (rtol "
              f"{GRAD_TOL[0]:g}, atol {GRAD_TOL[1]:g}*max|g| per array)")
        del grads

        def steps(sup, seed):
            model = copy.deepcopy(base)
            return make_train_step(
                model, tcfg, make_optimizer(model.parameters(), tcfg),
                torch.Generator(device=dev).manual_seed(seed),
                road_supports=sup)

        def run(step, n, first):
            times, losses = [], []
            for i in range(n):
                t0 = time.perf_counter()
                loss = step(*batches[i % len(batches)], bs0 + first + i)
                losses.append(loss.item())  # ends the step on the host
                times.append(1e3 * (time.perf_counter() - t0))
            require(np.isfinite(losses).all(),
                    f"{kind}: non-finite loss {losses}")
            return float(np.median(times)), losses

        torch.cuda.reset_peak_memory_stats()
        step = steps(const, 2)
        run(step, 2, 0)  # warm-up
        reset_launches(*counters.values())  # --- this path, counted ---
        ms, kernel_losses = run(step, 5, 2)
        launches = read_launches(*counters.values())  # --- read just after ---
        n = launches[kernel_name(counter)]
        require(n == 5 * (want_fwd + want_bwd),
                f"{kind}: {n} {kernel_name(counter)} launches in 5 steps, "
                f"expected 5 x ({want_fwd} + {want_bwd})")
        require(sum(launches.values()) == n,
                f"{kind}: another kernel was launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_step = steps(_plain(const), 2)
        run(plain_step, 2, 0)
        plain_ms, _ = run(plain_step, 5, 2)
        print(f"train {kind}: losses {[round(v, 6) for v in kernel_losses]};"
              f" {ms:.3f} ms per train step, plain SpMM {plain_ms:.3f} ms "
              f"(host clock to loss.item(), median of 5); launches in 5 "
              f"steps {launches}; peak device "
              f"memory {peak:.2f} GiB")
        profile(f"one {kind} train step",
                lambda: step(*batches[0], bs0).item(), ms)
        results[kind] = {"launches": launches, "fwd": want_fwd,
                         "bwd": want_bwd, "ms": ms, "plain_ms": plain_ms}
    return results


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAIL: torch.cuda.is_available() is "
                         "false; this script needs a CUDA card")
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    sys.path.insert(0, ROOT)
    from megacrn_tpu_torch.config import model_config_for, train_config_for
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
    from megacrn_tpu_torch.kernels import _build
    from megacrn_tpu_torch.kernels import spmm as se
    from megacrn_tpu_torch.kernels import spmm_coo as sp
    from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

    t0 = time.perf_counter()
    built = _build.build_many(["spmm_coo", "spmm_ell"])
    print(f"build: {time.perf_counter() - t0:.2f} s for both kernels, one "
          f"nvcc each, in parallel")
    for name, (secs, log) in built.items():
        print(f"  {name}: {secs:.2f} s{'' if log else ' (already built)'}")
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "spill" in line):
                print(f"    {line.strip()}")

    # The EXPY-TKY preset over the synthetic stand-in of its road graph, as
    # the JAX CLI builds it for --dataset SYNTH.
    cfg = model_config_for("EXPYTKY", graph_backend="road_sparse")
    # The EXPY-TKY protocol (Adam eps 1e-8, L1 on the normalised scale,
    # batch 64) with the clip at 5, the METR-LA protocol's norm: the
    # EXPY-TKY preset clips nothing, and each step here runs the clip.
    tcfg = train_config_for("EXPYTKY", max_grad_norm=5.0)
    sups = list(dual_random_walk_supports(
        synthetic_road_adjacency(cfg.num_nodes, avg_degree=8, seed=0)))
    stacked = sp.build_stacked_road_pack(sups)
    pairs = se.build_road_ell_pairs(sups)
    print(f"slice packs: block-COO {stacked.pack.data.shape[0]} tiles over "
          f"{stacked.pack.n // 128} row blocks, n_pad {stacked.n_pad}; "
          f"block-ELL per support {tuple(pairs[0][0].cols.shape)} "
          f"(row blocks, max_blocks), nnz_blocks "
          f"{[int(a.nnz_blocks.sum()) for a, _ in pairs]}")

    coo, ell = phase_kernels(sp, se, stacked, pairs, cfg, tcfg.batch_size,
                             dev)
    phase_backward(sp, se, stacked, pairs, cfg, tcfg.batch_size, dev)
    serving = phase_slice(sp, se, stacked, cfg, tcfg.batch_size)
    require(serving["spmm_coo"] > 0, "the serving path launched no spmm_coo")
    phase_small_vs_cpu(dev)
    train = phase_train(sp, se, cfg, tcfg, {"stacked_coo": stacked,
                                            "block_ell": pairs}, dev)
    # Each path's counts as read just after it (measured, zeros included).
    by_path = {"serving_3_requests": serving,
               "train_stacked_coo_5_steps": train["stacked_coo"]["launches"],
               "train_block_ell_5_steps": train["block_ell"]["launches"]}
    for entry, kind in ((coo, "stacked_coo"), (ell, "block_ell")):
        res = train[kind]
        name = entry["name"]
        require(res["launches"][name] > 0,
                f"the {kind} train path launched no {name}")
        entry["launches"] = res["launches"][name]
        entry["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        entry["train_step_forward_launches"] = res["fwd"]
        entry["train_step_backward_launches"] = res["bwd"]
        entry["train_step_ms"] = res["ms"]
        entry["train_step_plain_ms"] = res["plain_ms"]

    print(json.dumps({"kernels": [coo, ell]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
