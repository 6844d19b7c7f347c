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
   on the plain versions over 4 weight seeds x 2 batch seeds on each
   constant (per run the worst array and element against its limit, the
   first forward's smallest top-2 attention margins and triplet hinge), ms
   per step and one profiled step.
8. Fit (a), the main path at full width: ``cli.traintest.main`` in-process,
   ``--dataset EXPYTKY --graph_backend road_sparse --road_impl pallas
   --epochs 2 --seed 0`` over the synthetic EXPY-TKY months and a synthetic
   N=1843 road graph written as ``--adj_path`` (units 32, memory 10x32,
   batch 64): finite metrics for horizons 1-6, the ``spmm_coo`` launches of
   the whole run equal to the count derived from the loaders, sec/step of
   both epochs in metrics.jsonl, every artifact of the run dir.
9. Fit (b), the dense path: ``--dataset SYNTH`` at the METR-LA preset,
   ``--synth_steps 2000``, 1 epoch, ``--eval_aggregation concat``: no SpMM
   launch at all.
10. Fit (c), resume on the card: (b)'s run continued with ``--resume`` to 2
    epochs against an uninterrupted 2-epoch run of the same config; the
    largest param difference relative to max|p| must be <= 1e-5.

The graph backends with no hand-written kernel (plain PyTorch, as the JAX
package writes them in XLA), each path at the EXPY-TKY width, batch 64, f32:
train-step ms, device kernels, busy ms and idle share of one profiled step,
peak device memory, one served chunk's ms, and both kernels' counts (0):

11. Node-ELL: the bucketed pack (as built) and the flat one
    (``max_buckets=1``), loss and gradients held against the block-COO
    step's; ``_ell_apply`` unrolled and einsum at f = 2112 and 4224 against
    cuSPARSE on the same matrix; ``--road_impl auto`` against the two
    measured steps.
12. Node-ELL at N=16384, batch 8: the host's build seconds and the peak.
13. ``sparse_meta``: node (as built) held against block; block with and
    without remat; ``sddmm_node``, ``node_row_softmax``, ``spmm_node`` and
    ``spmm_blocks`` forward and backward against ``sampled_addmm``,
    ``torch.sparse.softmax`` and cuSPARSE.
14. Dense ``stacked`` against ``recursive`` at METR-LA and EXPY-TKY.
15. ``--remat`` on the block-COO path against the plain step; its
    ``spmm_coo`` launches counted with the backward's recomputation.
16. The traintest CLI for 1 epoch with ``--road_impl ell``,
    ``--graph_backend sparse_meta --sparse_meta_impl node`` and
    ``--dense_impl stacked``.

The two other model families, neither through a hand-written kernel (both
counts must read 0 on every path):

17. MegaCRNx at the reference defaults (METR-LA, N=207, 12->12, units 32,
    memory 10x32, embed 8, batch 64), stepwise and sequence decoders: 5
    train steps each (ms, device kernels, busy ms, idle share, peak) and a
    served chunk through ``MegaCRNxPredictor``; a small model on the card
    against the CPU; ``cli.traintest_megacrnx`` for 2 epochs on SYNTH at
    N=207.
18. GTS at the METR-LA width (N=207, units 64, diffusion 3, embedding 100,
    the 23,990-step training series that ``--synth_steps 34272`` gives):
    5 train steps with the curriculum and the Gumbel noise on, the graph
    learner's share of a forward, the sampled graphs' edges, a served chunk
    through ``GTSPredictor``; a small model on the card against the CPU
    (served, and a train-mode step's loss and gradients), noise off;
    ``cli.traintest_gts`` for 1 epoch at that width.

The mesh (``megacrn_tpu_torch/parallel``), its ranks spawned on the card
through ``parallel.launch`` over gloo (NCCL refuses two ranks on one GPU;
every collective of a CUDA tensor stages through pinned host memory), each
mesh step held against the single-device step on the card (losses rtol
1e-4, every state array within GRAD_TOL's form relative to its max|p|):

19. Two spawns. Two ranks, a (2, 1) mesh: (a) data parallel at the
    EXPY-TKY width through the block-COO kernel, 5 steps, its launches on
    each rank equal to the single-device step's; (c) MegaCRNx and GTS data
    parallel at the METR-LA width, 3 steps each (GTS with the Gumbel noise
    on, twice: in f64 against the unchanged whole-batch single-device
    step, and in f32 against the single-device step that sums the two half
    batches' shares as the mesh does, since its extractor's f32 gradients
    move by more than GRAD_TOL between summation orders; the f32
    whole-batch step's distance is printed). Six ranks, a (2, 3) mesh:
    (b) the node partition at the METR-LA width (69 nodes a rank), 3
    steps each on block-ELL packs (the kernel's launches non-zero on every
    rank), node-ELL flat and bucketed, dense, dense_ring, and
    ``sparse_meta`` node flat, node bucketed and block (each rank's rows
    of the learned edge pattern); (d) one epoch of ``cli.traintest`` with
    ``road_sparse`` and with ``dense_ring`` on that mesh, inside the
    group, their test metrics read from rank 0's run dir. Each step's ms
    and peak memory per rank, and the collectives (also a step) and their
    host staging, printed: correctness only (the ranks time-share the
    card).

The offline workflow and the host utilities:

20. (a) ``cli.generate_data --synthetic --num_nodes 207 --num_steps
    4000`` (the series is the depth: 44 train steps an epoch); (b)
    ``cli.traintest --dataset METRLA --data_dir <(a)> --graph_backend
    road_sparse --adj_path <N=207 synthetic road graph> --ckpt_backend
    orbax`` at the METR-LA width through the block-COO kernel, 2 epochs
    in one go, and 1 epoch then ``--resume`` for the 2nd: the resumed
    epoch-2 losses and final weights within RESUME_TOL of the
    uninterrupted run's, ``spmm_coo`` launched in each run, each
    checkpoint a torch.distributed.checkpoint directory; (c)
    ``cli.summary`` of MegaCRN, MegaCRNx and GTS at full width, their
    parameter counts; on fit (a)'s configuration (EXPY-TKY, the block-COO
    pack): (d) 20 train steps fed from the loader, plain and through
    ``train.prefetch.device_prefetch``, in turns, ms a step and the
    host's ms to get a batch, the batches equal both ways; (e) the host
    library (``data.native``, required to build) against numpy on fit
    (a)'s arrays, bit-equal, ms each; (f) the train step under
    ``train.debug.checkified``, finite (ms with and without) and with a
    NaN in x, which must raise naming the op.

The last lines: a JSON line of phases 11-16's paths, one of their ops,
one of the two families' paths (with phase 7's gradient holds), one of the
mesh, one of phase 20, one of the kernels, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
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


def cuda_ms(fn, iters=10, warmup=2, syncs=False):
    """(device ms, host ms) per call over ``iters`` calls, after warm-up.

    A spin kernel enqueued first holds the device while the host enqueues
    the calls, so the CUDA events around them time the device's work alone
    and not the host's launch rate (a kernel of a few tens of microseconds
    takes less time on the card than its Python wrapper takes on the host).
    The hold doubles until the host is done before the device starts the
    first call. The host clock around the enqueue gives the host's ms per
    call. ``syncs``: ``fn`` may wait for the card itself (a library call
    that reads a size back), so no hold can outlast the enqueue; then the
    events time the calls as they run, host waits included."""
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
    require(syncs, "the spin kernel never outlasted the host's enqueue")
    print("  (timed as it runs: the call waits for the card, or its host "
          "enqueue outlasts the hold)")
    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return (start.elapsed_time(end) / iters,
            1e3 * (time.perf_counter() - t0) / iters)


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
    supports at once, and once per support for block-ELL. With
    ``cfg.remat`` the backward recomputes every cell step first, so it
    launches each forward launch again besides its own."""
    packs = 1 if kind == "stacked_coo" else cfg.num_supports
    widths = slice_widths(cfg, batch).values()
    fwd = packs * sum(n for _, n, _ in widths)
    bwd = packs * sum(n for _, _, n in widths)
    return fwd, bwd + (fwd if cfg.remat else 0)


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

    ms, plain_ms = chunk_ms(pred, reqs[1]), chunk_ms(plain, reqs[1])
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
        # The program's spans also show on the device as annotations.
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not count:
        print(f"profile of {what}: the profiler saw no device time "
              f"(not measured)")
        return {"device_kernels": None, "busy_ms": None, "idle_share": None}
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
    return {"device_kernels": count, "busy_ms": busy_ms,
            "idle_share": 1 - busy_ms / unprofiled_ms}


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


def _slot_of(rows, memory):
    """The memory slot each (batch, node) row of ``rows`` is a copy of."""
    return (rows[..., None, :] == memory).all(-1).int().argmax(-1)


@contextlib.contextmanager
def pinned_top2():
    """MegaCRN's memory read with the top-2 slots of its first call replayed
    in the later calls. The kernel and plain steps round differently, and
    where two attention scores nearly tie, top-2 (not continuous there) may
    pick another slot; pinned, both steps differentiate the same function.
    Yields a dict whose "moved" counts the (batch, node) pairs whose own
    choice differed from the replayed one, and whose "calls" holds, per
    call, the smallest gaps between the 1st and 2nd and between the 2nd and
    3rd largest attention scores over the (batch, node) pairs, and the
    triplet loss's hinge ``d(q, pos) - d(q, neg) + 1`` of every pair (the
    loss's relu is not differentiable where it is 0)."""
    from megacrn_tpu_torch.models import megacrn as mm

    orig = mm.query_memory
    state = {"ind": None, "moved": 0, "calls": []}

    def query_memory(mem, h_t):
        value, query, pos, neg = orig(mem, h_t)
        memory = mem["Memory"].to(h_t.dtype)
        ind = torch.stack([_slot_of(pos, memory), _slot_of(neg, memory)])
        if state["ind"] is None:
            state["ind"] = ind
        else:
            state["moved"] += int((ind != state["ind"]).any(0).sum())
            ind = state["ind"]
        pos, neg = memory[ind[0]], memory[ind[1]]
        with torch.no_grad():
            att = torch.softmax(query @ memory.T, dim=-1)
            top = att.topk(3, dim=-1).values
            hinge = (torch.linalg.vector_norm(query - pos + 1e-6, dim=-1)
                     - torch.linalg.vector_norm(query - neg + 1e-6, dim=-1)
                     + 1.0)
            state["calls"].append({
                "gap12": (top[..., 0] - top[..., 1]).min().item(),
                "gap23": (top[..., 1] - top[..., 2]).min().item(),
                "hinge": hinge})
        return value, query, pos, neg

    mm.query_memory = query_memory
    try:
        yield state
    finally:
        mm.query_memory = orig


# Phase 7's gradient hold runs over these weight and batch seeds on each
# kernel constant.
HOLD_WEIGHT_SEEDS = (0, 1, 2, 3)
HOLD_BATCH_SEEDS = (0, 1)


def worst_element(got, want):
    """(array, element, |got - want|, its limit, err / limit) of the
    largest err / limit over every array of two gradient dicts, the limit
    GRAD_TOL's atol_rel * max|want| + rtol * |want| per array."""
    rtol, atol_rel = GRAD_TOL
    worst = None
    for k, w in want.items():
        g = got[k]
        require((g is None) == (w is None), f"grad of {k}")
        if w is None:
            continue
        require(bool(torch.isfinite(g).all().item()), f"grad of {k} is not "
                                                       "finite")
        err = (g - w).abs()
        limit = atol_rel * w.abs().max() + rtol * w.abs()
        ratio = err / limit
        i = int(ratio.argmax())
        r = ratio.flatten()[i].item()
        if worst is None or r > worst[4]:
            idx = tuple(int(v) for v in np.unravel_index(i, tuple(w.shape)))
            worst = (k, idx, err.flatten()[i].item(),
                     limit.flatten()[i].item(), r)
    return worst


def grad_holds(cfg, tcfg, kind, const, counter, others, dev):
    """Phase 7's hold of the kernel step against the plain step, over
    HOLD_WEIGHT_SEEDS x HOLD_BATCH_SEEDS: one step's loss and gradients on
    the same weights, batch, teacher-forcing mask and memory top-2 slots,
    each array within GRAD_TOL (never widened). Per run it prints the worst
    array, its worst element, that element's |got - want| against its
    limit, the first forward's smallest top-2 attention margins and its
    smallest |hinge| of the triplet loss, and the pairs whose hinge changes
    sign between the two forwards; all runs are printed before a failure
    stops the script. The first run also checks the forward and backward
    launches of the kernel step. Returns the runs."""
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.train.steps import make_loss_fn

    want_fwd, want_bwd = launches_per_step(cfg, kind, tcfg.batch_size)
    bs0 = half_threshold(cfg)
    runs = []
    for w_seed in HOLD_WEIGHT_SEEDS:
        base = MegaCRN(cfg, generator=torch.Generator().manual_seed(w_seed),
                       device=dev)
        for b_seed in HOLD_BATCH_SEEDS:
            batch = train_batches(cfg, tcfg.batch_size, dev, n=1,
                                  seed=b_seed)[0]
            grads, losses, counts = [], [], []
            with pinned_top2() as pin:
                for sup in (const, _plain(const)):
                    model = copy.deepcopy(base)
                    loss_fn = make_loss_fn(model, tcfg, road_supports=sup)
                    reset_launches(counter, *others)
                    loss = loss_fn(*batch, bs0,
                                   torch.Generator(device=dev).manual_seed(1))
                    fwd = counter.launches
                    loss.backward()
                    counts.append((fwd, counter.launches - fwd,
                                   sum(o.launches for o in others)))
                    losses.append(loss.item())
                    grads.append({k: p.grad
                                  for k, p in model.named_parameters()})
                    del model, loss_fn, loss
            require(counts[0][2] == counts[1][2] == 0,
                    f"{kind}: another kernel was launched")
            require(counts[1][:2] == (0, 0),
                    f"{kind}: the plain path launched the kernel")
            if not runs:
                require(counts[0][:2] == (want_fwd, want_bwd),
                        f"{kind}: {counts[0][0]} forward and {counts[0][1]} "
                        f"backward {kernel_name(counter)} launches in a "
                        f"step, expected {want_fwd} and {want_bwd}")
            array, elem, err, limit, ratio = worst_element(*grads)
            first, second = pin["calls"][0], pin["calls"][1]
            flips = int(((first["hinge"] > 0) != (second["hinge"] > 0))
                        .sum())
            run = {"weight_seed": w_seed, "batch_seed": b_seed,
                   "loss": losses[0], "plain_loss": losses[1],
                   "loss_ok": abs(losses[0] - losses[1])
                   <= 1e-5 * abs(losses[1]),
                   "worst_array": array, "worst_element": elem,
                   "abs_err": err, "limit": limit, "err_over_limit": ratio,
                   "ok": ratio <= 1.0, "top2_gap23": first["gap23"],
                   "top2_gap12": first["gap12"],
                   "min_abs_hinge": first["hinge"].abs().min().item(),
                   "hinge_flips": flips, "moved": pin["moved"]}
            runs.append(run)
            print(f"train {kind} grad hold, weights seed {w_seed}, batch "
                  f"seed {b_seed}: {'ok' if run['ok'] else 'FAIL'}; worst "
                  f"{array}{list(elem)}: |got-want| {err:.3e} vs limit "
                  f"{limit:.3e} ({ratio:.3f} of it); loss {losses[0]:.8f} "
                  f"vs plain {losses[1]:.8f}; first forward's smallest "
                  f"top-2 margins: 2nd-3rd {first['gap23']:.3e}, 1st-2nd "
                  f"{first['gap12']:.3e}; smallest |hinge| "
                  f"{run['min_abs_hinge']:.3e}, hinge sign flips {flips}; "
                  f"top-2 slots moved {pin['moved']} of "
                  f"{tcfg.batch_size * cfg.num_nodes}")
            del grads
    bad = [r for r in runs if not (r["ok"] and r["loss_ok"])]
    require(not bad, f"{kind}: the kernel step's gradients or loss disagree "
                     f"with the plain step's in {len(bad)} of {len(runs)} "
                     f"runs: " + json.dumps(bad))
    print(f"train {kind}: {len(runs)} gradient holds passed (rtol "
          f"{GRAD_TOL[0]:g}, atol {GRAD_TOL[1]:g}*max|g| per array); "
          f"smallest 2nd-3rd top-2 margin "
          f"{min(r['top2_gap23'] for r in runs):.3e}, largest "
          f"err/limit {max(r['err_over_limit'] for r in runs):.3f}")
    return runs


def phase_train(sp, se, cfg, tcfg, constants, dev):
    """Phase 7: the training slice on each graph constant: the gradient
    holds (``grad_holds``), then 5 timed steps. Returns {kind: {"launches":
    {kernel name: launches in 5 steps}, "fwd", "bwd", "ms", "plain_ms",
    "holds"}}."""
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.train.optim import make_optimizer
    from megacrn_tpu_torch.train.steps import make_train_step

    require(cfg.use_curriculum_learning, "curriculum learning is off")
    require(tcfg.max_grad_norm is not None, "the clip is off")
    batches = train_batches(cfg, tcfg.batch_size, dev)
    counters = {"stacked_coo": sp.spmm_coo, "block_ell": se.spmm}
    # Threshold ~0.5: the decoder feeds the label at about half its steps.
    bs0 = half_threshold(cfg)
    results = {}
    for kind, const in constants.items():
        counter = counters[kind]
        others = [c for k, c in counters.items() if k != kind]
        want_fwd, want_bwd = launches_per_step(cfg, kind, tcfg.batch_size)
        holds = grad_holds(cfg, tcfg, kind, const, counter, others, dev)
        base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)

        def steps(sup, seed):
            model = copy.deepcopy(base)
            return make_train_step(
                model, tcfg, make_optimizer(model.parameters(), tcfg),
                torch.Generator(device=dev).manual_seed(seed),
                road_supports=sup)

        torch.cuda.reset_peak_memory_stats()
        step = steps(const, 2)
        run_steps(step, batches, 2, bs0)  # warm-up
        reset_launches(*counters.values())  # --- this path, counted ---
        ms, kernel_losses = run_steps(step, batches, 5, bs0 + 2)
        launches = read_launches(*counters.values())  # --- read just after ---
        n = launches[kernel_name(counter)]
        require(n == 5 * (want_fwd + want_bwd),
                f"{kind}: {n} {kernel_name(counter)} launches in 5 steps, "
                f"expected 5 x ({want_fwd} + {want_bwd})")
        require(sum(launches.values()) == n,
                f"{kind}: another kernel was launched: {launches}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        plain_step = steps(_plain(const), 2)
        run_steps(plain_step, batches, 2, bs0)
        plain_ms, _ = run_steps(plain_step, batches, 5, bs0 + 2)
        print(f"train {kind}: losses {[round(v, 6) for v in kernel_losses]};"
              f" {ms:.3f} ms per train step, plain SpMM {plain_ms:.3f} ms "
              f"(host clock to loss.item(), median of 5); launches in 5 "
              f"steps {launches}; peak device "
              f"memory {peak:.2f} GiB")
        profile(f"one {kind} train step",
                lambda: step(*batches[0], bs0).item(), ms)
        results[kind] = {"launches": launches, "fwd": want_fwd,
                         "bwd": want_bwd, "ms": ms, "plain_ms": plain_ms,
                         "holds": holds}
    return results


# The run-dir artifacts of the fit loop (train/logs.py:RunDir).
ARTIFACTS = (".npz", "_logging.txt", "_epochlog.txt", "_scores.txt",
             "metrics.jsonl")
RESUME_TOL = 1e-5  # largest param difference relative to max|p|


def run_dir_of(save_dir):
    (name,) = os.listdir(save_dir)
    return os.path.join(save_dir, name)


def fit_records(what, save_dir, artifacts=ARTIFACTS):
    """metrics.jsonl of the one run dir under ``save_dir``, after checking
    that the run dir holds every artifact."""
    run = run_dir_of(save_dir)
    files = os.listdir(run)
    for suffix in artifacts:
        require(any(f.endswith(suffix) for f in files),
                f"{what}: no *{suffix} in the run dir {run}")
    require(os.path.isdir(os.path.join(run, "src_snapshot",
                                       "megacrn_tpu_torch")),
            f"{what}: no source snapshot in the run dir")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_cli(sp, se, flags, main=None):
    """``main(flags)`` (default: ``cli.traintest.main``) with both kernels'
    counts set to 0 just before and read just after; returns (result,
    launches, wall s, peak device GiB)."""
    if main is None:
        from megacrn_tpu_torch.cli.traintest import main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(sp.spmm_coo, se.spmm)  # --- this path, counted ---
    t0 = time.perf_counter()
    result = main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(sp.spmm_coo, se.spmm)  # --- read just after ---
    return (result, launches, wall,
            torch.cuda.max_memory_allocated() / 2**30)


def print_epochs(what, records):
    """One line per epoch record of metrics.jsonl."""
    for r in records:
        if "val" in r:
            print(f"{what} epoch {r['epoch']}: {r['seconds']:.3f} s, train "
                  f"{r['train_seconds']:.3f} s over {r['steady_steps']} "
                  f"timed steps, sec_per_step {r.get('sec_per_step', 0):.5f}"
                  f", host upload {r['upload_seconds']:.3f} s, val "
                  f"{r['val_seconds']:.3f} s; train_loss "
                  f"{r['train_loss']:.6f}, val loss {r['val']['loss']:.6f}")
        elif "test_seconds" in r:
            print(f"{what} epoch {r['epoch']} test eval: "
                  f"{r['test_seconds']:.3f} s")


def phase_fit_kernel(sp, se, d, step_ms):
    """Fit (a): the main path at the EXPY-TKY width through the block-COO
    kernel. ``step_ms``: phase 7's isolated train step on the same pack.
    Returns its numbers and launches."""
    from megacrn_tpu_torch.cli import traintest
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency

    adj_path = os.path.join(d, "expy-tky_adj01.npy")
    np.save(adj_path, synthetic_road_adjacency(1843, avg_degree=8, seed=0))
    save = os.path.join(d, "fit_a")
    flags = ["--dataset", "EXPYTKY", "--graph_backend", "road_sparse",
             "--road_impl", "pallas", "--epochs", "2", "--seed", "0",
             "--adj_path", adj_path, "--save_dir", save]
    args = traintest.build_parser().parse_args(flags)
    cfg, tcfg = traintest.configs_from_args(args)
    require((cfg.num_nodes, cfg.rnn_units, cfg.mem_num, cfg.mem_dim,
             tcfg.batch_size) == (1843, 32, 10, 32, 64),
            "fit (a) is not at the EXPY-TKY width")
    # The loaders' lengths, from the same data the CLI builds.
    data = traintest._load_expytky_data(args, cfg, tcfg)
    n = {k: len(data[f"{k}_loader"]) for k in ("train", "val", "test")}
    del data
    fwd, bwd = launches_per_step(cfg, "stacked_coo", tcfg.batch_size)
    # Every epoch: the train steps' forwards, val and (test_every_epoch)
    # test; then the final EXPY-TKY eval over the test loader once more.
    fwd_batches = tcfg.epochs * (n["train"] + n["val"] + n["test"]) + n["test"]
    want = fwd * fwd_batches + bwd * tcfg.epochs * n["train"]

    result, launches, wall, peak = run_cli(sp, se, flags)
    require(launches["spmm_coo"] == want,
            f"fit (a): {launches['spmm_coo']} spmm_coo launches, derived "
            f"{want} = {fwd} x {fwd_batches} forward batches + {bwd} x "
            f"{tcfg.epochs * n['train']} train steps")
    require(launches["spmm_ell"] == 0, "fit (a) launched spmm_ell")
    m = result["test_metrics"]
    for s in range(1, cfg.horizon + 1):
        for k in ("mae", "mape", "rmse"):
            require(np.isfinite(m[f"{k}_{s}"]),
                    f"fit (a): {k}_{s} = {m[f'{k}_{s}']}")
    records = fit_records("fit (a)", save)
    epochs = [r for r in records if "val" in r]
    require(len(epochs) == tcfg.epochs
            and all(r.get("sec_per_step", 0) > 0 for r in epochs),
            "fit (a): sec_per_step missing from an epoch of metrics.jsonl")
    (mem,) = [r["peak_device_memory"] for r in records
              if "peak_device_memory" in r]
    (final,) = [r for r in records if "final_test" in r]
    print_epochs("fit (a)", records)
    out = {"launches": launches, "derived_launches": want, "loaders": n,
           "wall_s": wall, "peak_GiB": peak,
           "peak_after_first_step_GiB":
           mem["max_memory_allocated_bytes"] / 2**30,
           "sec_per_step": [r["sec_per_step"] for r in epochs],
           "epoch_s": [r["seconds"] for r in epochs],
           "val_s": [r["val_seconds"] for r in epochs],
           "upload_s": [r["upload_seconds"] for r in epochs],
           "test_s": [r["test_seconds"] for r in records
                      if "test_seconds" in r],
           "final_eval_s": final["final_test_seconds"],
           "isolated_step_ms": step_ms,
           "mae": m["mae"], "rmse": m["rmse"], "mape": m["mape"]}
    print(f"fit (a): EXPY-TKY road_sparse, N=1843, batch 64, 2 epochs of "
          f"{n['train']} steps, val {n['val']} and test {n['test']} "
          f"batches: {launches['spmm_coo']} spmm_coo launches (derived "
          f"{want}); wall {wall:.2f} s; sec/step inside fit "
          f"{[round(v, 5) for v in out['sec_per_step']]} vs the isolated "
          f"step of phase 7 {step_ms / 1e3:.5f} s (clip on there, off "
          f"here); final eval {out['final_eval_s']:.3f} s; peak device "
          f"memory {peak:.3f} GiB; test mae {m['mae']:.4f} rmse "
          f"{m['rmse']:.4f} mape {m['mape']:.4f}")
    print("fit (a) numbers: " + json.dumps(out))
    del result
    return out


DENSE_FLAGS = ["--dataset", "SYNTH", "--synth_steps", "2000", "--seed", "0",
               "--eval_aggregation", "concat"]


def phase_fit_dense(sp, se, d):
    """Fit (b): the dense METR-LA path for 1 epoch; no SpMM launch."""
    from megacrn_tpu_torch.cli import traintest

    save = os.path.join(d, "fit_b")
    cfg, _ = traintest.configs_from_args(traintest.build_parser().parse_args(
        DENSE_FLAGS))
    require((cfg.num_nodes, cfg.rnn_units, cfg.mem_num, cfg.mem_dim,
             cfg.graph_backend) == (207, 64, 20, 64, "dense"),
            "fit (b) is not the dense METR-LA preset")
    result, launches, wall, peak = run_cli(
        sp, se, DENSE_FLAGS + ["--epochs", "1", "--save_dir", save])
    require(sum(launches.values()) == 0,
            f"fit (b), the dense path, launched an SpMM kernel: {launches}")
    m = result["test_metrics"]
    require(all(np.isfinite(m[k]) for k in ("mae", "mape", "rmse", "mae_3",
                                            "mae_6", "mae_12")),
            f"fit (b): non-finite test metrics {m}")
    records = fit_records("fit (b)", save)
    print_epochs("fit (b)", records)
    (epoch,) = [r for r in records if "val" in r]
    print(f"fit (b): METR-LA dense, 1 epoch, concat eval: launches "
          f"{launches}; wall {wall:.2f} s; sec/step "
          f"{epoch['sec_per_step']:.5f}; peak device memory {peak:.3f} GiB;"
          f" test mae {m['mae']:.4f} rmse {m['rmse']:.4f}")
    del result
    return {"launches": launches, "sec_per_step": epoch["sec_per_step"],
            "wall_s": wall, "save": save}


def phase_fit_resume(sp, se, d, save_b):
    """Fit (c): (b)'s run resumed to 2 epochs against an uninterrupted
    2-epoch run of the same config."""
    whole, l_whole, _, _ = run_cli(
        sp, se, DENSE_FLAGS + ["--epochs", "2", "--save_dir",
                               os.path.join(d, "fit_c_whole")])
    resumed, l_resumed, wall, _ = run_cli(
        sp, se, DENSE_FLAGS + ["--epochs", "2", "--resume", "--save_dir",
                               save_b])
    require(resumed["epochs_run"] == whole["epochs_run"] == 2,
            f"fit (c): epochs {resumed['epochs_run']} vs "
            f"{whole['epochs_run']}")
    records = fit_records("fit (c) resumed", save_b)
    require([r["epoch"] for r in records if "val" in r] == [1, 2],
            "fit (c): the resumed run did not continue (b)'s run dir")
    worst, worst_key = 0.0, None
    for k, p in whole["params"].items():
        rel = float(np.abs(resumed["params"][k] - p).max()
                    / max(np.abs(p).max(), 1e-30))
        if rel >= worst:
            worst, worst_key = rel, k
    print(f"fit (c): resumed 1 -> 2 epochs vs uninterrupted 2 epochs: "
          f"largest param difference relative to max|p| {worst:.3e} "
          f"({worst_key}); best_val {resumed['best_val']:.8f} vs "
          f"{whole['best_val']:.8f}; resumed epoch wall {wall:.2f} s")
    require(worst <= RESUME_TOL,
            f"fit (c): resumed params differ by {worst:.3e} of max|p| "
            f"(> {RESUME_TOL:g}) at {worst_key}")
    return {"launches_whole": l_whole, "launches_resumed": l_resumed,
            "max_rel_param_diff": worst}


# --- The graph backends slice: node-ELL, sparse_meta, dense stacked, remat.
# None of these paths runs a hand-written kernel (the JAX package writes
# them in XLA, the port in plain PyTorch): each path's spmm_coo and spmm_ell
# counts are read around it and must be 0, but for remat on the COO path.


def half_threshold(cfg):
    """batches_seen at which the curriculum threshold is ~0.5."""
    return float(cfg.cl_decay_steps * np.log(cfg.cl_decay_steps))


def with_cfg(base, cfg):
    """A copy of ``base``'s weights under another config of the same preset
    (every graph backend has the same parameters)."""
    model = copy.deepcopy(base)
    model.cfg = cfg
    return model


def run_steps(step, batches, n, first):
    """(median host ms to loss.item(), losses) of n train steps."""
    times, losses = [], []
    for i in range(n):
        t0 = time.perf_counter()
        loss = step(*batches[i % len(batches)], first + i)
        losses.append(loss.item())  # ends the step on the host
        times.append(1e3 * (time.perf_counter() - t0))
    require(np.isfinite(losses).all(), f"non-finite loss {losses}")
    return float(np.median(times)), losses


def hold_steps(what, runs, tcfg, batch, dev):
    """One train step (forward with scheduled sampling, composite loss,
    backward) of each ``(label, model, graph constant)`` of ``runs`` on the
    same batch, coins and memory top-2 slots; each run's loss and gradients
    against the first run's, per array within GRAD_TOL. Returns the worst
    |err| / max|g|."""
    from megacrn_tpu_torch.train.steps import make_loss_fn

    out = []
    with pinned_top2() as pin:
        for label, model, const in runs:
            loss = make_loss_fn(model, tcfg, road_supports=const)(
                *batch, half_threshold(model.cfg),
                torch.Generator(device=dev).manual_seed(1))
            loss.backward()
            out.append((label, loss.item(),
                        {k: p.grad for k, p in model.named_parameters()}))
    (ref_label, ref_loss, ref), worst = out[0], 0.0
    rtol, atol_rel = GRAD_TOL
    for label, loss, grads in out[1:]:
        require(abs(loss - ref_loss) <= 1e-5 * abs(ref_loss),
                f"{what}: loss {loss} ({label}) vs {ref_loss} ({ref_label})")
        for k, w in ref.items():
            g = grads[k]
            require((g is None) == (w is None), f"{what}: grad of {k}")
            if w is None:
                continue
            err = (g - w).abs()
            require(bool(torch.isfinite(g).all().item()) and bool(
                (err <= atol_rel * w.abs().max() + rtol * w.abs())
                .all().item()),
                f"{what}: grad of {k} ({label}) disagrees with {ref_label}, "
                f"max abs err {err.max().item():.3e}")
            worst = max(worst, (err / w.abs().max()).max().item())
    print(f"{what}: one train step of each of {[r[0] for r in runs]} on the "
          f"same weights, batch, coins and memory top-2 slots ({pin['moved']}"
          f" moved); losses {[round(r[1], 6) for r in out]}; grads vs "
          f"{ref_label}: max |err|/max|g| {worst:.3e} (rtol {rtol:g}, atol "
          f"{atol_rel:g}*max|g| per array)")
    return worst


def measure_family(name, step, sp, se, serve=None, steps=5):
    """A path at full width: 2 warm-up and ``steps`` timed calls of
    ``step(i)`` (one train step, returning its loss on the card; host clock
    to ``.item()``), counted: both kernels' counts set to 0 just before the
    timed steps and read just after ("launches"), and again around one
    served chunk ("serve_launches"; ``serve()`` returns its ms). The peak
    device memory from the first step on, and one profiled step (device
    kernels, busy ms, idle share). The callers check the counts."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        step(i).item()  # warm-up
    reset_launches(sp.spmm_coo, se.spmm)  # --- this path, counted ---
    times, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(step(2 + i).item())
        times.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches(sp.spmm_coo, se.spmm)  # --- read just after ---
    require(np.isfinite(losses).all(), f"{name}: non-finite loss {losses}")
    ms = float(np.median(times))
    out = {"step_ms": ms, "peak_GiB": torch.cuda.max_memory_allocated()
           / 2**30, "launches": launches, "losses": losses}
    out.update(profile(f"one {name} train step", lambda: step(0).item(), ms))
    if serve is not None:
        reset_launches(sp.spmm_coo, se.spmm)  # --- serving, counted ---
        out["chunk_ms"] = serve()
        out["serve_launches"] = read_launches(sp.spmm_coo, se.spmm)
    print(f"path {name}: {ms:.3f} ms per train step (host clock to "
          f"loss.item(), median of {steps}); device kernels per step "
          f"{out['device_kernels']}, busy {out['busy_ms']} ms, idle share "
          f"{out['idle_share']}; peak device memory {out['peak_GiB']:.3f} "
          f"GiB; served 64-window chunk {out.get('chunk_ms')} ms; launches "
          f"{launches}; losses {[round(v, 6) for v in losses]}")
    return out


def host_ms(fn, reps=5):
    """Median host ms of ``fn()`` ending in a synchronize, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def chunk_ms(pred, x):
    """Median host ms of one served 64-window chunk (ends in the copy to
    the host), after a warm-up call."""
    return host_ms(lambda: pred.predict(x))


def measure_path(name, model, tcfg, const, batches, dev, sp, se, steps=5,
                 serve=True):
    """``measure_family`` of a MegaCRN train step of ``model`` on the graph
    constant ``const`` and, with ``serve``, a chunk served through the
    Predictor."""
    from megacrn_tpu_torch.serve import Predictor
    from megacrn_tpu_torch.train.optim import make_optimizer
    from megacrn_tpu_torch.train.steps import make_train_step

    step = make_train_step(model, tcfg, make_optimizer(model.parameters(),
                                                       tcfg),
                           torch.Generator(device=dev).manual_seed(2),
                           road_supports=const)
    bs = half_threshold(model.cfg)
    chunk = None
    if serve:
        x = requests(np.random.RandomState(5), batches[0][0].shape[0],
                     model.cfg)
        pred = Predictor(model, model.cfg, 45.0, 15.0, 64,
                         road_supports=const, device=dev)
        chunk = lambda: chunk_ms(pred, x)  # noqa: E731
    return measure_family(
        name, lambda i: step(*batches[i % len(batches)], bs + i), sp, se,
        serve=chunk, steps=steps)


def device_kernels(fn, calls=3):
    """Device kernels one call of ``fn`` launches: the kernel launches the
    profiler records on the host (the CUDA runtime's launch calls), or the
    device kernels it records if more, over ``calls`` calls after a
    warm-up, per call. (The device records alone came back short for a few
    calls of a kernel or two.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    on_device = sum(e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation for e in events)
    launched = sum(e.device_type == DeviceType.CPU
                   and "LaunchKernel" in e.name for e in events)
    return round(max(on_device, launched) / calls)


@contextlib.contextmanager
def counted(module, name):
    """Count the calls of ``module.name`` (a plain function the module
    calls through its own namespace); yields the count in a dict."""
    orig = getattr(module, name)
    calls = {"n": 0}

    def wrapper(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def calls_per_step(targets, model, tcfg, const, batch, dev):
    """{label: calls in one train step's forward + backward} of each
    ``(label, module, name)`` of ``targets``."""
    from megacrn_tpu_torch.train.steps import make_loss_fn

    with contextlib.ExitStack() as stack:
        counts = {label: stack.enter_context(counted(mod, name))
                  for label, mod, name in targets}
        loss = make_loss_fn(model, tcfg, road_supports=const)(
            *batch, half_threshold(model.cfg),
            torch.Generator(device=dev).manual_seed(1))
        loss.backward()
    model.zero_grad(set_to_none=True)
    return {label: c["n"] for label, c in counts.items()}


def spmm_bytes_bound(nnz, x_rows, rows, f, idx_bytes=8):
    """(bound ms, bound_by) of y = A @ x from the nonzeros: a 4-byte value
    and an index each, the rows of x some nonzero references and y once,
    against 2*f flops a nonzero (f32)."""
    nbytes = nnz * (4 + idx_bytes) + (x_rows + rows) * f * 4
    return roof(nbytes, 2.0 * nnz * f)


def roof(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def csr_from_rows(rows, cols, vals, shape, dev):
    """A torch sparse CSR tensor on ``dev`` from COO triplets (numpy)."""
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    ptr = np.zeros(shape[0] + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(rows, minlength=shape[0]))
    return torch.sparse_csr_tensor(
        torch.from_numpy(ptr), torch.from_numpy(cols.astype(np.int64)),
        torch.as_tensor(np.asarray(vals)[order], dtype=torch.float32),
        size=shape).to(dev)


def check_close(what, got, want, tol=TOL[torch.float32]):
    """got against want (tensors or tuples of them) within the f32
    tolerance; returns the max abs error."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        atol = tol[1] * w.abs().max().item()
        require(g.shape == w.shape and bool(torch.isfinite(g).all().item())
                and bool((err <= atol + tol[0] * w.abs()).all().item()),
                f"{what}: max abs err {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    return worst


def held_iters(kernels_per_call, queue=400):
    """Calls ``cuda_ms`` may enqueue behind its spin kernel: the host
    blocks once about a thousand launches wait on the card, so an op of
    many small kernels is timed over fewer calls (at least one)."""
    return max(1, min(10, queue // max(1, kernels_per_call)))


def op_row(name, fn, args, dev, library=None, bound=None, backward=False,
           note=""):
    """One row of the plain-PyTorch op table: device ms of ``fn(*args)``
    (CUDA events behind a spin kernel; no autograd), and with ``backward``
    of forward + backward through autograd (random cotangent); device
    kernels per call; the library call's ms; the bound."""
    row = {"op": name, "note": note}
    row["device_kernels"] = device_kernels(lambda: fn(*args))
    with torch.no_grad():
        row["ms"] = cuda_ms(lambda: fn(*args), syncs=True,
                            iters=held_iters(row["device_kernels"]))[0]
    if backward:
        leaves = [a.detach().requires_grad_() if a.is_floating_point()
                  else a for a in args]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        cots = [torch.randn_like(o) for o in outs]

        def fwd_bwd():
            o = fn(*leaves)
            torch.autograd.backward(list(o) if isinstance(o, tuple) else [o],
                                    cots)

        kernels = device_kernels(fwd_bwd)
        row["fwd_bwd_ms"] = cuda_ms(fwd_bwd, iters=held_iters(kernels),
                                    syncs=True)[0]
        row["backward_ms"] = row["fwd_bwd_ms"] - row["ms"]
        row["backward_device_kernels"] = kernels - row["device_kernels"]
    if library is not None:
        row["library_ms"] = cuda_ms(library, syncs=True)[0]
    if bound is not None:
        row["bound_ms"], row["bound_by"] = bound
    print(f"op {name}: " + json.dumps(row))
    return row


def phase_node_ell(sp, se, cfg, tcfg, sups, stacked, dev, coo_step_ms):
    """Phase 11: node-ELL road supports at the EXPY-TKY width, the bucketed
    pack (as built) and the flat pack (max_buckets=1), held against the
    block-COO step; their paths; ``_ell_apply`` in both forms; and the
    ``--road_impl auto`` policy against the measured step times."""
    from megacrn_tpu_torch.cli import traintest
    from megacrn_tpu_torch.kernels import spmm_ell_node as sen
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    t0 = time.perf_counter()
    packs = {"bucketed": sen.build_stacked_node_ell(sups)}
    build_s = time.perf_counter() - t0
    packs["flat"] = sen.build_stacked_node_ell(sups, max_buckets=1)
    require(isinstance(packs["flat"], sen.StackedNodeELL),
            "max_buckets=1 did not give the flat pack")
    b = packs["bucketed"]
    layout = ([tuple(a.shape) for a in b.fwd_nbr]
              if isinstance(b, sen.BucketedStackedNodeELL) else "flat")
    nnz = sen.pack_nnz(b)
    print(f"node-ELL packs: built in {build_s:.3f} s (host); as built "
          f"{type(b).__name__} with forward buckets {layout}; flat "
          f"{tuple(packs['flat'].pack.nbr.shape)}; {nnz} edges "
          f"(flat pack nnz {sen.pack_nnz(packs['flat'])})")
    require(nnz == sen.pack_nnz(packs["flat"]), "the two packs differ")

    base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    batches = train_batches(cfg, tcfg.batch_size, dev)
    worst = hold_steps(
        "node-ELL vs block-COO",
        [("block_coo", with_cfg(base, cfg), stacked)]
        + [(f"node_ell_{k}", with_cfg(base, cfg), p)
           for k, p in packs.items()], tcfg, batches[0], dev)
    paths = {}
    for k, p in packs.items():
        paths[f"node_ell_{k}"] = measure_path(
            f"node_ell_{k}", with_cfg(base, cfg), tcfg, p, batches, dev, sp,
            se)
        # Applications of the pack per train step (forward + backward).
        fn = "_bucketed_apply" if k == "bucketed" and layout != "flat" else (
            "_ell_apply")
        paths[f"node_ell_{k}"]["applications_per_step"] = calls_per_step(
            [("apply", sen, fn)], with_cfg(base, cfg), tcfg, p, batches[0],
            dev)["apply"]
    for k, res in paths.items():
        require(sum(res["launches"].values()) == 0,
                f"{k} launched an SpMM kernel: {res['launches']}")

    # _ell_apply in both forms, against cuSPARSE on the same matrix.
    n_stack = cfg.num_supports * cfg.num_nodes
    flat = packs["flat"].pack
    keep = flat.w.numpy() != 0
    rows = np.nonzero(keep)[0]
    csr = csr_from_rows(rows, flat.nbr.numpy()[keep], flat.w.numpy()[keep],
                        (n_stack, n_stack), dev)
    x_rows = int(np.unique(flat.nbr.numpy()[keep]).size)
    gen = torch.Generator(device=dev).manual_seed(11)
    ops = []
    for k, p in packs.items():
        p = p.to(dev)
        if isinstance(p, sen.BucketedStackedNodeELL):
            def unrolled(x, p=p):
                return sen._bucketed_apply(p.fwd_nbr, p.fwd_w, p.fwd_inv, x)

            def einsum(x, p=p):
                return torch.cat([sen._ell_einsum(n, w, x) for n, w in
                                  zip(p.fwd_nbr, p.fwd_w)])[p.fwd_inv]
        else:
            def unrolled(x, p=p):
                return sen._ell_apply(p.pack.nbr, p.pack.w, x)

            def einsum(x, p=p):
                return sen._ell_einsum(p.pack.nbr, p.pack.w, x)

        for f in (2112, 4224):
            x = torch.randn((n_stack, f), generator=gen, device=dev)
            want = csr @ x
            for form, fn in (("unrolled", unrolled), ("einsum", einsum)):
                err = check_close(f"_ell_apply {k} {form} f={f} vs cuSPARSE",
                                  fn(x), want)
                row = op_row(f"_ell_apply[{k},{form}]", fn, (x,), dev,
                             library=lambda x=x: csr @ x,
                             bound=spmm_bytes_bound(nnz, x_rows, n_stack, f),
                             note=f"f={f}")
                row.update(f=f, pack=k, form=form, max_abs_err=err,
                           applications_per_step=paths[f"node_ell_{k}"][
                               "applications_per_step"])
                ops.append(row)
    del csr

    # --road_impl auto, as the CLI builds it, against the measured steps.
    args = traintest.build_parser().parse_args(
        ["--dataset", "SYNTH", "--num_nodes", str(cfg.num_nodes),
         "--graph_backend", "road_sparse", "--road_impl", "auto"])
    auto = traintest.build_road_supports(args, traintest.configs_from_args(
        args)[0])
    ell_ms = min(paths["node_ell_bucketed"]["step_ms"],
                 paths["node_ell_flat"]["step_ms"])
    picked, other = (("block_coo", coo_step_ms), ("node_ell", ell_ms)) if (
        isinstance(auto, sp.StackedRoadPack)) else (
        ("node_ell", ell_ms), ("block_coo", coo_step_ms))
    print(f"--road_impl auto picks {picked[0]}: train step {picked[1]:.3f} ms"
          f" against {other[0]} {other[1]:.3f} ms (this run)")
    require(picked[1] <= 1.1 * other[1],
            f"--road_impl auto picks {picked[0]}, slower than {other[0]}")
    return {"paths": paths, "ops": ops, "build_s": build_s,
            "hold_worst": worst, "auto": picked[0],
            "auto_ms": {"block_coo": coo_step_ms, "node_ell": ell_ms}}


def phase_node_ell_large(sp, se, dev, n=16384, batch=8):
    """Phase 12: one node-ELL train path at the round-5 scale shape (N=16384,
    batch 8, EXPY-TKY widths): the host seconds to build the dense N x N
    supports and the pack, the step time and the peak device memory. If the
    dense supports take over 60 s on the host, N=8192 instead."""
    from megacrn_tpu_torch.config import model_config_for, train_config_for
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
    from megacrn_tpu_torch.kernels import spmm_ell_node as sen
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

    t0 = time.perf_counter()
    sups = list(dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=8, seed=0)))
    dense_s = time.perf_counter() - t0
    if dense_s > 60:
        print(f"node-ELL N={n}: the dense supports took {dense_s:.1f} s on "
              f"the host (> 60 s): N=8192 instead")
        n = 8192
        t0 = time.perf_counter()
        sups = list(dual_random_walk_supports(
            synthetic_road_adjacency(n, avg_degree=8, seed=0)))
        dense_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pack = sen.build_stacked_node_ell(sups)
    pack_s = time.perf_counter() - t0
    del sups
    cfg = model_config_for("EXPYTKY", num_nodes=n, graph_backend="road_sparse")
    tcfg = train_config_for("EXPYTKY", batch_size=batch, max_grad_norm=5.0)
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                    device=dev)
    res = measure_path(f"node_ell_N{n}_batch{batch}", model, tcfg, pack,
                       train_batches(cfg, batch, dev), dev, sp, se, steps=3,
                       serve=False)
    require(sum(res["launches"].values()) == 0,
            f"node-ELL N={n} launched an SpMM kernel")
    res.update(n=n, batch=batch, dense_supports_s=dense_s, pack_build_s=pack_s,
               pack=type(pack).__name__)
    print(f"node-ELL N={n} batch {batch}: host {dense_s:.2f} s for the dense "
          f"supports + {pack_s:.2f} s for the pack; {res['step_ms']:.3f} ms "
          f"per train step; peak device memory {res['peak_GiB']:.3f} GiB")
    return res


def node_dense(p, values, n, bucketed):
    """The (n, n) dense matrix of per-slot values on a node pattern (0 at
    the pads, which all point at column 0)."""
    out = torch.zeros((n, n), device=values[0].device)
    if bucketed:
        for nbr_b, rows_b, v_b in zip(p.nbr, p.rows, values):
            out.index_put_((rows_b[:, None].expand_as(nbr_b), nbr_b), v_b,
                           accumulate=True)
    else:
        rows = torch.arange(n, device=out.device)[:, None].expand_as(p.nbr)
        out.index_put_((rows, p.nbr), values, accumulate=True)
    return out


def phase_sparse_meta(sp, se, cfg, tcfg, adj, dev):
    """Phase 13: the learned sparse_meta graph at the EXPY-TKY width on the
    CLI's pattern (the symmetrised road graph with self loops), node
    granular (as built) and 128x128-tile granular: node held against block,
    their paths (block with and without remat), and the ops timed."""
    from megacrn_tpu_torch.kernels import sparse_graph as sg
    from megacrn_tpu_torch.kernels import sparse_graph_node as sgn
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    pat = ((adj != 0) | (adj.T != 0)).astype(np.float32)
    np.fill_diagonal(pat, 1.0)
    t0 = time.perf_counter()
    node = sgn.build_node_pattern(pat)
    node_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    block = sg.build_block_pattern(pat)
    block_s = time.perf_counter() - t0
    nnz = int(pat.sum())
    print(f"sparse_meta patterns: {nnz} edges; node {type(node).__name__} "
          f"({node_s:.3f} s host); block cols {tuple(block.cols.shape)} "
          f"({block_s:.3f} s host, mask "
          f"{block.mask.numel() * 4 / 2**20:.1f} MiB f32)")
    cfg = dataclasses.replace(cfg, graph_backend="sparse_meta")
    base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    batches = train_batches(cfg, tcfg.batch_size, dev)
    worst = hold_steps("sparse_meta node vs block",
                       [("block", with_cfg(base, cfg), block),
                        ("node", with_cfg(base, cfg), node)], tcfg,
                       batches[0], dev)
    paths = {}
    remat = dataclasses.replace(cfg, remat=True)
    for name, c, const in (("sparse_meta_node", cfg, node),
                           ("sparse_meta_block", cfg, block),
                           ("sparse_meta_block_remat", remat, block)):
        paths[name] = measure_path(name, with_cfg(base, c), tcfg, const,
                                   batches, dev, sp, se)
        require(sum(paths[name]["launches"].values()) == 0,
                f"{name} launched an SpMM kernel")
    print("sparse_meta peak device memory: block "
          f"{paths['sparse_meta_block']['peak_GiB']:.3f} GiB without remat, "
          f"{paths['sparse_meta_block_remat']['peak_GiB']:.3f} GiB with; "
          f"node {paths['sparse_meta_node']['peak_GiB']:.3f} GiB without")

    # The ops, at the model's shapes: e = We @ Memory (N, mem_dim); the
    # learned weights; x at the encoder gate's width.
    n, k_dim, f = cfg.num_nodes, cfg.mem_dim, tcfg.batch_size * (
        cfg.input_dim + cfg.rnn_units)
    gen = torch.Generator(device=dev).manual_seed(12)
    e1, e2 = (torch.randn((n, k_dim), generator=gen, device=dev)
              for _ in range(2))
    x = torch.randn((n, f), generator=gen, device=dev)
    e2t = e2.T.contiguous()
    p = node.to(dev, transpose=True)
    bucketed = isinstance(p, sgn.BucketedNodeELLPattern)
    rows, cols = np.nonzero(pat)
    pattern_csr = csr_from_rows(rows, cols, np.ones(nnz), (n, n), dev)
    with torch.no_grad():
        scores = sgn.sddmm_node_bucketed(e1, e2, p) if bucketed else (
            sgn.sddmm_node(e1, e2, p.nbr, p.mask))
        w = sgn.node_row_softmax_bucketed(
            tuple(torch.relu(s) for s in scores), p) if bucketed else (
            sgn.node_row_softmax(torch.relu(scores), p.mask))
    # The learned weights as a CSR of the same matrix, and its transpose.
    dense_w = node_dense(p, w, n, bucketed)
    w_csr, w_csr_t = dense_w.to_sparse_csr(), dense_w.T.contiguous(
        ).to_sparse_csr()
    scores_coo = torch.sparse_coo_tensor(
        torch.from_numpy(np.stack([rows, cols])).to(dev),
        torch.randn(nnz, generator=gen, device=dev), (n, n)).coalesce()
    x_rows = int(np.unique(cols).size)
    ops = []
    tag = "bucketed" if bucketed else "flat"
    if bucketed:
        def sddmm(a, b_):
            return sgn.sddmm_node_bucketed(a, b_, p)

        def softmax(*s):
            return sgn.node_row_softmax_bucketed(s, p)

        def spmm(x_, *w_):
            return sgn.spmm_node_bucketed(p.nbr, p.mask, p.rows, p.inv,
                                          p.t_nbr, p.t_slot, p.t_mask,
                                          p.t_inv, w_, x_)
        score_args, w_args = tuple(scores), tuple(w)
    else:
        def sddmm(a, b_):
            return sgn.sddmm_node(a, b_, p.nbr, p.mask)

        def softmax(s):
            return sgn.node_row_softmax(s, p.mask)

        def spmm(x_, w_):
            return sgn.spmm_node(p.nbr, p.mask, p.t_nbr, p.t_slot, p.t_mask,
                                 w_, x_)
        score_args, w_args = (scores,), (w,)
    with torch.no_grad():
        check_close("spmm_node vs cuSPARSE", spmm(x, *w_args), w_csr @ x)
        sampled = torch.sparse.sampled_addmm(pattern_csr, e1, e2t, beta=0.0)
        check_close("sddmm_node vs sampled_addmm",
                    node_dense(p, sddmm(e1, e2), n, bucketed),
                    sampled.to_dense())
    sddmm_bound = roof(2 * n * k_dim * 4 + nnz * (8 + 4),
                       2.0 * nnz * k_dim)
    ops.append(op_row(f"sddmm_node[{tag}]", sddmm, (e1, e2), dev,
                      library=lambda: torch.sparse.sampled_addmm(
                          pattern_csr, e1, e2t, beta=0.0),
                      bound=sddmm_bound, backward=True,
                      note=f"K={k_dim}, nnz={nnz}"))
    ops.append(op_row(f"node_row_softmax[{tag}]", softmax, score_args, dev,
                      library=lambda: torch.sparse.softmax(scores_coo, 1),
                      bound=roof(nnz * 12, 5.0 * nnz), backward=True,
                      note=f"nnz={nnz}"))
    spmm_bound = spmm_bytes_bound(nnz, x_rows, n, f)
    bwd_bound = roof(nnz * (4 + 3 * 8 + 4) + 3 * n * f * 4, 4.0 * nnz * f)
    row = op_row(f"spmm_node[{tag}]", spmm, (x,) + w_args, dev,
                 library=lambda: w_csr @ x, bound=spmm_bound, backward=True,
                 note=f"f={f}")
    dy = torch.randn((n, f), generator=gen, device=dev)
    x_t = x.T.contiguous()
    row["library_backward_ms"] = cuda_ms(
        lambda: (w_csr_t @ dy, torch.sparse.sampled_addmm(
            pattern_csr, dy, x_t, beta=0.0)), syncs=True)[0]
    row["backward_bound_ms"] = bwd_bound[0]
    ops.append(row)

    bp = block.to(dev)
    tiles = sg.sparse_meta_graph(torch.randn((cfg.mem_num, k_dim),
                                             generator=gen, device=dev),
                                 base.memory["We1"].detach(),
                                 base.memory["We2"].detach(), bp)[0]
    dense_t = torch.zeros((bp.n, bp.n), device=dev)
    for i, cols_i in enumerate(bp.cols.tolist()):
        for r, c in enumerate(cols_i):
            dense_t[i * 128:(i + 1) * 128, c * 128:(c + 1) * 128] += (
                tiles[i, r])
    t_csr = dense_t[:n, :n].contiguous().to_sparse_csr()
    check_close("spmm_blocks vs cuSPARSE", sg.spmm_blocks(tiles, bp, x),
                t_csr @ x)
    row = op_row("spmm_blocks", lambda t, x_: sg.spmm_blocks(t, bp, x_),
                 (tiles.detach(), x), dev, library=lambda: t_csr @ x,
                 bound=spmm_bytes_bound(nnz, x_rows, n, f), backward=True,
                 note=f"f={f}, {tuple(bp.cols.shape)} tiles")
    ops.append(row)
    del dense_w, dense_t, w_csr, w_csr_t, t_csr
    # Forward calls per train step of each op, as the model makes them
    # (each has one backward call: the learned weights need gradients).
    suffix = "_bucketed" if bucketed else ""
    per_step = calls_per_step(
        [(f"sddmm_node[{tag}]", sgn, "sddmm_node" + suffix),
         (f"node_row_softmax[{tag}]", sgn, "node_row_softmax" + suffix),
         (f"spmm_node[{tag}]", sgn, "spmm_node" + suffix)],
        with_cfg(base, cfg), tcfg, node, batches[0], dev)
    per_step["spmm_blocks"] = calls_per_step(
        [("spmm_blocks", sg, "spmm_blocks")], with_cfg(base, cfg), tcfg,
        block, batches[0], dev)["spmm_blocks"]
    print(f"sparse_meta calls per train step: {per_step}")
    return {"paths": paths, "ops": ops, "calls_per_step": per_step,
            "hold_worst": worst, "node_pattern": type(node).__name__,
            "nnz": nnz}


def phase_dense_stacked(sp, se, dev):
    """Phase 14: dense_impl="stacked" against "recursive" at METR-LA (N=207)
    and at the EXPY-TKY width on the dense backend (N=1843), batch 64:
    equal gradients within GRAD_TOL, and both paths measured."""
    from megacrn_tpu_torch.config import model_config_for, train_config_for
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    out = {}
    for ds in ("METRLA", "EXPYTKY"):
        cfg = model_config_for(ds)
        tcfg = train_config_for(ds, max_grad_norm=5.0)
        stacked = dataclasses.replace(cfg, dense_impl="stacked")
        base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                       device=dev)
        batches = train_batches(cfg, tcfg.batch_size, dev)
        worst = hold_steps(f"dense stacked vs recursive, {ds}",
                           [("recursive", with_cfg(base, cfg), None),
                            ("stacked", with_cfg(base, stacked), None)],
                           tcfg, batches[0], dev)
        for name, c in (("recursive", cfg), ("stacked", stacked)):
            res = measure_path(f"dense_{name}_{ds}", with_cfg(base, c), tcfg,
                               None, batches, dev, sp, se)
            require(sum(res["launches"].values()) == 0,
                    f"dense {name} {ds} launched an SpMM kernel")
            res["hold_worst"] = worst
            out[f"dense_{name}_{ds}"] = res
        del base, batches
    return out


def phase_remat(sp, se, cfg, tcfg, stacked, dev):
    """Phase 15: --remat on the block-COO path (EXPY-TKY width, batch 64):
    loss and gradients equal to the plain step's, the peak memory and step
    time of both, and the COO launches of the remat step counted with the
    backward's recomputation (2F + B a step)."""
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    remat = dataclasses.replace(cfg, remat=True)
    base = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    batches = train_batches(cfg, tcfg.batch_size, dev)
    worst = hold_steps("remat vs plain, block-COO",
                       [("plain", with_cfg(base, cfg), stacked),
                        ("remat", with_cfg(base, remat), stacked)], tcfg,
                       batches[0], dev)
    out = {}
    for name, c in (("coo_plain", cfg), ("coo_remat", remat)):
        res = measure_path(name, with_cfg(base, c), tcfg, stacked, batches,
                           dev, sp, se)
        fwd, bwd = launches_per_step(c, "stacked_coo", tcfg.batch_size)
        require(res["launches"] == {"spmm_coo": 5 * (fwd + bwd),
                                    "spmm_ell": 0},
                f"{name}: launches {res['launches']} in 5 steps, expected "
                f"5 x ({fwd} + {bwd}) spmm_coo")
        res.update(forward_launches=fwd, backward_launches=bwd,
                   hold_worst=worst)
        out[name] = res
    print(f"remat on block-COO: {out['coo_remat']['step_ms']:.3f} ms per step"
          f" and {out['coo_remat']['peak_GiB']:.3f} GiB peak, against "
          f"{out['coo_plain']['step_ms']:.3f} ms and "
          f"{out['coo_plain']['peak_GiB']:.3f} GiB without; spmm_coo "
          f"launches a step {out['coo_remat']['forward_launches']} + "
          f"{out['coo_remat']['backward_launches']} (recomputation "
          f"included) against {out['coo_plain']['forward_launches']} + "
          f"{out['coo_plain']['backward_launches']}")
    return out


def phase_cli_new_flags(sp, se, d, adj_path):
    """Phase 16: the traintest CLI for 1 epoch at the EXPY-TKY width with
    each new flag: --road_impl ell, --graph_backend sparse_meta
    --sparse_meta_impl node, and --dense_impl stacked. No SpMM kernel runs
    on these paths."""
    out = {}
    for name, flags in (
            ("cli_road_impl_ell", ["--graph_backend", "road_sparse",
                                   "--road_impl", "ell"]),
            ("cli_sparse_meta_node", ["--graph_backend", "sparse_meta",
                                      "--sparse_meta_impl", "node"]),
            ("cli_dense_impl_stacked", ["--dense_impl", "stacked"])):
        save = os.path.join(d, name)
        result, launches, wall, peak = run_cli(
            sp, se, ["--dataset", "EXPYTKY", "--epochs", "1", "--seed", "0",
                     "--adj_path", adj_path, "--save_dir", save] + flags)
        require(sum(launches.values()) == 0,
                f"{name} launched an SpMM kernel: {launches}")
        m = result["test_metrics"]
        require(all(np.isfinite(m[f"{k}_{s}"]) for k in ("mae", "rmse")
                    for s in range(1, 7)), f"{name}: test metrics {m}")
        records = fit_records(name, save)
        print_epochs(name, records)
        (epoch,) = [r for r in records if "val" in r]
        out[name] = {"launches": launches, "wall_s": wall, "peak_GiB": peak,
                     "sec_per_step": epoch["sec_per_step"],
                     "mae": m["mae"]}
        print(f"{name}: 1 epoch, wall {wall:.2f} s, sec/step "
              f"{epoch['sec_per_step']:.5f}, peak {peak:.3f} GiB, test mae "
              f"{m['mae']:.4f}, launches {launches}")
        del result
    return out


# --- The two other model families, MegaCRNx and GTS. Neither reaches a
# Pallas kernel in the JAX package (MegaCRNx aggregates with the dense
# cheb_aggregate, GTS diffuses over a dense sampled adjacency), so each path
# runs plain PyTorch: its spmm_coo and spmm_ell counts are read around it
# and must be 0.


def check_family_cli(name, sp, se, main, flags, save, artifacts):
    """One in-process run of a family's CLI, counted; its run dir holds
    every artifact. Returns (result, numbers)."""
    result, launches, wall, peak = run_cli(sp, se, flags, main=main)
    require(sum(launches.values()) == 0,
            f"{name} launched an SpMM kernel: {launches}")
    records = fit_records(name, save, artifacts)
    epochs = [r for r in records if "sec_per_step" in r]
    for r in epochs:
        print(f"{name} epoch {r['epoch']}: {r['seconds']:.3f} s, train "
              f"{r['train_seconds']:.3f} s over {r['steps']} steps, "
              f"sec_per_step {r['sec_per_step']:.5f}")
    out = {"launches": launches, "wall_s": wall, "peak_GiB": peak,
           "epochs": len(epochs),
           "sec_per_step": [r["sec_per_step"] for r in epochs],
           "epoch_s": [r["seconds"] for r in epochs]}
    print(f"{name}: wall {wall:.2f} s, peak {peak:.3f} GiB, launches "
          f"{launches}, test metrics {json.dumps(result['test_metrics'])}")
    return result, out


def phase_megacrnx(sp, se, d, dev):
    """Phase 17: MegaCRNx at the reference defaults (traintest_MegaCRNx.py's
    parser: METR-LA, N=207, 12->12, units 32, memory 10x32, embed 8, one
    layer, batch 64), in both decoders: 5 train steps and a served chunk
    each; a small model on the card against the CPU; the CLI for 2 epochs
    on SYNTH at N=207."""
    from megacrn_tpu_torch.cli import traintest_megacrnx as cli
    from megacrn_tpu_torch.models.megacrnx import MegaCRNx, MegaCRNxConfig
    from megacrn_tpu_torch.serve import MegaCRNxPredictor
    from megacrn_tpu_torch.train.megacrnx_loop import \
        make_megacrnx_train_step

    cfg, tcfg = cli.configs_from_args(cli.build_parser().parse_args([]), 207)
    require((cfg.num_nodes, cfg.seq_len, cfg.horizon, cfg.rnn_units,
             cfg.mem_num, cfg.mem_dim, cfg.embed_dim, cfg.num_layers,
             tcfg.batch_size) == (207, 12, 12, 32, 10, 32, 8, 1, 64),
            "phase 17 is not at the reference defaults")
    mean, std = 45.0, 15.0
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(2):
        x = (requests(rs, 64, cfg) - mean) / std
        y = rs.uniform(0.0, 70.0, (64, cfg.horizon, cfg.num_nodes, 1))
        y[rs.rand(*y.shape) < 0.02] = 0.0  # missing: MaskMAE masks them
        yc = rs.uniform(0.0, 1.0, (64, cfg.horizon, cfg.num_nodes, 1))
        batches.append(tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                             for a in (x, y, yc)))
    req = requests(rs, 64, cfg)
    out = {}
    for decoder in ("stepwise", "sequence"):
        c = dataclasses.replace(cfg, decoder_type=decoder)
        model = MegaCRNx(c, generator=torch.Generator().manual_seed(0),
                         device=dev)
        step = make_megacrnx_train_step(
            model, tcfg, torch.optim.Adam(model.parameters(), lr=tcfg.lr),
            mean, std)
        pred = MegaCRNxPredictor(model, c, mean, std, 64, device=dev)
        res = measure_family(
            f"megacrnx_{decoder}", lambda i: step(*batches[i % 2])[0], sp,
            se, serve=lambda: chunk_ms(pred, req))
        require(sum(res["launches"].values()) + sum(
            res["serve_launches"].values()) == 0,
            f"megacrnx_{decoder} launched an SpMM kernel: {res}")
        out[f"megacrnx_{decoder}"] = res
        del model, step, pred

    small = MegaCRNxConfig(num_nodes=30, horizon=3, seq_len=4, rnn_units=8,
                           mem_num=4, mem_dim=8)
    model = MegaCRNx(small, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    x = requests(rs, 5, small)
    yc = rs.uniform(0.0, 1.0, (5, 3, 30, 1)).astype(np.float32)
    want = MegaCRNxPredictor(model, small, 50.0, 10.0, 8,
                             device="cpu").predict(x, yc)
    got = MegaCRNxPredictor(copy.deepcopy(model), small, 50.0, 10.0, 8,
                            device=dev).predict(x, yc)
    require(got.shape == (5, 3, 30, 1) and np.isfinite(got).all(),
            "small MegaCRNx: bad forecast")
    out["small_card_vs_cpu_max_abs_err"] = close(got, want, 10.0,
                                                  "small MegaCRNx card vs CPU")
    print(f"small MegaCRNx: card vs CPU on the same weights, max abs err "
          f"{out['small_card_vs_cpu_max_abs_err']:.3e}")

    save = os.path.join(d, "cli_megacrnx")
    result, out["cli"] = check_family_cli(
        "cli_megacrnx", sp, se, cli.main,
        ["--dataset", "SYNTH", "--num_nodes", "207", "--epoch", "2",
         "--synth_steps", "2000", "--save_dir", save], save,
        ARTIFACTS + ("src_snapshot",))
    m = result["test_metrics"]
    require(result["epochs_run"] == 2 and all(
        np.isfinite(m[k]) for k in ("mse", "rmse", "mae", "mape", "loss"))
        and np.isfinite(m["per_step"]).all(),
        f"cli_megacrnx: test metrics {m}")
    return out


GTS_ARTIFACTS = (".npz", ".npz.bn", "_logging.txt", "_epochlog.txt",
                 "metrics.jsonl", "src_snapshot")


def phase_gts(sp, se, d, dev):
    """Phase 18: GTS at the METR-LA width (N=207, units 64, diffusion 3,
    embedding 100, batch 64), its training series from the CLI with
    --synth_steps 34272 (METR-LA's length: 0.7 x 34272 -> 23990 steps,
    dim_fc 383,552): 5 train steps with the curriculum and the Gumbel noise
    on, the graph learner's share, the sampled graphs' edges, a served
    chunk; a small model on the card against the CPU, noise off; the CLI
    for 1 epoch at that width."""
    from megacrn_tpu_torch.cli import traintest_gts as cli
    from megacrn_tpu_torch.config import GTSConfig
    from megacrn_tpu_torch.data.synthetic import synthetic_speed_series
    from megacrn_tpu_torch.models.gts import GTS
    from megacrn_tpu_torch.serve import GTSPredictor
    from megacrn_tpu_torch.train.gts_loop import (make_gts_loss_fn,
                                                  make_gts_train_step)

    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    flags = ["--dataset", "SYNTH", "--synth_steps", "34272", "--seed", "0"]
    args = cli.build_parser().parse_args(flags)
    t0 = time.perf_counter()
    values, _ = synthetic_speed_series(args.synth_steps, args.num_nodes)
    feas, prior = cli.train_feas_and_prior(values, args.train_frac,
                                           args.knn_k)
    series_s = time.perf_counter() - t0
    cfg, tcfg = cli.configs_from_args(args, feas.shape[0])
    require((cfg.num_nodes, cfg.rnn_units, cfg.max_diffusion_step,
             cfg.embedding_dim, cfg.train_series_len, cfg.dim_fc,
             tcfg.batch_size) == (207, 64, 3, 100, 23990, 383552, 64),
            "phase 18 is not at the METR-LA width")
    t0 = time.perf_counter()
    model = GTS(cfg, generator=torch.Generator().manual_seed(0), device=dev)
    build_s = time.perf_counter() - t0
    feas_d = torch.tensor(feas, device=dev)
    prior_d = torch.tensor(prior, device=dev)
    mean, std = 45.0, 15.0
    rs = np.random.RandomState(1)

    def windows(b):
        x = np.concatenate([requests(rs, b, cfg), rs.uniform(
            0.0, 1.0, (b, cfg.seq_len, cfg.num_nodes, 1))], -1)
        return x.astype(np.float32)

    batches = []
    for _ in range(2):
        x = windows(64)
        x[..., 0] = (x[..., 0] - mean) / std
        y = (rs.uniform(0.0, 70.0, (64, cfg.horizon, cfg.num_nodes, 1))
             - mean) / std
        batches.append(tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                             for a in (x, y)))
    gen = torch.Generator(device=dev).manual_seed(2)
    step = make_gts_train_step(
        model, tcfg, torch.optim.Adam(model.parameters(), lr=tcfg.lr,
                                      eps=tcfg.epsilon), gen, mean, std,
        feas_d, prior_d)
    require(cfg.use_curriculum_learning, "curriculum learning is off")
    bs0 = half_threshold(cfg)
    out = {"gts": measure_family(
        "gts", lambda i: step(*batches[i % 2], bs0 + i), sp, se)}
    res = out["gts"]
    require(sum(res["launches"].values()) == 0,
            f"gts launched an SpMM kernel: {res['launches']}")
    with torch.no_grad():
        res["graph_learner_fwd_ms"] = host_ms(
            lambda: model.sample_graph(feas_d, gen, training=False))
        res["forward_ms"] = host_ms(lambda: model(
            batches[0][0], feas_d, generator=gen, training=False))
        noisy = int(model.sample_graph(feas_d, gen, training=False)[0].sum())
        argmax = int(model.sample_graph(feas_d, None, training=False)[0]
                     .sum())
    res.update(series_s=series_s, model_build_s=build_s, edges_sampled=noisy,
               edges_argmax=argmax, edges_knn_prior=int(prior.sum()))
    req = windows(64)
    t0 = time.perf_counter()
    pred = GTSPredictor(model, None, cfg, feas, mean, std, 64, device=dev)
    torch.cuda.synchronize()
    res["predictor_graph_s"] = time.perf_counter() - t0
    reset_launches(sp.spmm_coo, se.spmm)  # --- serving, counted ---
    res["chunk_ms"] = chunk_ms(pred, req)
    res["serve_launches"] = read_launches(sp.spmm_coo, se.spmm)
    require(sum(res["serve_launches"].values()) == 0,
            "GTS serving launched an SpMM kernel")
    require(pred.adj.sum().item() == argmax, "the predictor's graph is not "
                                             "the argmax graph")
    print(f"gts: the graph learner's forward {res['graph_learner_fwd_ms']:.3f}"
          f" ms of a {res['forward_ms']:.3f} ms forward (no grad); sampled "
          f"graph {noisy} edges with the Gumbel noise, {argmax} argmax (the "
          f"predictor's), kNN prior {res['edges_knn_prior']}; served chunk "
          f"{res['chunk_ms']:.3f} ms; series and prior {series_s:.2f} s, "
          f"model build {build_s:.2f} s on the host")
    del model, step, pred, batches, feas_d, prior_d

    small = GTSConfig(num_nodes=20, horizon=3, seq_len=4, rnn_units=8,
                      max_diffusion_step=2, embedding_dim=16,
                      train_series_len=100, knn_k=3,
                      use_curriculum_learning=False)
    s_feas = rs.randn(100, 20).astype(np.float32)
    s_prior = cli.train_feas_and_prior(s_feas, 1.0, 3)[1]
    cpu_model = GTS(small, generator=torch.Generator().manual_seed(3),
                    device="cpu")
    card_model = copy.deepcopy(cpu_model).to(dev)
    x = windows(5)[:, :4, :20]
    want = GTSPredictor(copy.deepcopy(cpu_model), None, small, s_feas, 50.0,
                        10.0, 8, device="cpu").predict(x)
    got = GTSPredictor(copy.deepcopy(card_model), None, small, s_feas, 50.0,
                       10.0, 8, device=dev).predict(x)
    out["small_card_vs_cpu_max_abs_err"] = close(got, want, 10.0,
                                                  "small GTS card vs CPU")
    xb = torch.tensor(x) / 10.0
    yb = torch.tensor(rs.randn(5, 3, 20, 1).astype(np.float32))
    grads = []
    for m, where in ((card_model, dev), (cpu_model, torch.device("cpu"))):
        loss = make_gts_loss_fn(
            m, 50.0, 10.0, torch.tensor(s_feas, device=where),
            torch.tensor(s_prior, device=where), gumbel_noise=False)(
            xb.to(where), yb.to(where), 0, None)
        loss.backward()
        grads.append({k: p.grad.cpu() for k, p in m.named_parameters()})
        out.setdefault("small_losses", []).append(loss.item())
    array, elem, err, limit, ratio = worst_element(*grads)
    l_card, l_cpu = out["small_losses"]
    require(ratio <= 1.0 and abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
            f"small GTS train step, card vs CPU: loss {l_card} vs {l_cpu}; "
            f"{array}{list(elem)} |got-want| {err:.3e} over its limit "
            f"{limit:.3e}")
    out["small_grad_err_over_limit"] = ratio
    print(f"small GTS: card vs CPU on the same weights, noise off: served "
          f"max abs err {out['small_card_vs_cpu_max_abs_err']:.3e}; a "
          f"train-mode step's loss {l_card:.8f} vs {l_cpu:.8f}, worst grad "
          f"{array}{list(elem)} |err| {err:.3e} = {ratio:.3f} of its limit "
          f"(rtol {GRAD_TOL[0]:g}, atol {GRAD_TOL[1]:g}*max|g|)")

    save = os.path.join(d, "cli_gts")
    result, out["cli"] = check_family_cli(
        "cli_gts", sp, se, cli.main,
        flags + ["--epochs", "1", "--save_dir", save], save, GTS_ARTIFACTS)
    m = result["test_metrics"]
    require(all(np.isfinite(v) for v in m.values()),
            f"cli_gts: test metrics {m}")
    return out


# --- The mesh (phase 19): parallel/ on torch.distributed, its ranks spawned
# on the one card by parallel.launch. Several ranks share one GPU only over
# gloo (NCCL refuses a duplicate GPU), and every collective of a CUDA tensor
# stages through pinned host memory. Correctness only: the ranks time-share
# the card, so no time here says anything about multi-GPU speed.

# The updated parameters of a mesh run against the single-device run, per
# array: rtol and atol relative to max|p| (GRAD_TOL's numbers).
MESH_TOL = GRAD_TOL


def mesh_batches(cfg, batch, n, seed, kind):
    """n numpy batches of a family, from a seeded RandomState with 2% exact
    zeros: MegaCRN (x, y, y_cov) normalised; MegaCRNx (x normalised, y raw,
    y_cov); GTS (x with its time channel, y) normalised."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (requests(rs, batch, cfg) - 45.0) / 15.0
        y = rs.uniform(0.0, 70.0, (batch, cfg.horizon, cfg.num_nodes, 1))
        if kind == "megacrn":
            y = (y - 45.0) / 15.0
        y[rs.rand(*y.shape) < 0.02] = 0.0
        yc = rs.uniform(0.0, 1.0, (batch, cfg.horizon, cfg.num_nodes, 1))
        if kind == "gts":
            x = np.concatenate([x, rs.uniform(0.0, 1.0, x.shape)], -1)
            out.append(tuple(a.astype(np.float32)
                             for a in (x, (y - 45.0) / 15.0)))
        else:
            out.append(tuple(a.astype(np.float32) for a in (x, y, yc)))
    return out


def _mesh_road(spec, cfg, mesh):
    """The graph constant of a MegaCRN mesh spec: single-device, or cut for
    the mesh's node axis."""
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
    from megacrn_tpu_torch.kernels import spmm as se
    from megacrn_tpu_torch.kernels import spmm_coo as sp
    from megacrn_tpu_torch.kernels import spmm_ell_node as ell
    from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

    road = spec.get("road")
    if road is None:
        return None
    adj = synthetic_road_adjacency(cfg.num_nodes, avg_degree=8, seed=0)
    if road.startswith("meta_"):
        # sparse_meta: the whole pattern (the CLI's: symmetrised, self
        # loops); on a node axis the sharded step cuts each rank's rows.
        from megacrn_tpu_torch.kernels import sparse_graph as sg
        from megacrn_tpu_torch.kernels import sparse_graph_node as sgn

        pat = ((adj != 0) | (adj.T != 0)).astype(np.float32)
        np.fill_diagonal(pat, 1.0)
        if road == "meta_block":
            return sg.build_block_pattern(pat)
        if road == "meta_node_flat":
            return sgn.build_node_pattern(pat, max_buckets=1)
        const = sgn.build_node_pattern_bucketed(pat)
        require(len(const.nbr) > 1, f"{spec['name']}: one bucket")
        return const
    sups = list(dual_random_walk_supports(adj))
    buckets = 1 if road == "node_ell_flat" else 4
    node = mesh is not None and mesh.node > 1
    if road == "coo":
        return sp.build_stacked_road_pack(sups)
    if road == "block_ell":
        return (se.shard_road_packs(sups, mesh.node) if node
                else se.build_road_ell_pairs(sups))
    const = (ell.shard_node_ell(sups, mesh.node, max_buckets=buckets) if node
             else ell.build_stacked_node_ell(sups, max_buckets=buckets))
    want = ((ell.ShardedNodeELL, ell.StackedNodeELL) if buckets == 1 else
            (ell.BucketedShardedNodeELL, ell.BucketedStackedNodeELL))
    require(isinstance(const, want), f"{spec['name']}: {type(const)}")
    return const


def gts_setup(dev, init, dtype="float32"):
    """(cfg, tcfg, model, node_feas, knn_prior) of GTS at the METR-LA width
    (phase 18's: N=207, units 64, diffusion 3, embedding 100, the
    23,990-step training series of --synth_steps 34272), computing in
    ``dtype`` (the series and prior stay f32, as ``fit_gts`` keeps them)."""
    import dataclasses

    from megacrn_tpu_torch.cli import traintest_gts as cli
    from megacrn_tpu_torch.data.synthetic import synthetic_speed_series
    from megacrn_tpu_torch.models.gts import GTS

    args = cli.build_parser().parse_args(
        ["--dataset", "SYNTH", "--synth_steps", "34272", "--seed", "0"])
    values, _ = synthetic_speed_series(args.synth_steps, args.num_nodes)
    feas, prior = cli.train_feas_and_prior(values, args.train_frac,
                                           args.knn_k)
    cfg, tcfg = cli.configs_from_args(args, feas.shape[0])
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    model = GTS(cfg, generator=init, device=dev,
                dtype=getattr(torch, dtype))
    return (cfg, tcfg, model) + tuple(torch.tensor(a, device=dev)
                                      for a in (feas, prior))


def gts_halves_step(model, tcfg, opt, dev, feas, prior, noise, parts=2):
    """The GTS train step as a data-parallel mesh of ``parts`` ranks
    computes it, on one device: each equal batch slice's share of the one
    objective (``parallel.api.make_gts_mesh_train_step``), each slice's
    forward drawing the same Gumbel uniforms and coins from its own
    generator and the running BatchNorm statistics updated once (as on each
    rank), the shares' gradients summed; then the clip and Adam."""
    from megacrn_tpu_torch.ops import losses
    from megacrn_tpu_torch.ops.scaling import inverse_transform
    from megacrn_tpu_torch.train.gts_loop import bce
    from megacrn_tpu_torch.train.optim import clip_gradients

    gens = [torch.Generator(device=dev).manual_seed(2) for _ in range(parts)]
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x, y, batches_seen):
        opt.zero_grad(set_to_none=True)
        den = (inverse_transform(y, 15.0, 45.0) != 0).float().sum()
        rows = x.shape[0] // parts
        total, kept = 0.0, None
        for i, gen in enumerate(gens):
            part = slice(i * rows, (i + 1) * rows)
            out = model(x[part], feas, labels=y[part],
                        batches_seen=batches_seen, generator=gen,
                        training=True, gumbel_noise=noise)
            num, _ = losses.masked_mae_sums(
                inverse_transform(out.output, 15.0, 45.0),
                inverse_transform(y[part], 15.0, 45.0))
            share = (num / den.clamp_min(1.0)
                     + bce(out.adj_prob.reshape(-1), prior.reshape(-1))
                     / parts)
            share.backward()
            total = total + share.detach()
            # After the backward, which reads them: the running statistics
            # as the first slice left them.
            if kept is None:
                kept = {k: v.clone() for k, v in model.named_buffers()}
            else:
                for k, v in model.named_buffers():
                    v.copy_(kept[k])
        clip_gradients(params, tcfg)
        opt.step()
        return total

    return step


def state_over_limit(got, want):
    """(worst |got - want| / limit over the float state arrays, its array),
    the limit MESH_TOL's per-array form."""
    rtol, atol = MESH_TOL
    worst, where = 0.0, None
    for k, w in want.items():
        if np.issubdtype(w.dtype, np.floating):
            limit = rtol * np.abs(w) + atol * max(np.abs(w).max(), 1e-30)
            ratio = float((np.abs(got[k] - w) / limit).max())
            if where is None or ratio > worst:
                worst, where = ratio, k
    return worst, where


def mesh_case(spec, dev, mesh=None):
    """Build the spec's model from its seed and run its train steps, on one
    device (``mesh=None``) or as this rank of ``mesh``, both kernels' counts
    and the collectives' counts set to 0 just before the steps and read
    just after. Returns the losses, the ms of each step (host clock to the
    loss on the host), the peak device memory, the counts, the state after
    the last step (numpy) and its digest."""
    import hashlib

    from megacrn_tpu_torch.kernels import spmm as se
    from megacrn_tpu_torch.kernels import spmm_coo as sp
    from megacrn_tpu_torch.parallel import api, comm
    from megacrn_tpu_torch.parallel.mesh import shard_batch

    kind = spec["kind"]
    gen = torch.Generator(device=dev).manual_seed(2)
    init = torch.Generator().manual_seed(spec.get("seed", 0))
    if kind == "megacrn":
        from megacrn_tpu_torch.config import (model_config_for,
                                              train_config_for)
        from megacrn_tpu_torch.models.megacrn import MegaCRN
        from megacrn_tpu_torch.train.optim import make_optimizer
        from megacrn_tpu_torch.train.steps import make_train_step

        cfg = model_config_for(spec["preset"], graph_backend=spec["backend"])
        tcfg = train_config_for(spec["preset"], **spec["train"])
        model = MegaCRN(cfg, generator=init, device=dev)
        opt = make_optimizer(model.parameters(), tcfg)
        const = _mesh_road(spec, cfg, mesh)
        first = half_threshold(cfg)  # coins of both kinds
        if mesh is None:
            step = make_train_step(model, tcfg, opt, gen,
                                   road_supports=const)
        elif (spec["backend"] == "road_sparse"
              and spec.get("road") != "coo" and mesh.node > 1):
            step = api.make_road_node_train_step(model, tcfg, opt, mesh,
                                                 const, gen)
        elif spec["backend"] == "dense_ring":
            step = api.make_ring_train_step(model, tcfg, opt, mesh, gen)
        elif spec["backend"] == "road_sparse":
            step = api.make_shardmap_train_step(model, tcfg, opt, mesh, gen,
                                                road_supports=const)
        else:
            step = api.make_sharded_train_step(model, tcfg, opt, mesh, gen,
                                               road_supports=const)

        def run(arrays, i):
            return step(*arrays, first + i)
    elif kind == "megacrnx":
        from megacrn_tpu_torch.cli import traintest_megacrnx as cli
        from megacrn_tpu_torch.models.megacrnx import MegaCRNx
        from megacrn_tpu_torch.train.megacrnx_loop import \
            make_megacrnx_train_step

        cfg, tcfg = cli.configs_from_args(cli.build_parser().parse_args([]),
                                          207)
        model = MegaCRNx(cfg, generator=init, device=dev)
        # Adam with eps 1e-3 for the hold: with the protocol's 1e-8 a first
        # step moves each weight by about lr * sign(g), and a gradient
        # within rounding of 0 could take either sign on the two paths.
        opt = torch.optim.Adam(model.parameters(), lr=tcfg.lr, eps=1e-3)
        step = (make_megacrnx_train_step(model, tcfg, opt, 45.0, 15.0)
                if mesh is None else api.make_megacrnx_mesh_train_step(
                    model, tcfg, opt, mesh, 45.0, 15.0))

        def run(arrays, i):
            return step(*arrays)[0]
    else:
        from megacrn_tpu_torch.train.gts_loop import make_gts_train_step

        cfg, tcfg, model, feas_d, prior_d = gts_setup(
            dev, init, spec.get("dtype", "float32"))
        opt = torch.optim.Adam(model.parameters(), lr=tcfg.lr,
                               eps=tcfg.epsilon)
        noise = spec["noise"]
        if mesh is not None:
            step = api.make_gts_mesh_train_step(model, tcfg, opt, mesh, gen,
                                                45.0, 15.0, feas_d, prior_d,
                                                noise)
        elif spec.get("reference") == "halves":
            step = gts_halves_step(model, tcfg, opt, dev, feas_d, prior_d,
                                   noise, spec["mesh"][0])
        else:
            step = make_gts_train_step(model, tcfg, opt, gen, 45.0, 15.0,
                                       feas_d, prior_d, noise)
        first = half_threshold(cfg)

        def run(arrays, i):
            return step(*arrays, first + i)
    batches = mesh_batches(cfg, 64, 2, 0, kind)
    if mesh is not None:
        batches = [shard_batch(b, mesh, nodes=getattr(step, "shard_nodes",
                                                      False))
                   for b in batches]
    dtype = getattr(torch, spec.get("dtype", "float32"))
    batches = [tuple(torch.tensor(a, device=dev, dtype=dtype) for a in b)
               for b in batches]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(sp.spmm_coo, se.spmm)  # --- this path, counted ---
    comm.reset_counts()
    losses, ms = [], []
    for i in range(spec["steps"]):
        t0 = time.perf_counter()
        losses.append(run(batches[i % 2], i).item())
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = read_launches(sp.spmm_coo, se.spmm)  # --- read just after ---
    state = {k: v.detach().cpu().numpy()
             for k, v in model.state_dict().items()}
    digest = hashlib.sha256()
    for k in sorted(state):
        digest.update(k.encode() + state[k].tobytes())
    return {"losses": losses, "ms": ms, "launches": launches,
            "peak_GiB": torch.cuda.max_memory_allocated() / 2**30,
            "calls": dict(comm.calls), "staged": dict(comm.staged),
            "state": state, "digest": digest.hexdigest()}


def mesh_ranks(specs, out_dir):
    """One spawned rank of the mesh phase: every spec on its mesh (a spec
    with ``cli`` runs that CLI's main inside this group, counted); its
    results go to ``out_dir/rank{r}.pkl`` (the state only from rank 0)."""
    import importlib
    import pickle

    from megacrn_tpu_torch.kernels import spmm as se
    from megacrn_tpu_torch.kernels import spmm_coo as sp
    from megacrn_tpu_torch.parallel import comm
    from megacrn_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = torch.distributed.get_rank()
    results = {}
    for spec in specs:
        if "cli" in spec:
            reset_launches(sp.spmm_coo, se.spmm)  # --- this path, counted ---
            comm.reset_counts()
            t0 = time.perf_counter()
            importlib.import_module(spec["cli"]).main(spec["argv"])
            torch.cuda.synchronize()
            results[spec["name"]] = {
                "launches": read_launches(sp.spmm_coo, se.spmm),
                "wall_s": time.perf_counter() - t0,
                "calls": dict(comm.calls), "staged": dict(comm.staged)}
            continue
        res = mesh_case(spec, dev, make_mesh(*spec["mesh"]))
        if rank != 0:
            del res["state"]
        results[spec["name"]] = res
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def hold_mesh(name, ranks, single, kernel=None):
    """A mesh run's ranks against the single-device run: the same losses
    and state on every rank; losses (rtol) and each state array (rtol,
    atol relative to its max|p|) within MESH_TOL of the single-device run;
    ``kernel``'s count non-zero on every rank. Returns the numbers."""
    r0 = ranks[0][name]
    for r, res in enumerate(ranks):
        require(res[name]["losses"] == r0["losses"]
                and res[name]["digest"] == r0["digest"],
                f"mesh {name}: rank {r} differs from rank 0")
    np.testing.assert_allclose(r0["losses"], single["losses"],
                               rtol=MESH_TOL[0],
                               err_msg=f"mesh {name}: losses")
    for k, want in single["state"].items():
        if not np.issubdtype(want.dtype, np.floating):
            require(np.array_equal(r0["state"][k], want),
                    f"mesh {name}: {k}")
    worst, where = state_over_limit(r0["state"], single["state"])
    require(worst <= 1.0, f"mesh {name}: {where} off by {worst:.3f} of its "
                          f"limit")
    counts = [res[name]["launches"] for res in ranks]
    if kernel is not None:
        require(all(c[kernel] > 0 for c in counts),
                f"mesh {name}: a rank launched no {kernel}: {counts}")
    out = {"losses": r0["losses"], "single_losses": single["losses"],
           "worst_over_limit": worst, "worst_array": where,
           "launches_per_rank": counts,
           "single_launches": single["launches"],
           "ms_per_step_per_rank": [float(np.median(res[name]["ms"]))
                                    for res in ranks],
           "peak_GiB_per_rank": [res[name]["peak_GiB"] for res in ranks],
           "single_ms": float(np.median(single["ms"])),
           "calls_rank0": r0["calls"], "staged_rank0": r0["staged"],
           "calls_per_step_rank0": {k: v / len(r0["losses"])
                                    for k, v in r0["calls"].items()}}
    print(f"mesh {name}: losses {[round(v, 6) for v in r0['losses']]} vs "
          f"single {[round(v, 6) for v in single['losses']]}, worst state "
          f"element {worst:.4g} of its limit; ms a step per rank "
          f"{[round(v, 1) for v in out['ms_per_step_per_rank']]} (single "
          f"{out['single_ms']:.1f}); peak GiB per rank "
          f"{[round(v, 3) for v in out['peak_GiB_per_rank']]}; launches per "
          f"rank {counts} (single {single['launches']}); collectives rank 0 "
          f"{r0['calls']} ({out['calls_per_step_rank0']} a step), staged "
          f"through host {r0['staged']}")
    return out


def phase_mesh(sp, se, d, dev):
    """Phase 19: the mesh, two spawns of ranks on the card through
    ``parallel.launch``, each step held against the single-device step on
    the card (MESH_TOL). (a) data parallel at the EXPY-TKY width on (2, 1),
    road_sparse through the block-COO kernel, 5 steps; (c) MegaCRNx and GTS
    (f64 and f32) data parallel at the METR-LA width on (2, 1), 3 steps
    each; then on a (2, 3) mesh, six ranks: (b) the node partition at the
    METR-LA width (N=207, 69 nodes a rank), 3 steps each on block-ELL
    packs, node-ELL flat and bucketed, dense and dense_ring; (d) one CLI
    epoch each of ``traintest --dataset SYNTH`` with ``road_sparse`` and
    ``dense_ring`` on (2, 3), their test metrics read from rank 0's
    metrics.jsonl."""
    import pickle

    from megacrn_tpu_torch.parallel import launch

    require(not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")
    expy = dict(kind="megacrn", preset="EXPYTKY", backend="road_sparse",
                road="coo", steps=5, mesh=(2, 1),
                # EXPY-TKY's protocol with Adam's eps at 1e-3 and the clip
                # at 5 (see mesh_case's MegaCRNx note on eps 1e-8).
                train={"epsilon": 1e-3, "max_grad_norm": 5.0})
    spawn_a = [dict(expy, name="a_dp_expytky_road_sparse_coo"),
               dict(kind="megacrnx", name="c_dp_megacrnx", steps=3,
                    mesh=(2, 1)),
               # GTS is held in f64 against the unchanged whole-batch
               # single-device step: its extractor gradients (conv2, bn1)
               # are sums that cancel below f32 rounding at this width, so
               # in f32 two summation orders of one batch on one device
               # differ by more than GRAD_TOL (the distance is printed).
               dict(kind="gts", name="c_dp_gts_f64", steps=3, mesh=(2, 1),
                    noise=True, dtype="float64"),
               # And in f32 against the single-device step that sums the
               # two half batches' shares as the mesh does.
               dict(kind="gts", name="c_dp_gts", steps=3, mesh=(2, 1),
                    noise=True, reference="halves")]
    metr = dict(kind="megacrn", preset="METRLA", steps=3, mesh=(2, 3),
                train={})
    spawn_b = [dict(metr, name="b_node_block_ell", backend="road_sparse",
                    road="block_ell"),
               dict(metr, name="b_node_ell_flat", backend="road_sparse",
                    road="node_ell_flat"),
               dict(metr, name="b_node_ell_bucketed", backend="road_sparse",
                    road="node_ell_bucketed"),
               dict(metr, name="b_node_dense", backend="dense"),
               dict(metr, name="b_node_dense_ring", backend="dense_ring")]
    # sparse_meta: each rank's rows of the learned edge pattern (69 of 207).
    spawn_b += [dict(metr, name=f"b_node_sparse_meta_{impl}",
                     backend="sparse_meta", road=f"meta_{impl}")
                for impl in ("node_flat", "node_bucketed", "block")]
    cli_base = ["--dataset", "SYNTH", "--synth_steps", "1000", "--epochs",
                "1", "--seed", "0", "--mesh_data", "2", "--mesh_node", "3"]
    for backend in ("road_sparse", "dense_ring"):
        spawn_b.append(dict(
            name=f"d_cli_{backend}", cli="megacrn_tpu_torch.cli.traintest",
            argv=cli_base + ["--graph_backend", backend, "--save_dir",
                             os.path.join(d, f"mesh_cli_{backend}")]))
    t0 = time.perf_counter()
    singles = {s["name"]: mesh_case(s, dev) for s in spawn_a + spawn_b
               if "cli" not in s}
    gts = next(s for s in spawn_a if s["name"] == "c_dp_gts")
    gts_order = state_over_limit(
        mesh_case(dict(gts, reference="whole"), dev)["state"],
        singles[gts["name"]]["state"])
    print(f"mesh: GTS on one device, the whole batch against its two "
          f"halves' shares after {gts['steps']} steps: {gts_order[0]:.4f} "
          f"of MESH_TOL ({gts_order[1]})")
    print(f"mesh: single-device references {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = {}
    for world, specs in ((2, spawn_a), (6, spawn_b)):
        where = os.path.join(d, f"mesh_ranks_{world}")
        os.makedirs(where)
        t0 = time.perf_counter()
        launch.spawn(mesh_ranks, world, args=(specs, where), device="cuda")
        print(f"mesh: {world} ranks on the card, "
              f"{time.perf_counter() - t0:.1f} s for the spawn and its runs")
        ranks = []
        for r in range(world):
            with open(os.path.join(where, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
        for spec in specs:
            name = spec["name"]
            if "cli" in spec:
                counts = [res[name]["launches"] for res in ranks]
                records = fit_records(name, spec["argv"][-1])
                final = [r for r in records if "final_test" in r]
                require(len(final) == 1 and all(
                    np.isfinite(v) for v in final[0]["final_test"].values()),
                    f"{name}: final test metrics {final}")
                if "road_sparse" in name:
                    require(all(c["spmm_ell"] > 0 for c in counts),
                            f"{name}: a rank launched no spmm_ell: {counts}")
                out[name] = {"launches_per_rank": counts,
                             "wall_s": ranks[0][name]["wall_s"],
                             "calls_rank0": ranks[0][name]["calls"],
                             "staged_rank0": ranks[0][name]["staged"],
                             "final_test": final[0]["final_test"]}
                print(f"mesh {name}: wall {out[name]['wall_s']:.2f} s, "
                      f"launches per rank {counts}, collectives rank 0 "
                      f"{out[name]['calls_rank0']}, staged "
                      f"{out[name]['staged_rank0']}, final test "
                      f"{json.dumps(final[0]['final_test'])}")
                continue
            kernel = {"coo": "spmm_coo", "block_ell": "spmm_ell"}.get(
                spec.get("road"))
            out[name] = hold_mesh(name, ranks, singles[name], kernel)
    out[gts["name"]]["whole_vs_halves_over_limit"] = gts_order
    a = out["a_dp_expytky_road_sparse_coo"]
    require(all(c["spmm_coo"] == a["single_launches"]["spmm_coo"]
                for c in a["launches_per_rank"]),
            f"mesh (a): spmm_coo per rank {a['launches_per_rank']} against "
            f"the single-device step's {a['single_launches']}")
    return out


# --- Phase 20: the offline workflow at the METR-LA width (N=207, 12->12,
# units 64, memory 20x64): generate_data -> traintest on road_sparse (the
# block-COO kernel) with directory checkpoints -> resume -> summary; then
# the host-side utilities on fit (a)'s EXPY-TKY arrays: device_prefetch,
# the host library, checkified.

# The generated series is the depth: 4,000 five-minute steps give 2,784
# train windows, 44 train steps an epoch at batch 64 (METR-LA has 34,272).
OFFLINE_STEPS = 4000
PREFETCH_STEPS = 20


def _epochs(records):
    return [r for r in records if "val" in r]


def offline_runs(sp, se, d, data_dir, adj_path):
    """(b): ``traintest`` on the generated splits through the block-COO
    kernel with ``--ckpt_backend orbax``: 2 epochs in one go, and 1 epoch
    then ``--resume`` for the 2nd; the resumed run held to the
    uninterrupted one as fit (c) holds ``.npz``."""
    from megacrn_tpu_torch.cli import traintest

    base = ["--dataset", "METRLA", "--data_dir", data_dir,
            "--graph_backend", "road_sparse", "--adj_path", adj_path,
            "--ckpt_backend", "orbax", "--seed", "0"]
    cfg, tcfg = traintest.configs_from_args(
        traintest.build_parser().parse_args(base))
    require((cfg.num_nodes, cfg.seq_len, cfg.horizon, cfg.rnn_units,
             cfg.mem_num, cfg.mem_dim, tcfg.batch_size)
            == (207, 12, 12, 64, 20, 64, 64),
            "phase 20 is not at the METR-LA width")
    whole_dir, cut_dir = (os.path.join(d, f"offline_{k}")
                          for k in ("whole", "cut"))
    runs = {}
    for name, flags, save in (("whole_2_epochs", ["--epochs", "2"],
                               whole_dir),
                              ("first_epoch", ["--epochs", "1"], cut_dir),
                              ("resumed_epoch", ["--epochs", "2",
                                                 "--resume"], cut_dir)):
        result, launches, wall, peak = run_cli(
            sp, se, base + flags + ["--save_dir", save])
        require(launches["spmm_coo"] > 0,
                f"phase 20 {name}: no spmm_coo launch: {launches}")
        require(launches["spmm_ell"] == 0, f"phase 20 {name}: spmm_ell")
        runs[name] = (result, launches, wall, peak)
    records = {}
    for name, save in (("whole", whole_dir), ("cut", cut_dir)):
        records[name] = fit_records(f"phase 20 {name}", save)
        run = run_dir_of(save)
        (ckpt,) = [f for f in os.listdir(run) if f.endswith(".npz")]
        require(os.path.isfile(os.path.join(run, ckpt, ".metadata")),
                f"phase 20 {name}: {ckpt} is no checkpoint directory")
    whole, cut = (_epochs(records[k]) for k in ("whole", "cut"))
    require([r["epoch"] for r in cut] == [1, 2],
            "phase 20: the resumed run did not continue its run dir")
    loss_diff = max(
        abs(c[k] - w[k]) / max(abs(w[k]), 1e-30)
        for c, w in ((cut[1], whole[1]), (cut[1]["val"], whole[1]["val"]))
        for k in (("train_loss",) if "train_loss" in w else w))
    worst, worst_key = 0.0, None
    want = runs["whole_2_epochs"][0]["params"]
    got = runs["resumed_epoch"][0]["params"]
    for k, p in want.items():
        rel = float(np.abs(got[k] - p).max() / max(np.abs(p).max(), 1e-30))
        if rel >= worst:
            worst, worst_key = rel, k
    print(f"phase 20 (b): resumed 1 -> 2 epochs vs 2 in one go: epoch-2 "
          f"losses within {loss_diff:.3e} relative, params within "
          f"{worst:.3e} of max|p| ({worst_key})")
    require(loss_diff <= RESUME_TOL and worst <= RESUME_TOL,
            f"phase 20: the resumed run differs (losses {loss_diff:.3e}, "
            f"params {worst:.3e} at {worst_key}; limit {RESUME_TOL:g})")
    for name, recs in (("whole", records["whole"]),
                       ("cut", records["cut"])):
        print_epochs(f"phase 20 {name}", recs)
    out = {name: {"launches": launches, "wall_s": wall, "peak_GiB": peak}
           for name, (_, launches, wall, peak) in runs.items()}
    out["sec_per_step"] = [r["sec_per_step"] for r in whole]
    out["resumed_sec_per_step"] = cut[1]["sec_per_step"]
    out["upload_s"] = [r["upload_seconds"] for r in whole]
    out["resume_loss_rel_diff"] = loss_diff
    out["resume_param_rel_diff"] = worst
    out["test_mae"] = runs["whole_2_epochs"][0]["test_metrics"]["mae"]
    for name, res in out.items():
        if isinstance(res, dict):
            print(f"phase 20 (b) {name}: wall {res['wall_s']:.2f} s, "
                  f"launches {res['launches']}, peak {res['peak_GiB']:.3f} "
                  f"GiB")
    print(f"phase 20 (b): sec/step {out['sec_per_step']} (resumed epoch "
          f"{out['resumed_sec_per_step']:.5f}), host upload s an epoch "
          f"{out['upload_s']}, test mae {out['test_mae']:.4f}")
    return out


def prefetch_runs(step, loader, cfg, dev):
    """(d): PREFETCH_STEPS train steps fed from fit (a)'s loader, plain
    (``train.loop.to_device``, as fit feeds the card) and through
    ``device_prefetch``, in turns; the same batches both ways."""
    import itertools

    from megacrn_tpu_torch.data.loader import prepare_x_y
    from megacrn_tpu_torch.train.loop import to_device
    from megacrn_tpu_torch.train.prefetch import device_prefetch

    def host_batches():
        for epoch in itertools.count():
            loader.set_epoch(epoch)
            for x, y in loader:
                yield prepare_x_y(x, y, cfg.input_dim, cfg.output_dim)

    def feed(prefetch):
        src = itertools.islice(host_batches(), PREFETCH_STEPS)
        if prefetch:
            return device_prefetch(src, device=dev)
        return (to_device(b, dev) for b in src)

    def run(prefetch):
        torch.cuda.synchronize()
        it, losses, fetch_s = feed(prefetch), [], 0.0
        t0 = time.perf_counter()
        for i in range(PREFETCH_STEPS):
            t_f = time.perf_counter()
            batch = next(it)
            fetch_s += time.perf_counter() - t_f
            losses.append(step(*batch, i))
        torch.stack(losses).cpu()
        total = time.perf_counter() - t0
        return 1e3 * total / PREFETCH_STEPS, 1e3 * fetch_s / PREFETCH_STEPS

    run(False)  # warm-up
    times = {"plain": [], "prefetch": []}
    for prefetch in (False, True, True, False):
        ms, fetch = run(prefetch)
        times["prefetch" if prefetch else "plain"].append((ms, fetch))
    same = all(
        torch.equal(a, b) for pa, pb in zip(feed(False), feed(True))
        for a, b in zip(pa, pb))
    torch.cuda.synchronize()
    require(same, "phase 20 (d): the prefetched batches differ")
    out = {k: {"ms_per_step": [t[0] for t in v],
               "host_fetch_ms_per_step": [t[1] for t in v]}
           for k, v in times.items()}
    print(f"phase 20 (d): {PREFETCH_STEPS} EXPY-TKY block-COO train steps "
          f"fed from the loader, ms a step (host clock, one sync at the "
          f"end) plain {out['plain']['ms_per_step']} vs device_prefetch "
          f"{out['prefetch']['ms_per_step']}; host ms a step to get a "
          f"batch (loader, prepare, upload) plain "
          f"{out['plain']['host_fetch_ms_per_step']} vs prefetch "
          f"{out['prefetch']['host_fetch_ms_per_step']}; batches equal")
    return out


def native_runs(month, xs):
    """(e): the host library against numpy on fit (a)'s arrays: the
    windows of one EXPY-TKY month (his 6 + seq 6) and the train windows'
    reshuffle gather; bit-equal results, host ms (median of 5)."""
    from megacrn_tpu_torch.data import native

    require(native.available(), "phase 20 (e): the host library did not "
                                "build (g++ and native/megacrn_data.cc)")
    anchors = np.arange(0, month.shape[0] - 12 + 1)
    offsets = np.arange(12)
    perm = np.random.default_rng(0).permutation(len(xs))
    out = {}
    for name, fn, plain in (
            ("window_gather", lambda: native.window_gather(month, anchors,
                                                           offsets),
             lambda: month[anchors[:, None] + offsets[None, :]]),
            ("index_gather", lambda: native.index_gather(xs, perm),
             lambda: xs[perm])):
        require(np.array_equal(fn(), plain()),
                f"phase 20 (e): {name} differs from numpy")
        ms = []
        for f in (fn, plain):
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                f()
                times.append(1e3 * (time.perf_counter() - t0))
            ms.append(float(np.median(times)))
        nbytes = fn().nbytes
        out[name] = {"native_ms": ms[0], "numpy_ms": ms[1],
                     "speedup": ms[1] / ms[0], "out_MB": nbytes / 1e6}
        print(f"phase 20 (e): {name} of {nbytes / 1e6:.1f} MB: native "
              f"{ms[0]:.3f} ms, numpy {ms[1]:.3f} ms, speed-up "
              f"{ms[1] / ms[0]:.2f}x; bit-equal")
    return out


def checkified_runs(step, batch):
    """(f): the train step under ``checkified`` on a finite batch (its ms
    with and without the wrapper), then with a NaN put into x: it must
    raise, naming the op."""
    from megacrn_tpu_torch.train.debug import checkified

    x, y, yc = batch
    plain = host_ms(lambda: step(x, y, yc, 0).item(), reps=3)
    checked = host_ms(lambda: checkified(step)(x, y, yc, 0).item(), reps=2)
    bad = x.clone()
    bad[0, 0, 0, 0] = float("nan")
    try:
        checkified(step)(bad, y, yc, 0)
        raised = None
    except FloatingPointError as e:
        raised = str(e)
    require(raised is not None and "nan generated by op" in raised,
            f"phase 20 (f): a NaN in x did not raise: {raised}")
    print(f"phase 20 (f): a finite train step {plain:.3f} ms, under "
          f"checkified {checked:.3f} ms; with a NaN in x: {raised}")
    return {"step_ms": plain, "checkified_ms": checked, "raised": raised}


def phase_offline(sp, se, d, dev, stacked):
    """Phase 20: (a) ``generate_data --synthetic`` at N=207; (b)
    ``offline_runs``; (c) ``summary`` of each family at its full width;
    (d)-(f) on the fit (a) configuration (EXPY-TKY, the block-COO
    ``stacked`` pack): ``prefetch_runs``, ``native_runs``,
    ``checkified_runs``."""
    import io

    from megacrn_tpu_torch.cli import generate_data, summary, traintest
    from megacrn_tpu_torch.data.loader import prepare_x_y
    from megacrn_tpu_torch.data.synthetic import (synthetic_road_adjacency,
                                                  synthetic_speed_series)
    from megacrn_tpu_torch.data.windowing import weekday_slot
    from megacrn_tpu_torch.models.megacrn import MegaCRN
    from megacrn_tpu_torch.train.loop import to_device
    from megacrn_tpu_torch.train.optim import make_optimizer
    from megacrn_tpu_torch.train.steps import make_train_step

    out = {}
    data_dir = os.path.join(d, "metrla_synth")
    t0 = time.perf_counter()
    generate_data.main(["--synthetic", "--num_nodes", "207", "--num_steps",
                        str(OFFLINE_STEPS), "--output_dir", data_dir])
    out["generate_s"] = time.perf_counter() - t0
    shapes = {}
    for cat in ("train", "val", "test"):
        with np.load(os.path.join(data_dir, f"{cat}.npz")) as z:
            require(z["x"].shape[1:] == z["y"].shape[1:] == (12, 207, 2)
                    and np.isfinite(z["x"]).all(),
                    f"phase 20 (a): {cat}.npz x {z['x'].shape}")
            shapes[cat] = z["x"].shape[0]
    out["windows"] = shapes
    print(f"phase 20 (a): generate_data --synthetic N=207, "
          f"{OFFLINE_STEPS} steps: windows {shapes}, "
          f"{out['generate_s']:.2f} s")
    adj_path = os.path.join(d, "metr-la_adj01.npy")
    np.save(adj_path, synthetic_road_adjacency(207, avg_degree=8, seed=0))
    out["traintest"] = offline_runs(sp, se, d, data_dir, adj_path)

    out["summary"] = {}
    for family in ("MEGACRN", "MEGACRNX", "GTS"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            count = summary.main(["--model", family])
        lines = buf.getvalue().splitlines()
        require(lines[0].startswith("forward output shape: (2, 12, 207, 1)")
                and count > 0, f"phase 20 (c): {family}: {lines[:2]}")
        out["summary"][family] = count
        print(f"phase 20 (c): summary {family}: {lines[0]}; {count} "
              f"trainable parameters in {len(lines) - 4} arrays")

    # (d)-(f) on fit (a)'s configuration and data.
    args = traintest.build_parser().parse_args(
        ["--dataset", "EXPYTKY", "--graph_backend", "road_sparse",
         "--seed", "0"])
    cfg, tcfg = traintest.configs_from_args(args)
    data = traintest._load_expytky_data(args, cfg, tcfg)
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                    device=dev)
    step = make_train_step(model, tcfg,
                           make_optimizer(model.parameters(), tcfg),
                           torch.Generator(device=dev).manual_seed(2),
                           road_supports=stacked)
    reset_launches(sp.spmm_coo, se.spmm)  # --- this path, counted ---
    out["prefetch"] = prefetch_runs(step, data["train_loader"], cfg, dev)
    out["prefetch"]["launches"] = read_launches(
        sp.spmm_coo, se.spmm)  # --- read just after ---
    # The first month of fit (a)'s synthetic EXPY-TKY data
    # (datasets.build_expytky_synthetic), its weekdaytime channel beside.
    values, index = synthetic_speed_series(600, cfg.num_nodes,
                                           interval_minutes=10, seed=0,
                                           start="2021-10-01")
    wdt = weekday_slot(index, 10)
    month = np.stack([values, np.tile((wdt / wdt.max())[:, None],
                                      (1, cfg.num_nodes))],
                     axis=-1).astype(np.float32)
    out["native"] = native_runs(month, data["train_loader"].xs)
    x, y = next(iter(data["train_loader"]))
    batch = to_device(prepare_x_y(x, y, cfg.input_dim, cfg.output_dim), dev)
    out["checkified"] = checkified_runs(step, batch)
    return out


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
    adj = synthetic_road_adjacency(cfg.num_nodes, avg_degree=8, seed=0)
    sups = list(dual_random_walk_supports(adj))
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
    with tempfile.TemporaryDirectory() as d:
        fit_a = phase_fit_kernel(sp, se, d, train["stacked_coo"]["ms"])
        fit_b = phase_fit_dense(sp, se, d)
        fit_c = phase_fit_resume(sp, se, d, fit_b["save"])
        # The graph backends slice.
        node_ell = phase_node_ell(sp, se, cfg, tcfg, sups, stacked, dev,
                                  train["stacked_coo"]["ms"])
        large = phase_node_ell_large(sp, se, dev)
        smeta = phase_sparse_meta(sp, se, cfg, tcfg, adj, dev)
        dense = phase_dense_stacked(sp, se, dev)
        remat = phase_remat(sp, se, cfg, tcfg, stacked, dev)
        cli = phase_cli_new_flags(sp, se, d,
                                  os.path.join(d, "expy-tky_adj01.npy"))
        # The two other model families.
        megacrnx = phase_megacrnx(sp, se, d, dev)
        gts = phase_gts(sp, se, d, dev)
        # The mesh.
        mesh = phase_mesh(sp, se, d, dev)
        # The offline workflow and the host utilities.
        offline = phase_offline(sp, se, d, dev, stacked)
    # Each path's counts as read just after it (measured, zeros included).
    by_path = {"serving_3_requests": serving,
               "train_stacked_coo_5_steps": train["stacked_coo"]["launches"],
               "train_block_ell_5_steps": train["block_ell"]["launches"],
               "fit_a_expytky_road_sparse_2_epochs": fit_a["launches"],
               "fit_b_metrla_dense_1_epoch": fit_b["launches"],
               "fit_c_metrla_dense_2_epochs": fit_c["launches_whole"],
               "fit_c_metrla_dense_resumed_epoch": fit_c["launches_resumed"]}
    paths = dict(node_ell["paths"], **smeta["paths"], **dense, **remat)
    paths[f"node_ell_N{large['n']}_batch{large['batch']}"] = large
    for name, res in paths.items():
        steps = 3 if name.startswith("node_ell_N") else 5
        by_path[f"train_{name}_{steps}_steps"] = res["launches"]
    for name, res in cli.items():
        by_path[f"{name}_1_epoch"] = res["launches"]
    for name in ("megacrnx_stepwise", "megacrnx_sequence"):
        by_path[f"train_{name}_5_steps"] = megacrnx[name]["launches"]
        by_path[f"serve_{name}_chunk"] = megacrnx[name]["serve_launches"]
    by_path["cli_megacrnx_synth_2_epochs"] = megacrnx["cli"]["launches"]
    by_path["train_gts_5_steps"] = gts["gts"]["launches"]
    by_path["serve_gts_chunk"] = gts["gts"]["serve_launches"]
    by_path["cli_gts_synth_1_epoch"] = gts["cli"]["launches"]
    for name in ("whole_2_epochs", "first_epoch", "resumed_epoch"):
        by_path[f"offline_traintest_metrla_{name}"] = offline["traintest"][
            name]["launches"]
    by_path[f"prefetch_expytky_{5 * PREFETCH_STEPS}_steps"] = offline[
        "prefetch"]["launches"]
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
    # The mesh paths' launches, per rank (each rank's counts set to 0 just
    # before its steps and read just after).
    coo["mesh_launches_per_rank"] = {
        "a_dp_expytky_road_sparse_coo_5_steps":
            mesh["a_dp_expytky_road_sparse_coo"]["launches_per_rank"]}
    ell["mesh_launches_per_rank"] = {
        "b_node_block_ell_3_steps": mesh["b_node_block_ell"][
            "launches_per_rank"],
        "d_cli_road_sparse_1_epoch": mesh["d_cli_road_sparse"][
            "launches_per_rank"]}
    # The main path is now the traintest CLI (fit (a)): the COO kernel's
    # launches are that run's.
    coo["launches"] = fit_a["launches"]["spmm_coo"]
    coo["fit_sec_per_step"] = fit_a["sec_per_step"]

    # The new paths and their ops (plain PyTorch, no hand-written kernel):
    # per-step and per-op numbers for PERF.md.
    keys = ("step_ms", "busy_ms", "idle_share", "device_kernels", "peak_GiB",
            "chunk_ms", "hold_worst", "applications_per_step")
    print(json.dumps({"paths": {
        name: {k: res[k] for k in keys if k in res}
        for name, res in paths.items()}, "cli": cli,
        "auto": {"picks": node_ell["auto"], "step_ms": node_ell["auto_ms"]},
        "node_ell_large": {k: large[k] for k in (
            "n", "batch", "dense_supports_s", "pack_build_s", "pack")},
        "node_ell_pack_build_s": node_ell["build_s"]}))
    calls = smeta["calls_per_step"]
    for row in smeta["ops"]:
        if row["op"] in calls:
            row["calls_per_step"] = calls[row["op"]]
            row["launches_per_step"] = calls[row["op"]] * (
                row["device_kernels"] + row.get("backward_device_kernels", 0))
    for row in node_ell["ops"]:
        row["launches_per_step"] = (row["applications_per_step"]
                                    * row["device_kernels"])
    print(json.dumps({"xla_paths": node_ell["ops"] + smeta["ops"]}))
    # The two families' paths (plain PyTorch, no hand-written kernel), and
    # phase 7's gradient holds.
    fam_keys = keys + ("graph_learner_fwd_ms", "forward_ms", "edges_sampled",
                       "edges_argmax", "edges_knn_prior", "series_s",
                       "model_build_s", "predictor_graph_s")
    print(json.dumps({"families": {
        name: {k: res[k] for k in fam_keys if k in res}
        for name, res in (("megacrnx_stepwise", megacrnx["megacrnx_stepwise"]),
                          ("megacrnx_sequence", megacrnx["megacrnx_sequence"]),
                          ("gts", gts["gts"]))},
        "cli_megacrnx_2_epochs": megacrnx["cli"],
        "cli_gts_1_epoch": gts["cli"],
        "small_card_vs_cpu_max_abs_err": {
            "megacrnx": megacrnx["small_card_vs_cpu_max_abs_err"],
            "gts": gts["small_card_vs_cpu_max_abs_err"]},
        "small_gts_grad_err_over_limit": gts["small_grad_err_over_limit"],
        "grad_holds": {kind: train[kind]["holds"] for kind in train}}))
    print(json.dumps({"mesh": {
        name: {k: v for k, v in res.items() if k != "final_test"}
        for name, res in mesh.items()}}, default=float))
    print(json.dumps({"offline": offline}, default=float))
    print(json.dumps({"kernels": [coo, ell]}, default=float))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
