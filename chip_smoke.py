"""Drive the PyTorch/CUDA port (megacrn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py        # from the root of a checkout; needs a card

Phases (any failure exits nonzero; nothing is caught and skipped):

1. Device: require CUDA, print the card's name and power limit, pin TF32 off.
2. Build the port's CUDA kernel from ``megacrn_tpu_torch/kernels/csrc`` with
   nvcc, print the build seconds and ptxas report.
3. The kernel against its plain PyTorch version on the card, in f32 and
   bf16, at edge shapes and at the shapes of the serving path, with times
   (CUDA events), the bound from bytes and the nonzeros' operations, and a
   one-call library yardstick, a sparse CSR product (timed only; the port
   never calls it).
4. The serving path: the EXPY-TKY preset MegaCRN (N=1843, 6->6, batch 64) on
   the road_sparse backend over the synthetic road graph, weights from a
   seed, written as a JAX-format checkpoint and served through
   ``Predictor.from_checkpoint``. Three requests (1, 64, 100 windows), the
   kernel launch count checked per chunk, forecasts checked against the
   same model on the plain SpMM, and a small model checked against the CPU.
5. Streaming: ``StreamingForecaster`` answers once its window is warm.
6. Dense branch: the METR-LA preset (learned meta-graph, no kernel) served
   once and checked against the CPU.

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
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}
SLICE_WIDTHS = {"enc_gate": 64 * 33, "enc_cand": 64 * 32,
                "dec_gate": 64 * 66, "dec_cand": 64 * 64}


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def cuda_ms(fn, iters=10, warmup=2):
    """Mean ms per call over ``iters`` calls, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def spmm_bound(pack, f, dtype):
    """(bound_ms, bound_by) of y = A @ x: each input read once (the stored
    tiles, x, the indices), the output written once, and 2*f flops for each
    nonzero of A in this run's data (zeros inside a stored tile are no
    work the function needs)."""
    es = torch.tensor([], dtype=dtype).element_size()
    tiles = pack.data.shape[0]
    flops = 2.0 * int((pack.data != 0).sum().item()) * f
    nbytes = (tiles * 128 * 128 * es + pack.col_dim_orig * f * es
              + pack.n_orig * f * es
              + 4 * (2 * tiles + pack.row_ptr.numel()))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def csr_of(pack):
    """The matrix a BlockCOO pack holds, as a torch sparse CSR tensor of its
    original dims (the library yardstick's input; built from the tiles)."""
    nblk, ncblk = pack.n // 128, pack.col_dim // 128
    tiles = pack.data.new_zeros((nblk, ncblk, 128, 128))
    tiles[pack.rows.long(), pack.cols.long()] = pack.data
    dense = tiles.permute(0, 2, 1, 3).reshape(pack.n, pack.col_dim)
    return dense[:pack.n_orig, :pack.col_dim_orig].contiguous().to_sparse_csr()


def check_spmm(sp, name, pack, x, csr):
    """Kernel vs plain version on one input; returns a result dict.
    ``csr``: A as a sparse CSR tensor for the library yardstick, one
    ``csr @ x`` (cuSPARSE), checked against the plain version too."""
    got = sp.spmm_coo(pack, x)
    want = sp.spmm_coo_reference(pack, x)
    lib = csr @ x
    torch.cuda.synchronize()
    rtol, atol_rel = TOL[x.dtype]
    g, w = got.float(), want.float()
    require(g.shape == w.shape and torch.isfinite(g).all().item(),
            f"spmm_coo {name}: bad shape or non-finite output")
    err = (g - w).abs()
    atol = atol_rel * w.abs().max().item()
    ok = bool((err <= atol + rtol * w.abs()).all().item())
    res = {"name": name, "dtype": str(x.dtype).replace("torch.", ""),
           "f": x.shape[1], "max_abs_err": err.max().item(),
           "library_max_abs_err": (lib.float() - w).abs().max().item(),
           "tol": f"rtol {rtol:g}, atol {atol_rel:g}*max|y|"}
    require(ok, f"spmm_coo {name} {res['dtype']}: kernel disagrees with "
                f"the plain version, max abs err {res['max_abs_err']:.3e}")
    lib_ok = lib.shape == w.shape and (
        x.dtype != torch.float32 or bool(
            ((lib - w).abs() <= atol + rtol * w.abs()).all().item()))
    require(lib_ok, f"library yardstick {name}: computes another function "
                    f"(max abs err {res['library_max_abs_err']:.3e})")
    res["ms"] = cuda_ms(lambda: sp.spmm_coo(pack, x))
    res["plain_ms"] = cuda_ms(lambda: sp.spmm_coo_reference(pack, x))
    res["library_ms"] = cuda_ms(lambda: csr @ x)
    res["bound_ms"], res["bound_by"] = spmm_bound(pack, x.shape[1], x.dtype)
    print("spmm_coo", json.dumps(res))
    return res


def edge_cases(sp):
    """(name, pack, x) at the shapes the CPU tests also cover."""
    cases = []
    for name, seed, (r, c), f in (("empty_row_block", 0, (300, 300), 6),
                                  ("rectangular", 2, (96, 384), 7),
                                  ("f19", 8, (300, 300), 19)):
        rs = np.random.RandomState(seed)
        a = ((rs.rand(r, c) < 0.04) * rs.randn(r, c)).astype(np.float32)
        if name == "empty_row_block":
            a[128:256] = 0.0
        cases.append((name, sp.to_block_coo(a), rs.randn(c, f)))
    return cases


def phase_kernels(sp, stacked, dev):
    """Phase 3; returns the JSON entry of spmm_coo (launches filled later)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for name, pack, x in edge_cases(sp):
            pack = pack.to(dev, dtype)
            check_spmm(sp, name, pack, torch.from_numpy(x).to(dev, dtype),
                       csr=csr_of(pack))
    print(f"slice pack: {int((stacked.pack.data != 0).sum())} nonzeros in "
          f"{stacked.pack.data.shape[0]} stored 128x128 tiles")
    per_forward = {}  # dtype -> summed results over the 48 launches
    for dtype in (torch.float32, torch.bfloat16):
        pack = stacked.pack.to(dev, dtype)
        csr = csr_of(pack)
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "max_abs_err": 0.0}
        for role, f in SLICE_WIDTHS.items():
            x = torch.randn((pack.col_dim_orig, f), generator=gen, device=dev,
                            dtype=torch.float32).to(dtype)
            res = check_spmm(sp, f"slice_{role}", pack, x, csr=csr)
            # 12 launches of each width per forward: 6 steps x 2 levels.
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                tot[k] += 12 * res[k]
            tot["max_abs_err"] = max(tot["max_abs_err"], res["max_abs_err"])
            tot["bound_by"] = res["bound_by"]
        per_forward[dtype] = tot
        print(f"spmm_coo per 64-window forward ({str(dtype)[6:]}, 48 "
              f"launches): " + json.dumps(tot))
        del csr
    f32 = per_forward[torch.float32]
    return {"name": "spmm_coo", "route": "cuda",
            "source": "megacrn_tpu_torch/kernels/csrc/spmm_coo.cu",
            "replaces": "megacrn_tpu/kernels/spmm_coo.py:180",
            "launches": None, "max_abs_err": f32["max_abs_err"],
            "ms": f32["ms"], "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"]}


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


def phase_slice(sp, stacked, cfg):
    """Phase 4 and 5; returns the kernel launches of the main path."""
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

    sp.spmm_coo.launches = 0  # --- the main path, counted ---
    outs, per_req = [], []
    for x in reqs:
        before = sp.spmm_coo.launches
        outs.append(pred.predict(x))
        per_req.append(sp.spmm_coo.launches - before)
    launches = sp.spmm_coo.launches  # --- read just after ---

    for x, out, n in zip(reqs, outs, per_req):
        b = x.shape[0]
        chunks = -(-b // 64)
        require(out.shape == (b, cfg.horizon, cfg.num_nodes, 1),
                f"request of {b}: output shape {out.shape}")
        require(np.isfinite(out).all(), f"request of {b}: non-finite")
        require(n == 48 * chunks, f"request of {b}: {n} spmm_coo launches, "
                                  f"expected 48 x {chunks} chunks")
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
    profile_chunk(pred, reqs[1], ms)

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


def profile_chunk(pred, x, chunk_ms):
    """Where one 64-window chunk's device time goes: kernel time by name
    from torch.profiler, and the device's idle share, both of the profiled
    call's wall time (which the profiler's own overhead inflates) and of
    ``chunk_ms``, the unprofiled chunk's time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(x)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count += 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    if not count:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile of one chunk: {count} device kernels, busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms profiled wall, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; of the unprofiled {chunk_ms:.3f} ms "
          f"chunk, idle share {1 - busy_ms / chunk_ms:.4f}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {t:9.3f} ms  {100 * t / busy_ms:5.1f}%  {name[:90]}")


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
    from megacrn_tpu_torch.config import model_config_for
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
    from megacrn_tpu_torch.kernels import _build
    from megacrn_tpu_torch.kernels import spmm_coo as sp
    from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

    t0 = time.perf_counter()
    log = _build.build("spmm_coo")
    print(f"build: {time.perf_counter() - t0:.2f} s for spmm_coo"
          f"{'' if log else ' (already built)'}")
    for line in log.splitlines():
        if "ptxas info" in line:
            print(f"  spmm_coo: {line.strip()}")

    # The EXPY-TKY preset over the synthetic stand-in of its road graph, as
    # the JAX CLI builds it for --dataset SYNTH --road_impl pallas.
    cfg = model_config_for("EXPYTKY", graph_backend="road_sparse")
    stacked = sp.build_stacked_road_pack(list(dual_random_walk_supports(
        synthetic_road_adjacency(cfg.num_nodes, avg_degree=8, seed=0))))
    print(f"slice pack: {stacked.pack.data.shape[0]} tiles over "
          f"{stacked.pack.n // 128} row blocks, n_pad {stacked.n_pad}")

    entry = phase_kernels(sp, stacked, dev)
    entry["launches"] = phase_slice(sp, stacked, cfg)
    require(entry["launches"] > 0, "the main path launched no spmm_coo")
    phase_small_vs_cpu(dev)

    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
