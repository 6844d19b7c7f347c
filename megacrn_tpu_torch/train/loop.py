"""Training harness: the full reference protocol as a library function
(counterpart of ``megacrn_tpu/train/loop.py``).

Implements the canonical train->early-stop->reload-best->test program
(``model/traintest_MegaCRN.py:101-155``): epoch loop with a global
``batches_seen`` counter driving curriculum decay, per-epoch val (and test)
evaluation, best-val checkpointing, patience-based early stop, and final
best-checkpoint test. Differences from the reference are capability adds:
full restartable checkpoints (optimizer, LR schedule, counters, the
scheduled-sampling generator) and optional per-epoch reshuffling.

The loop keeps the card fed: a batch goes up from pinned host memory
without waiting for the card, the train losses stay on the card until the
epoch ends, and eval metrics come back in blocks of 10 batches. The first
step of the run is left out of the throughput: it carries the kernels'
build at first use.

On a mesh (``mesh=``, ``parallel.mesh.Mesh``) every rank runs ``fit``: the
step follows the backend (``_mesh_steps``), each rank feeds its block of
the seeded loader's batch, the eval gathers the forward outputs and runs
the metrics unchanged, and only rank 0 writes the run dir (the others
read its checkpoint after a barrier).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig
from megacrn_tpu_torch.data.loader import BatchLoader, prepare_x_y
from megacrn_tpu_torch.interop import flat_from_state_dict, params_from_flat
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.nn.init import xavier_uniform
from megacrn_tpu_torch.train import checkpoint as ckpt
from megacrn_tpu_torch.train import telemetry as tele
from megacrn_tpu_torch.train.logs import RunDir, echo_hparams, for_rank
from megacrn_tpu_torch.train.optim import make_lr_scheduler, make_optimizer
from megacrn_tpu_torch.train.steps import (_metric_steps, eval_metrics,
                                           make_eval_step, make_train_step,
                                           summarize_eval)

# Eval metrics cross to the host once per this many batches.
EVAL_DRAIN_BLOCK = 10


def _reinit_xavier_uniform(model: torch.nn.Module,
                           generator: torch.Generator) -> None:
    """EXPY-TKY harness second init pass
    (model_EXPYTKY/traintest_MegaCRN.py:27-35): xavier_uniform on params with
    dim > 1, U(0,1) on 1-D params, drawn from ``generator`` (CPU) in the
    module's parameter order."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1:
                new = xavier_uniform(tuple(p.shape), generator, p.dtype)
            else:
                new = torch.empty(p.shape, dtype=p.dtype).uniform_(
                    0.0, 1.0, generator=generator)
            p.copy_(new)


def to_device(arrays, device: torch.device) -> List[torch.Tensor]:
    """numpy arrays -> tensors on ``device``. To the card they go through
    pinned host memory without blocking the host: a copy from pageable
    memory would wait for all the work queued before it. Records a
    ``train.upload`` span."""
    with tele.span("train.upload", bytes=sum(a.nbytes for a in arrays)):
        tensors = [torch.from_numpy(a) for a in arrays]
        if device.type != "cuda":
            return [t.to(device) for t in tensors]
        return [t.pin_memory().to(device, non_blocking=True)
                for t in tensors]


def _drain(device_metrics: List[Dict[str, torch.Tensor]]) -> List[Dict]:
    """A block of per-batch metric dicts -> host dicts, in one copy."""
    if not device_metrics:
        return []
    keys = list(device_metrics[0])
    host = torch.stack([torch.stack([m[k] for k in keys])
                        for m in device_metrics]).cpu().numpy()
    return [dict(zip(keys, row)) for row in host]


def evaluate(eval_step, loader: BatchLoader, model_cfg: MegaCRNConfig,
             input_dim: int, output_dim: int,
             device: Optional[torch.device] = None) -> Dict[str, float]:
    """Per-batch metrics over ``loader``, summarised (``summarize_eval``).
    ``device``: where the eval step's model lives (default: the CPU)."""
    device = device or torch.device("cpu")
    device_metrics, batch_metrics = [], []
    for x, y in loader:
        x0, y0, y_cov = to_device(
            prepare_x_y(x, y, input_dim, output_dim), device)
        device_metrics.append(eval_step(x0, y0, y_cov))
        if len(device_metrics) >= EVAL_DRAIN_BLOCK:
            batch_metrics.extend(_drain(device_metrics))
            device_metrics.clear()
    batch_metrics.extend(_drain(device_metrics))
    return summarize_eval(batch_metrics, model_cfg.horizon)


def _scalar_or_array(a):
    a = np.asarray(a)
    return float(a) if a.ndim == 0 else a


def _param_dtype(model_cfg: MegaCRNConfig) -> torch.dtype:
    # bf16 narrows only the matmul inputs; the weights stay f32.
    return (torch.float64 if model_cfg.compute_dtype == "float64"
            else torch.float32)


def _mesh_steps(model, model_cfg, train_cfg, optimizer, generator, mesh,
                mean, std, road_supports):
    """(train_step, eval_step) of a mesh run, the step chosen by the backend
    as the JAX ``fit`` chooses it: ``dense_ring`` the ring step;
    ``road_sparse`` the node-partitioned step on sharded packs
    (``shard_road_packs`` / ``shard_node_ell``), else the data-parallel
    one; ``dense`` and ``sparse_meta`` the GSPMD counterpart. The eval step
    takes the full batch on the device, cuts the rank's block, and runs the
    metrics on the gathered outputs."""
    from megacrn_tpu_torch.ops.graph import node_partitioned
    from megacrn_tpu_torch.parallel import api
    from megacrn_tpu_torch.parallel.mesh import shard_batch

    backend = model_cfg.graph_backend
    args = (model, train_cfg, optimizer, mesh)
    if backend == "dense_ring":
        train_step = api.make_ring_train_step(*args, generator, mean, std)
        # The eval is data-parallel: outside the node partition dense_ring
        # is the dense path (the JAX fit does the same).
        eval_fwd = api.make_shardmap_eval_forward(model, mesh)
    elif backend == "road_sparse" and node_partitioned(road_supports):
        train_step = api.make_road_node_train_step(*args, road_supports,
                                                   generator, mean, std)
        eval_fwd = api.make_road_node_eval_forward(model, mesh,
                                                   road_supports)
    elif backend == "road_sparse":
        train_step = api.make_shardmap_train_step(
            *args, generator, mean, std, road_supports=road_supports)
        eval_fwd = api.make_shardmap_eval_forward(model, mesh, road_supports)
    else:
        train_step = api.make_sharded_train_step(
            *args, generator, mean, std, road_supports=road_supports)
        eval_fwd = api.make_sharded_eval_forward(model, mesh, road_supports)
    steps = _metric_steps(model_cfg.horizon)

    @torch.no_grad()
    def eval_step(x0, y0, y_cov):
        x, yc = shard_batch((x0, y_cov), mesh, nodes=eval_fwd.shard_nodes)
        return eval_metrics(eval_fwd(x, yc), y0, train_cfg, mean, std, steps)

    return train_step, eval_step


def fit(
    model_cfg: MegaCRNConfig,
    train_cfg: TrainConfig,
    data: Dict,
    run: RunDir,
    *,
    test_every_epoch: bool = True,
    resume: bool = False,
    max_epochs: Optional[int] = None,
    final_eval_fn=None,
    ckpt_backend: str = "npz",
    road_supports=None,
    initial_params=None,
    profile_dir: Optional[str] = None,
    profile_steps: int = 10,
    log_compiled_memory: bool = True,
    device=None,
    mesh=None,
) -> Dict:
    """Train MegaCRN with the reference protocol.

    ``data`` keys: train_loader / val_loader / test_loader (BatchLoader),
    scaler_mean, scaler_std (scalars).
    ``ckpt_backend``: 'npz' (single-file atomic) or 'orbax' (a directory,
    which the port writes with ``torch.distributed.checkpoint``:
    ``train.checkpoint.save_checkpoint_dcp``).
    ``road_supports``: the graph constant of a ``road_sparse`` or
    ``sparse_meta`` config (``ops.graph.GRAPH_CONSTANTS`` lists them),
    moved to the device here.
    ``initial_params``: a start point in the JAX package's flat naming
    (numpy arrays), in place of the seeded init (and re-init).
    ``profile_dir``: capture a ``torch.profiler`` trace of
    ``profile_steps`` steps of the first epoch, after the run's first step.
    ``log_compiled_memory``: record the card's peak memory after the first
    step in metrics.jsonl (the counterpart of the JAX package's compiled
    memory statistics).
    ``final_eval_fn(model)``: the final test in place of the per-batch one
    (e.g. the EXPY-TKY numpy metrics).
    ``device``: where to train; the card unless the caller says otherwise
    (``resolve_device``).
    ``mesh``: a ``parallel.mesh.Mesh``; every rank of it calls ``fit``
    with the same arguments (``road_supports``: ``shard_road_packs`` or
    ``shard_node_ell`` output for the node-partitioned road step).
    Returns {params (flat JAX naming, numpy), model, best_val, test_metrics,
    epochs_run}.
    """
    if ckpt_backend not in ckpt.BACKENDS:
        raise ValueError(f"unknown ckpt_backend {ckpt_backend!r}")
    device = resolve_device(device)
    run = for_rank(run, mesh)
    logger = run.get_logger()
    echo_hparams(logger, model=model_cfg, train=train_cfg)

    seed = train_cfg.seed if train_cfg.seed is not None else int(time.time())
    if mesh is not None:
        from megacrn_tpu_torch.parallel import comm

        seed = comm.broadcast_object(seed)  # one seed: replicated coins
    init_gen = torch.Generator().manual_seed(seed)
    dtype = _param_dtype(model_cfg)
    model = MegaCRN(model_cfg, generator=init_gen, device="cpu", dtype=dtype)
    if train_cfg.reinit_xavier_uniform:
        _reinit_xavier_uniform(model, init_gen)
    if initial_params is not None:
        # Injected start point (e.g. a JAX run's weights, for
        # train-to-train parity runs).
        model.load_state_dict(params_from_flat(initial_params, model_cfg,
                                               dtype=dtype))
    model.to(device)
    named = list(model.named_parameters())
    logger.info("param_count", sum(p.numel() for _, p in named))
    # The scheduled-sampling coins, drawn on the model's device.
    sampling_gen = torch.Generator(device=device).manual_seed(seed + 1)

    optimizer = make_optimizer(model.parameters(), train_cfg)
    scheduler = make_lr_scheduler(optimizer, train_cfg)
    mean, std = data.get("scaler_mean", 0.0), data.get("scaler_std", 1.0)

    batches_seen = 0
    start_epoch = 0
    min_val_loss = float("inf")
    wait = 0
    if resume and os.path.exists(run.checkpoint_path):
        flat, opt_state, meta = ckpt.load_checkpoint(run.checkpoint_path)
        model.load_state_dict(params_from_flat(flat, model_cfg, dtype=dtype))
        ckpt.restore_optimizer(optimizer, scheduler, opt_state, named)
        batches_seen = meta.get("batches_seen", 0)
        start_epoch = meta.get("epoch", 0) + 1
        min_val_loss = meta.get("best_val", float("inf"))
        if "sampling_rng_state" in meta:
            sampling_gen.set_state(torch.from_numpy(
                np.asarray(meta["sampling_rng_state"], np.uint8)))
        if "scaler_mean_arr" in meta:
            mean = _scalar_or_array(meta["scaler_mean_arr"])
            std = _scalar_or_array(meta["scaler_std_arr"])
        logger.info("resumed from", run.checkpoint_path, "epoch", start_epoch)

    if mesh is None:
        train_step = make_train_step(model, train_cfg, optimizer,
                                     sampling_gen, mean, std,
                                     road_supports=road_supports)
        eval_step = make_eval_step(model, train_cfg, mean, std,
                                   road_supports=road_supports)

        def place(arrays):
            return arrays
    else:
        from megacrn_tpu_torch.parallel.mesh import shard_batch

        train_step, eval_step = _mesh_steps(
            model, model_cfg, train_cfg, optimizer, sampling_gen, mesh, mean,
            std, road_supports)

        def place(arrays):
            return shard_batch(arrays, mesh, nodes=train_step.shard_nodes)

    def run_eval(loader):
        t = time.perf_counter()
        out = evaluate(eval_step, loader, model_cfg, model_cfg.input_dim,
                       model_cfg.output_dim, device)
        return out, time.perf_counter() - t

    # Per-epoch throughput accounting (edges/s at epoch granularity, so no
    # per-step host sync). The analytic edge count covers the dense
    # backend; sparse backends report steps/s only.
    edges_per_step = None
    if model_cfg.graph_backend == "dense":
        edges_per_step = tele.edge_traversals_per_step(
            model_cfg.num_nodes, model_cfg.cheb_k, model_cfg.seq_len,
            model_cfg.horizon, train_cfg.batch_size, model_cfg.num_supports)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    profile_steps = max(1, profile_steps)  # 0/negative would never stop
    profile_pending = profile_dir is not None
    profiler = contextlib.ExitStack()
    profile_stop = None  # step_in_epoch at which the open trace ends
    first_step_done = False  # the run's first step carries the kernel build

    epochs = max_epochs if max_epochs is not None else train_cfg.epochs
    epochs_run = 0
    for epoch in range(start_epoch, epochs):
        t0 = time.perf_counter()
        epoch_ns = tele.clock_ns()
        t_steady = t0
        steady_offset = 0  # steps excluded from throughput accounting
        step_in_epoch = 0
        train_losses = []
        if hasattr(data["train_loader"], "set_epoch"):
            data["train_loader"].set_epoch(epoch)
        for x, y in data["train_loader"]:
            x0, y0, y_cov = to_device(place(prepare_x_y(
                x, y, model_cfg.input_dim, model_cfg.output_dim)), device)
            train_losses.append(train_step(x0, y0, y_cov, batches_seen))
            batches_seen += 1
            step_in_epoch += 1
            if not first_step_done:
                first_step_done = True
                train_losses[-1].item()  # sync: the build and warm-up end
                mem = tele.peak_device_memory(device)
                if log_compiled_memory and mem is not None:
                    run.log_metrics({"peak_device_memory": mem})
                t_steady = time.perf_counter()
                steady_offset = step_in_epoch
                if profile_pending:
                    profiler.enter_context(tele.profile_trace(profile_dir))
                    profile_pending = False
                    profile_stop = step_in_epoch + profile_steps
            elif step_in_epoch == profile_stop:
                train_losses[-1].item()  # the trace holds the steps' work
                profiler.close()
                profile_stop = None
        # One host sync per epoch: the mean of the losses kept on the card.
        train_loss = float(np.mean(
            torch.stack(train_losses).cpu().numpy().astype(np.float64)))
        train_dt = time.perf_counter() - t_steady
        train_ns = tele.clock_ns()
        # The host's time in the epoch's uploads and in the loader (its
        # reshuffle and batch preparation), from the spans.
        upload_s = tele.total_seconds("train.upload", epoch_ns, train_ns)
        loader_s = tele.total_seconds("data.", epoch_ns, train_ns)
        steady_steps = step_in_epoch - steady_offset
        profiler.close()  # an epoch shorter than the trace window
        profile_stop = None

        val, val_s = run_eval(data["val_loader"])
        dt = time.perf_counter() - t0
        msg = (f"Epoch [{epoch + 1}/{epochs}] ({batches_seen}) "
               f"train_loss: {train_loss:.4f}, val_loss: {val['loss']:.4f}, "
               f"{dt:.1f}s")
        logger.info(msg)
        run.append_epochlog(msg)
        throughput = {}
        if steady_steps > 0:
            sec_per_step = train_dt / steady_steps
            throughput = {"sec_per_step": sec_per_step,
                          "steps_per_sec": 1.0 / sec_per_step}
            if edges_per_step is not None:
                throughput["edges_per_sec"] = edges_per_step / sec_per_step
        run.log_metrics({"epoch": epoch + 1, "train_loss": train_loss,
                         "val": val, "seconds": dt, "train_seconds": train_dt,
                         "steady_steps": steady_steps,
                         "upload_seconds": upload_s,
                         "loader_seconds": loader_s, "val_seconds": val_s,
                         **throughput})

        if test_every_epoch:
            test, test_s = run_eval(data["test_loader"])
            run.log_metrics({"epoch": epoch + 1, "test": test,
                             "test_seconds": test_s})

        epochs_run = epoch + 1
        scheduler.step()  # MultiStepLR counts epochs
        if val["loss"] < min_val_loss:
            wait = 0
            min_val_loss = val["loss"]
            ckpt.write(
                ckpt_backend, mesh, run.checkpoint_path,
                flat_from_state_dict(model.state_dict(), model_cfg.num_layers),
                ckpt.optimizer_state(optimizer, scheduler, named),
                metadata={"epoch": epoch, "batches_seen": batches_seen,
                          "best_val": min_val_loss,
                          "scaler_mean": float(np.mean(mean)),
                          "scaler_std": float(np.mean(std))},
                # Lossless state JSON can't carry: the sampling generator
                # (its state for epoch+1) and the scaler stats as arrays.
                arrays={"sampling_rng_state": sampling_gen.get_state(),
                        "scaler_mean_arr": np.asarray(mean),
                        "scaler_std_arr": np.asarray(std)})
        else:
            wait += 1
            if wait == train_cfg.patience:
                logger.info("Early stopping at epoch:", epoch)
                break

    # Reload best checkpoint, final test (model/traintest_MegaCRN.py:152-155).
    flat, _, _ = ckpt.load_checkpoint(run.checkpoint_path)
    model.load_state_dict(params_from_flat(flat, model_cfg, dtype=dtype))
    t_final = time.perf_counter()
    if final_eval_fn is not None:
        # Dataset-specific protocol (e.g. EXPY-TKY numpy metrics,
        # model_EXPYTKY/traintest_MegaCRN.py:123-148).
        test = final_eval_fn(model)
    else:
        test = evaluate(eval_step, data["test_loader"], model_cfg,
                        model_cfg.input_dim, model_cfg.output_dim, device)
    final_s = time.perf_counter() - t_final
    logger.info("Best model horizon overall: mae:", f"{test['mae']:.4f}",
                "mape:", f"{test['mape']:.4f}", "rmse:", f"{test['rmse']:.4f}")
    # One score line per horizon step present in the metrics: the canonical
    # protocol computes steps 3/6/12 (model/traintest_MegaCRN.py:96-98), the
    # EXPY-TKY per-step eval computes every step 1..horizon and the reference
    # writes each to the scores file (model_EXPYTKY/traintest_MegaCRN.py:146-149).
    for s in sorted({int(k.rsplit("_", 1)[1]) for k in test
                     if k.startswith("mae_")}):
        line = (f"Horizon {s}: mae: {test[f'mae_{s}']:.4f}, "
                f"mape: {test[f'mape_{s}']:.4f}, "
                f"rmse: {test[f'rmse_{s}']:.4f}")
        logger.info(line)
        run.append_scores(line)
    run.log_metrics({"final_test": test, "best_val": min_val_loss,
                     "final_test_seconds": final_s})
    return {"params": flat, "model": model, "best_val": min_val_loss,
            "test_metrics": test, "epochs_run": epochs_run}
