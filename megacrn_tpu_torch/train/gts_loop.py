"""GTS training harness: the reference ``model/traintest_GTS.py`` protocol
(counterpart of ``megacrn_tpu/train/gts_loop.py``).

Objective: ``masked_mae(inv(pred), inv(true)) + BCE(adj_prob, knn_prior)``
(``traintest_GTS.py:144-164``); Adam(base_lr=0.005, eps=1e-3), grad clip 5
(torch's ``clip_grad_norm_``, with its +1e-6), constant LR (the MultiStepLR
is commented out in the reference, :139), val-loss early stop with a
best-checkpoint reload. The eval-side BCE applies a (redundant) sigmoid on
the probabilities, a reference quirk kept for loss parity (:119-123).

The extractor's BatchNorms run in train mode inside every train step and
update their running stats; the eval step runs them in eval mode. The eval
samples its graph without Gumbel noise (the argmax graph that serving
uses), once per evaluation: it depends on the weights and the training
series, not on the batch. On a mesh (``mesh=``) the train step is
data-parallel (``parallel.api.make_gts_mesh_train_step``); the eval runs
on every rank alike, and only rank 0 writes the run dir.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import GTSConfig, TrainConfig
from megacrn_tpu_torch.interop import flat_from_gts_state_dict, \
    gts_params_from_flat
from megacrn_tpu_torch.models.gts import GTS
from megacrn_tpu_torch.ops import losses
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.train import checkpoint as ckpt
from megacrn_tpu_torch.train.logs import RunDir, echo_hparams, for_rank
from megacrn_tpu_torch.train.loop import _drain, _param_dtype, to_device
from megacrn_tpu_torch.train.optim import clip_gradients
from megacrn_tpu_torch.train.steps import _metric_steps, summarize_eval


def bce(pred_probs: torch.Tensor, targets: torch.Tensor,
        eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.BCELoss on probabilities clipped to [eps, 1 - eps] (mean
    reduction; torch's own clamp of the log terms at -100 never acts on
    clipped inputs)."""
    p = pred_probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p)
             + (1 - targets) * torch.log1p(-p)).mean()


def _prepare(x: np.ndarray, y: np.ndarray, cfg: GTSConfig):
    """traintest_GTS.py:81-103: the full input channel stack enters the
    encoder; targets keep output_dim channels."""
    x0 = np.ascontiguousarray(x[..., :cfg.input_dim], np.float32)
    y0 = np.ascontiguousarray(y[..., :cfg.output_dim], np.float32)
    return x0, y0


def make_gts_loss_fn(model: GTS, scaler_mean, scaler_std,
                     node_feas: torch.Tensor, knn_prior: torch.Tensor,
                     gumbel_noise: bool = True) -> Callable:
    """``(x, y, batches_seen, generator) -> loss``: the training forward
    (BatchNorm batch stats, updated in place; the Gumbel sample and the
    coins drawn from ``generator``) and the objective, ready for
    ``backward()``. ``node_feas`` and ``knn_prior`` on the model's
    device."""
    prior = knn_prior.reshape(-1)

    def loss_fn(x, y, batches_seen, generator):
        out = model(x, node_feas, labels=y, batches_seen=batches_seen,
                    generator=generator, training=True,
                    gumbel_noise=gumbel_noise)
        y = y.to(out.output.dtype)
        pred_loss = losses.masked_mae_loss(
            inverse_transform(out.output, scaler_std, scaler_mean),
            inverse_transform(y, scaler_std, scaler_mean))
        return pred_loss + bce(out.adj_prob.reshape(-1), prior)

    return loss_fn


def make_gts_train_step(model: GTS, train_cfg: TrainConfig,
                        optimizer: torch.optim.Optimizer,
                        generator: torch.Generator, scaler_mean, scaler_std,
                        node_feas: torch.Tensor, knn_prior: torch.Tensor,
                        gumbel_noise: bool = True) -> Callable:
    """``(x, y, batches_seen) -> loss`` (detached, on the device): one
    optimizer step (forward, objective, backward, the clip when the
    protocol clips, Adam)."""
    loss_fn = make_gts_loss_fn(model, scaler_mean, scaler_std, node_feas,
                               knn_prior, gumbel_noise)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(x, y, batches_seen):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(x, y, batches_seen, generator)
        loss.backward()
        clip_gradients(params, train_cfg)
        optimizer.step()
        return loss.detach()

    return step


def make_gts_eval_step(model: GTS, scaler_mean, scaler_std,
                       node_feas: torch.Tensor,
                       knn_prior: torch.Tensor) -> Callable:
    """``(x, y, graph=None) -> metrics dict`` (tensors on the device): the
    eval-mode forward on the argmax graph (``graph``: the (adj, adj_prob)
    pair of ``model.sample_graph``, else sampled here) and the per-batch
    masked metrics at horizon steps 3/6/12."""
    prior = knn_prior.reshape(-1)
    steps = _metric_steps(model.cfg.horizon)

    @torch.no_grad()
    def eval_step(x, y, graph=None):
        out = model(x, node_feas, training=False, gumbel_noise=False,
                    graph=graph)
        y = y.to(out.output.dtype)
        y_pred = inverse_transform(out.output, scaler_std, scaler_mean)
        y_true = inverse_transform(y, scaler_std, scaler_mean)
        pred_loss = losses.masked_mae_loss(y_pred, y_true)
        # The reference's quirk: a sigmoid over the softmax probabilities
        # (traintest_GTS.py:119).
        graph_loss = bce(torch.sigmoid(out.adj_prob.reshape(-1)), prior)
        m = {"loss": pred_loss + graph_loss, "mae": pred_loss,
             "mape": losses.masked_mape_loss(y_pred, y_true),
             "mse": losses.masked_mse_loss(y_pred, y_true)}
        for s in steps:
            sl_pred, sl_true = y_pred[:, s - 1:s], y_true[:, s - 1:s]
            m[f"mae_{s}"] = losses.masked_mae_loss(sl_pred, sl_true)
            m[f"mape_{s}"] = losses.masked_mape_loss(sl_pred, sl_true)
            m[f"mse_{s}"] = losses.masked_mse_loss(sl_pred, sl_true)
        return m

    return eval_step


def fit_gts(cfg: GTSConfig, train_cfg: TrainConfig, data: Dict,
            node_feas: np.ndarray, knn_prior: np.ndarray, run: RunDir,
            max_epochs: Optional[int] = None, initial_state=None,
            gumbel_noise: bool = True, device=None, mesh=None,
            ckpt_backend: str = "npz") -> Dict:
    """Train GTS with the reference protocol.

    ``data``: train/val/test BatchLoaders and scaler_mean/std, as for
    ``train.loop.fit``; ``node_feas`` (T_train, N) the normalised training
    series; ``knn_prior`` (N, N). ``initial_state``: (params, BatchNorm
    state) in the JAX package's flat naming, in place of the seeded init.
    ``device``: the card unless the caller says otherwise. The best
    weights go to ``run.checkpoint_path`` and the BatchNorm state to
    ``run.checkpoint_path + ".bn"``, as the JAX package writes them.
    ``mesh``: a ``parallel.mesh.Mesh`` (data axis); every rank of it calls
    ``fit_gts`` with the same arguments. ``ckpt_backend``: 'npz' or
    'orbax' (two directories, as ``train.loop.fit`` writes one).
    Returns {params, bn_state (flat JAX naming), model, test_metrics,
    best_val}.
    """
    if ckpt_backend not in ckpt.BACKENDS:
        raise ValueError(f"unknown ckpt_backend {ckpt_backend!r}")
    device = resolve_device(device)
    run = for_rank(run, mesh)
    logger = run.get_logger()
    echo_hparams(logger, model=cfg, train=train_cfg)
    seed = train_cfg.seed if train_cfg.seed is not None else int(time.time())
    if mesh is not None:
        from megacrn_tpu_torch.parallel.comm import broadcast_object

        seed = broadcast_object(seed)  # one seed: the same graph samples
    dtype = _param_dtype(cfg)
    model = GTS(cfg, generator=torch.Generator().manual_seed(seed),
                device="cpu", dtype=dtype)
    if initial_state is not None:
        model.load_state_dict(gts_params_from_flat(*initial_state, cfg,
                                                   dtype=dtype))
    model.to(device)
    logger.info("param_count", sum(p.numel() for p in model.parameters()))
    feas = torch.as_tensor(np.asarray(node_feas, np.float32), device=device)
    prior = torch.as_tensor(np.asarray(knn_prior, np.float32), device=device)
    # The Gumbel uniforms and the coins, drawn on the model's device.
    sampling_gen = torch.Generator(device=device).manual_seed(seed + 1)
    optimizer = torch.optim.Adam(model.parameters(), lr=train_cfg.lr,
                                 eps=train_cfg.epsilon)
    mean, std = data.get("scaler_mean", 0.0), data.get("scaler_std", 1.0)
    if mesh is None:
        train_step = make_gts_train_step(model, train_cfg, optimizer,
                                         sampling_gen, mean, std, feas, prior,
                                         gumbel_noise)

        def place(arrays):
            return arrays
    else:
        from megacrn_tpu_torch.parallel.api import make_gts_mesh_train_step
        from megacrn_tpu_torch.parallel.mesh import shard_batch

        train_step = make_gts_mesh_train_step(
            model, train_cfg, optimizer, mesh, sampling_gen, mean, std, feas,
            prior, gumbel_noise)

        def place(arrays):
            return shard_batch(arrays, mesh, nodes=False)
    eval_step = make_gts_eval_step(model, mean, std, feas, prior)

    def evaluate(loader):
        with torch.no_grad():
            graph = model.sample_graph(feas, None, training=False)
        ms = [eval_step(*to_device(_prepare(x, y, cfg), device), graph)
              for x, y in loader]
        return summarize_eval(_drain(ms), cfg.horizon)

    def save_best(epoch):
        params, bn_state = flat_from_gts_state_dict(model.state_dict(), cfg)
        ckpt.write(ckpt_backend, mesh, run.checkpoint_path, params,
                   metadata={"epoch": epoch, "bn_state": None,
                             "scaler_mean": float(mean),
                             "scaler_std": float(std)})
        ckpt.write(ckpt_backend, mesh, run.checkpoint_path + ".bn", bn_state)

    batches_seen, min_val, wait = 0, float("inf"), 0
    epochs = max_epochs if max_epochs is not None else train_cfg.epochs
    for epoch in range(epochs):
        t0 = time.perf_counter()
        tl = []
        for x, y in data["train_loader"]:
            x0, y0 = to_device(place(_prepare(x, y, cfg)), device)
            tl.append(train_step(x0, y0, batches_seen))
            batches_seen += 1
        train_loss = float(np.mean(
            torch.stack(tl).cpu().numpy().astype(np.float64)))
        train_s = time.perf_counter() - t0
        val = evaluate(data["val_loader"])
        dt = time.perf_counter() - t0
        msg = (f"Epoch [{epoch + 1}/{epochs}] ({batches_seen}) "
               f"train_loss: {train_loss:.4f}, val_loss: {val['loss']:.4f}, "
               f"{dt:.1f}s")
        logger.info(msg)
        run.append_epochlog(msg)
        run.log_metrics({"epoch": epoch + 1, "train_loss": train_loss,
                         "val": val, "seconds": dt, "train_seconds": train_s,
                         "steps": len(tl), "sec_per_step": train_s / len(tl)})
        if val["loss"] < min_val:
            wait, min_val = 0, val["loss"]
            save_best(epoch)
        else:
            wait += 1
            if wait == train_cfg.patience:
                logger.info("Early stopping at epoch:", epoch)
                break

    params, _, _ = ckpt.load_checkpoint(run.checkpoint_path)
    bn_state, _, _ = ckpt.load_checkpoint(run.checkpoint_path + ".bn")
    model.load_state_dict(gts_params_from_flat(params, bn_state, cfg,
                                               dtype=dtype))
    test = evaluate(data["test_loader"])
    logger.info("GTS best-model test: mae:", f"{test['mae']:.4f}",
                "rmse:", f"{test['rmse']:.4f}")
    run.log_metrics({"final_test": test, "best_val": min_val})
    return {"params": params, "bn_state": bn_state, "model": model,
            "test_metrics": test, "best_val": min_val}
