"""Train and eval steps of the MegaCRN training protocol (counterpart of
``megacrn_tpu/train/steps.py``).

The composite objective is ``L = L_pred + lamb * L_separate + lamb1 *
L_compact`` (``model/traintest_MegaCRN.py:118-125``) with ``L_pred`` either
the masked MAE on the inverse-transformed scale (METR-LA/PEMS-BAY) or plain
L1 on the normalized scale (EXPY-TKY,
``model_EXPYTKY/traintest_MegaCRN.py:76-94``).

A train step is the forward with scheduled sampling, the composite loss,
the backward (through the SpMM kernels' ``autograd.Function``s on the
``road_sparse`` backend), the clip when the protocol clips, and Adam. The
eval step computes the per-batch masked metrics at the 1-based horizon
steps 3/6/12 (``model/traintest_MegaCRN.py:72-86``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from megacrn_tpu_torch.config import TrainConfig
from megacrn_tpu_torch.models.megacrn import DTYPES, MegaCRN, MegaCRNOutput
from megacrn_tpu_torch.ops import losses
from megacrn_tpu_torch.ops.graph import road_supports_to
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.train.optim import clip_gradients
from megacrn_tpu_torch.train.telemetry import span


def composite_loss(out: MegaCRNOutput, y: torch.Tensor,
                   train_cfg: TrainConfig, scaler_mean,
                   scaler_std) -> torch.Tensor:
    # Targets arrive as f32; align them with the output dtype so the f64
    # mode computes its losses fully in double.
    y = y.to(out.output.dtype)
    if train_cfg.pred_loss == "masked_mae_inv":
        y_pred = inverse_transform(out.output, scaler_std, scaler_mean)
        y_true = inverse_transform(y, scaler_std, scaler_mean)
        pred_loss = losses.masked_mae_loss(y_pred, y_true)
    elif train_cfg.pred_loss == "l1_normalized":
        pred_loss = (out.output - y).abs().mean()  # nn.L1Loss
    else:
        raise ValueError(f"unknown pred_loss {train_cfg.pred_loss!r}")
    aux = losses.megacrn_aux_losses(out.query, out.pos, out.neg,
                                    train_cfg.lamb, train_cfg.lamb1)
    return pred_loss + aux


def _model_supports(model: MegaCRN, road_supports, transpose: bool):
    """The graph constant on the model's device in its compute dtype; the
    transposed packs too when ``transpose`` (a backward reads them)."""
    return road_supports_to(road_supports, next(model.parameters()).device,
                            DTYPES[model.cfg.compute_dtype], transpose)


def make_loss_fn(model: MegaCRN, train_cfg: TrainConfig,
                 scaler_mean: float = 0.0, scaler_std: float = 1.0,
                 road_supports=None) -> Callable:
    """``(x, y, y_cov, batches_seen, generator) -> loss``: the training
    forward with scheduled sampling and the composite loss, ready for
    ``backward()``. ``road_supports`` is moved to the model's device once,
    here."""
    supports = _model_supports(model, road_supports, transpose=True)

    def loss_fn(x, y, y_cov, batches_seen, generator):
        out = model(x, y_cov, road_supports=supports, labels=y,
                    batches_seen=batches_seen, generator=generator,
                    training=True)
        return composite_loss(out, y, train_cfg, scaler_mean, scaler_std)

    return loss_fn


def make_train_step(model: MegaCRN, train_cfg: TrainConfig,
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator, scaler_mean: float = 0.0,
                    scaler_std: float = 1.0, road_supports=None) -> Callable:
    """Returns ``(x, y, y_cov, batches_seen) -> loss``: one optimizer step
    over ``model`` (forward with scheduled sampling drawn from
    ``generator``, composite loss, backward, clip, Adam). The returned loss
    is detached and stays on the device. Each call records a ``train.step``
    span with ``train.forward``, ``train.backward`` and ``train.optimizer``
    (the clip and Adam) inside."""
    loss_fn = make_loss_fn(model, train_cfg, scaler_mean, scaler_std,
                           road_supports)
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(x, y, y_cov, batches_seen):
        with span("train.step"):
            optimizer.zero_grad(set_to_none=True)
            with span("train.forward"):
                loss = loss_fn(x, y, y_cov, batches_seen, generator)
            with span("train.backward"):
                loss.backward()
            with span("train.optimizer"):
                clip_gradients(params, train_cfg)
                optimizer.step()
            return loss.detach()

    return train_step


# Horizon metric slices: 1-based steps (3, 6, 12) for 12-step datasets;
# truncated for shorter horizons.
def _metric_steps(horizon: int) -> Tuple[int, ...]:
    return tuple(s for s in (3, 6, 12) if s <= horizon)


def eval_metrics(out: MegaCRNOutput, y: torch.Tensor, train_cfg: TrainConfig,
                 scaler_mean, scaler_std, steps: Tuple[int, ...]) -> dict:
    """The per-batch masked metrics of the reference eval loop
    (model/traintest_MegaCRN.py:60-86), as a function of the forward
    output."""
    y = y.to(out.output.dtype)  # see composite_loss
    y_pred = inverse_transform(out.output, scaler_std, scaler_mean)
    y_true = inverse_transform(y, scaler_std, scaler_mean)
    m = {
        "loss": composite_loss(out, y, train_cfg, scaler_mean, scaler_std),
        "mae": losses.masked_mae_loss(y_pred, y_true),
        "mape": losses.masked_mape_loss(y_pred, y_true),
        "mse": losses.masked_mse_loss(y_pred, y_true),
    }
    for s in steps:
        sl_pred, sl_true = y_pred[:, s - 1:s], y_true[:, s - 1:s]
        m[f"mae_{s}"] = losses.masked_mae_loss(sl_pred, sl_true)
        m[f"mape_{s}"] = losses.masked_mape_loss(sl_pred, sl_true)
        m[f"mse_{s}"] = losses.masked_mse_loss(sl_pred, sl_true)
    return m


def make_eval_step(model: MegaCRN, train_cfg: TrainConfig,
                   scaler_mean: float = 0.0, scaler_std: float = 1.0,
                   return_predictions: bool = False,
                   road_supports=None) -> Callable:
    """Returns ``(x, y, y_cov) -> metrics dict`` (and the inverse-scaled
    predictions with ``return_predictions``): the deterministic forward,
    no autograd."""
    steps = _metric_steps(model.cfg.horizon)
    supports = _model_supports(model, road_supports, transpose=False)

    @torch.no_grad()
    def eval_step(x, y, y_cov):
        out = model(x, y_cov, road_supports=supports)
        m = eval_metrics(out, y, train_cfg, scaler_mean, scaler_std, steps)
        if return_predictions:
            return m, inverse_transform(out.output, scaler_std, scaler_mean)
        return m

    return eval_step


def summarize_eval(batch_metrics: list, horizon: int) -> dict:
    """Host-side aggregation: mean over batches; RMSE = sqrt(mean of MSEs)
    (model/traintest_MegaCRN.py:89-93)."""
    keys = batch_metrics[0].keys()
    acc = {k: float(np.mean([float(b[k]) for b in batch_metrics]))
           for k in keys}
    out = {"loss": acc["loss"], "mae": acc["mae"], "mape": acc["mape"],
           "rmse": float(np.sqrt(acc["mse"]))}
    for s in _metric_steps(horizon):
        out[f"mae_{s}"] = acc[f"mae_{s}"]
        out[f"mape_{s}"] = acc[f"mape_{s}"]
        out[f"rmse_{s}"] = float(np.sqrt(acc[f"mse_{s}"]))
    return out
