"""Alternative evaluation aggregations (counterpart of
``megacrn_tpu/train/eval_modes.py``).

The reference ships two subtly different eval protocols (SURVEY.md 2.3):

* per-batch mean (canonical, reproduces README numbers) — ``train.steps``.
* full-concat (``model/traintestv1_MegaCRN.py:54-92``): concatenate every
  batch's predictions, trim the padding tail back to the true sample count,
  compute each metric once globally. Statistically cleaner; needed for
  apples-to-apples comparison with v1-harness runs.
* EXPY-TKY (``model_EXPYTKY/traintest_MegaCRN.py:123-148``): accumulate all
  predictions, inverse-transform, numpy metrics with <1e-5 zeroing, overall
  and per-step.

``predict_fn(x0, y_cov)`` takes a batch's numpy inputs and returns its
normalised predictions, a tensor (on the card, say) or an array. The
predictions stay where they are until the loader is done and cross to the
host in one copy.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from megacrn_tpu_torch.data.loader import prepare_x_y
from megacrn_tpu_torch.ops import losses, metrics


def _predictions(predict_fn: Callable, loader, input_dim: int,
                 output_dim: int) -> Tuple[np.ndarray, np.ndarray]:
    """(y_pred, y_true) over the loader, trimmed to its true sample count."""
    ys_true, ys_pred = [], []
    for x, y in loader:
        x0, y0, y_cov = prepare_x_y(x, y, input_dim, output_dim)
        ys_pred.append(torch.as_tensor(predict_fn(x0, y_cov)))
        ys_true.append(y0)
    y_pred = torch.cat(ys_pred).cpu().numpy()[: loader.true_size]
    y_true = np.concatenate(ys_true)[: loader.true_size]
    return y_pred, y_true


def eval_concat(predict_fn: Callable, loader, input_dim: int, output_dim: int,
                scaler_mean, scaler_std, horizon_steps=(3, 6, 12)) -> Dict:
    """traintestv1 flavor: global metrics over the concatenated, pad-trimmed
    predictions on the inverse-transformed scale."""
    y_pred, y_true = _predictions(predict_fn, loader, input_dim, output_dim)
    y_pred = torch.from_numpy(y_pred * scaler_std + scaler_mean)
    y_true = torch.from_numpy(y_true * scaler_std + scaler_mean)

    out = {
        "mae": float(losses.masked_mae_loss(y_pred, y_true)),
        "mape": float(losses.masked_mape_loss(y_pred, y_true)),
        "rmse": float(losses.masked_rmse_loss(y_pred, y_true)),
    }
    horizon = y_true.shape[1]
    for s in horizon_steps:
        if s <= horizon:
            sl_p, sl_t = y_pred[:, s - 1:s], y_true[:, s - 1:s]
            out[f"mae_{s}"] = float(losses.masked_mae_loss(sl_p, sl_t))
            out[f"mape_{s}"] = float(losses.masked_mape_loss(sl_p, sl_t))
            out[f"rmse_{s}"] = float(losses.masked_rmse_loss(sl_p, sl_t))
    return out


def eval_expytky(predict_fn: Callable, loader, input_dim: int,
                 output_dim: int, scaler) -> Dict:
    """EXPY-TKY protocol: numpy metrics on inverse-transformed arrays with
    <1e-5 zeroing, overall + per-step 1..horizon
    (model_EXPYTKY/traintest_MegaCRN.py:133-148)."""
    y_pred, y_true = _predictions(predict_fn, loader, input_dim, output_dim)
    # Per-column inverse transform on the 2-D (samples*steps, N) reshape
    # (model_EXPYTKY/traintest_MegaCRN.py:133-136).
    s_, t_, n_, _ = y_pred.shape
    y_pred = scaler.inverse_transform(y_pred.reshape(-1, n_)).reshape(
        s_, t_, n_, 1)
    y_true = scaler.inverse_transform(y_true.reshape(-1, n_)).reshape(
        s_, t_, n_, 1)

    mse_, rmse_, mae_, mape_ = metrics.evaluate_expytky(y_true, y_pred)
    out = {"mse": mse_, "rmse": rmse_, "mae": mae_, "mape": mape_}
    for s in range(1, t_ + 1):
        m = metrics.evaluate_expytky(y_true[:, s - 1], y_pred[:, s - 1])
        out[f"rmse_{s}"], out[f"mae_{s}"], out[f"mape_{s}"] = m[1], m[2], m[3]
    return out
