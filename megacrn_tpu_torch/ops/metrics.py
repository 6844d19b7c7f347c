"""Numpy evaluation metrics, reproducing both reference flavors
(counterpart of ``megacrn_tpu/ops/metrics.py``).

* Standard flavor (``model/metrics.py:3-46``): zero-masked MSE/RMSE/MAE and
  MAPE (x100), with ``mask /= mean(mask)`` rescaling and ``nan_to_num``.
* EXPY-TKY flavor (``model_EXPYTKY/metrics.py:6-54``): identical except every
  value ``< 1e-5`` in **both** truth and prediction is zeroed first (the
  reference mutates its inputs in place; we operate on copies).

These run on host numpy — they are the offline acceptance metrics, not part of
the training path (the in-loop masked losses live in
``megacrn_tpu_torch.ops.losses``).
"""
from __future__ import annotations

import numpy as np


def _mask(y_true: np.ndarray) -> np.ndarray:
    mask = np.not_equal(y_true, 0).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        mask = mask / np.mean(mask)
    return mask


def mse(y_true, y_pred):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.mean(np.nan_to_num(np.square(y_pred - y_true) * _mask(y_true))))


def rmse(y_true, y_pred):
    return float(np.sqrt(mse(y_true, y_pred)))


def mae(y_true, y_pred):
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.mean(np.nan_to_num(np.abs(y_pred - y_true) * _mask(y_true))))


def mape(y_true, y_pred, null_val: float = 0):
    with np.errstate(divide="ignore", invalid="ignore"):
        if np.isnan(null_val):
            m = ~np.isnan(y_true)
        else:
            m = np.not_equal(y_true, null_val)
        m = m.astype("float32")
        m = m / np.mean(m)
        val = np.abs(np.divide((y_pred - y_true).astype("float32"), y_true))
        return float(np.mean(np.nan_to_num(m * val)) * 100)


def evaluate(y_true, y_pred):
    """model/metrics.py:3-4 — returns (MSE, RMSE, MAE, MAPE[%])."""
    return (
        mse(y_true, y_pred),
        rmse(y_true, y_pred),
        mae(y_true, y_pred),
        mape(y_true, y_pred),
    )


def _zero_small(a: np.ndarray) -> np.ndarray:
    a = np.array(a, copy=True)
    a[a < 1e-5] = 0
    return a


def evaluate_expytky(y_true, y_pred):
    """model_EXPYTKY/metrics.py:3-54 — same metrics after <1e-5 zeroing of
    both arrays (on copies; the reference mutates in place)."""
    y_true = _zero_small(y_true)
    y_pred = _zero_small(y_pred)
    return (
        mse(y_true, y_pred),
        rmse(y_true, y_pred),
        mae(y_true, y_pred),
        mape(y_true, y_pred),
    )
