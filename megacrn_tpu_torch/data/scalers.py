"""Normalisation with both reference flavors (counterpart of
``megacrn_tpu/data/scalers.py``; numpy only).

* ``StandardScaler(mean, std)`` — METR-LA path (``model/utils.py:45-54``):
  stats from ``x_train[..., 0]`` only, applied to channel 0 of x and y of all
  splits (``model/traintest_MegaCRN.py:274-277``).
* EXPY-TKY path uses sklearn's StandardScaler fit on the vstacked train+test
  speed matrix (``model_EXPYTKY/traintest_MegaCRN.py:262-274``) — a mild
  test-statistics leak the reference itself flags in a comment. Both
  ``fit_on='train'`` (clean) and ``fit_on='train+test'`` (parity) exist.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StandardScaler:
    """model/utils.py:45-54 parity (population std, ddof=0)."""

    mean: float
    std: float

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean

    @classmethod
    def fit(cls, data: np.ndarray) -> "StandardScaler":
        return cls(mean=float(data.mean()), std=float(data.std()))


def fit_columnwise(train: np.ndarray, test: np.ndarray | None = None,
                   fit_on: str = "train"):
    """EXPY-TKY scaling: sklearn StandardScaler semantics on a (T, N) matrix —
    per-column mean/std with ddof=0 (model_EXPYTKY/traintest_MegaCRN.py:270-274).

    Returns (mean (N,), std (N,)).
    """
    if fit_on == "train+test":
        if test is None:
            raise ValueError("fit_on='train+test' requires the test matrix")
        stacked = np.vstack([train, test])
    elif fit_on == "train":
        stacked = train
    else:
        raise ValueError(f"unknown fit_on={fit_on!r}")
    mean = stacked.mean(axis=0)
    std = stacked.std(axis=0)
    # sklearn maps zero variance to scale 1.0 to avoid div-by-zero.
    std = np.where(std == 0.0, 1.0, std)
    return mean, std


@dataclasses.dataclass
class ColumnScaler:
    """Per-node scaler matching sklearn.StandardScaler.transform on (T, N)."""

    mean: np.ndarray
    std: np.ndarray

    def transform(self, data):
        return (data - self.mean) / self.std

    def inverse_transform(self, data):
        return data * self.std + self.mean
