"""Dataset assembly: raw source -> loaders + scaler, per reference protocol
(counterpart of ``megacrn_tpu/data/datasets.py``; numpy only).

Sources:
* ``load_npz_splits`` — pre-windowed {train,val,test}.npz dirs in the
  reference layout (``model/traintest_MegaCRN.py:269-280``).
* ``build_from_series`` — a raw (T, N) series + datetime index, windowed and
  split in-process (what ``generate_training_data.py`` + npz loading do in
  two stages).
* ``build_synthetic`` — generated series (tests / benches / demos; the raw
  benchmark blobs are absent from the reference mirror).
* ``build_expytky`` / ``build_expytky_synthetic`` — the EXPY-TKY monthly
  protocol, from CSV months or from generated ones.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from megacrn_tpu_torch.data import native
from megacrn_tpu_torch.data.loader import BatchLoader
from megacrn_tpu_torch.data.scalers import StandardScaler
from megacrn_tpu_torch.data.synthetic import synthetic_speed_series
from megacrn_tpu_torch.data.windowing import (chronological_split,
                                              generate_seq2seq_dataset,
                                              weekday_slot)


def _finalize(splits: Dict, batch_size: int, shuffle_rng=None,
              reshuffle_each_epoch: bool = False,
              shuffle_seed=None) -> Dict:
    """Scale channel 0 by train-x stats, build loaders
    (model/traintest_MegaCRN.py:274-280). ``shuffle_seed`` makes the
    per-epoch reshuffle a pure function of (seed, epoch) via
    ``BatchLoader.set_epoch`` — required for checkpoint-exact resume."""
    x_train, _ = splits["train"]
    scaler = StandardScaler.fit(x_train[..., 0])
    data: Dict = {"scaler": scaler, "scaler_mean": scaler.mean,
                  "scaler_std": scaler.std}
    rng = shuffle_rng or np.random.default_rng()
    for cat in ["train", "val", "test"]:
        x, y = splits[cat]
        x = np.array(x, np.float32, order="C")
        y = np.array(y, np.float32, order="C")
        # The host library's in-place scaling (data.native), as the JAX
        # package's pipeline runs it.
        native.scale_channel_inplace(x, 0, scaler.mean, scaler.std)
        native.scale_channel_inplace(y, 0, scaler.mean, scaler.std)
        data[f"x_{cat}"], data[f"y_{cat}"] = x, y
        data[f"{cat}_loader"] = BatchLoader(
            x, y, batch_size, shuffle=(cat == "train"), rng=rng,
            reshuffle_each_epoch=reshuffle_each_epoch, seed=shuffle_seed)
    return data


def load_npz_splits(data_dir: str, batch_size: int, **kw) -> Dict:
    splits = {}
    for cat in ["train", "val", "test"]:
        with np.load(os.path.join(data_dir, f"{cat}.npz")) as z:
            splits[cat] = (z["x"], z["y"])
    return _finalize(splits, batch_size, **kw)


def build_from_series(values: np.ndarray, index, seq_len: int, horizon: int,
                      batch_size: int, **kw) -> Dict:
    x, y = generate_seq2seq_dataset(values, index, seq_len, horizon)
    return _finalize(chronological_split(x, y), batch_size, **kw)


def build_synthetic(num_nodes: int = 32, num_steps: int = 2000,
                    seq_len: int = 12, horizon: int = 12,
                    batch_size: int = 64, interval_minutes: int = 5,
                    seed: int = 0, min_speed: float = 0.0,
                    missing_rate: float = 0.02, **kw) -> Dict:
    values, index = synthetic_speed_series(
        num_steps, num_nodes, interval_minutes, seed, min_speed=min_speed,
        missing_rate=missing_rate)
    return build_from_series(values, index, seq_len, horizon, batch_size, **kw)


def build_expytky(train_months, test_months, his_len: int, seq_len: int,
                  batch_size: int, val_ratio: float = 0.25,
                  fit_on: str = "train+test", shuffle_rng=None,
                  shuffle_seed=None) -> Dict:
    """EXPY-TKY assembly (model_EXPYTKY/traintest_MegaCRN.py:262-290).

    ``{train,test}_months``: lists of (T, N, 2) arrays with channels
    [speed, weekdaytime] (from ``expytky.load_speed_csv``/``load_time_csv``
    or synthetic). Per-column scaling over the vstacked speed matrices
    (``fit_on='train+test'`` replicates the reference's flagged leak), windows
    per month then vstack, chronological (1-val_ratio)/val_ratio train/val
    split of the trainval windows, per-epoch-reshuffled train loader (torch
    DataLoader(shuffle=True) parity, :71).
    """
    from megacrn_tpu_torch.data.expytky import scale_months, window_xy

    train_scaled, test_scaled, scaler = scale_months(
        list(train_months), list(test_months), fit_on=fit_on)
    x_tv, y_tv = window_xy(train_scaled, his_len, seq_len)
    x_te, y_te = window_xy(test_scaled, his_len, seq_len)
    train_size = int(len(x_tv) * (1 - val_ratio))
    rng = shuffle_rng or np.random.default_rng()
    data = {
        "scaler": scaler, "scaler_mean": 0.0, "scaler_std": 1.0,
        # loss/val run on the normalized scale (nn.L1Loss parity); the
        # column scaler is only applied in the final numpy eval.
        "train_loader": BatchLoader(x_tv[:train_size], y_tv[:train_size],
                                    batch_size, shuffle=True,
                                    reshuffle_each_epoch=True, rng=rng,
                                    seed=shuffle_seed),
        "val_loader": BatchLoader(x_tv[train_size:], y_tv[train_size:],
                                  batch_size),
        "test_loader": BatchLoader(x_te, y_te, batch_size),
    }
    return data


def build_expytky_synthetic(num_nodes: int = 64, steps_per_month: int = 600,
                            his_len: int = 6, seq_len: int = 6,
                            batch_size: int = 64, seed: int = 0,
                            **kw) -> Dict:
    """Synthetic stand-in for the absent EXPY-TKY CSVs: 2 train months +
    1 test month of 10-min data with the weekdaytime covariate."""
    months = []
    for i in range(3):
        values, index = synthetic_speed_series(
            steps_per_month, num_nodes, interval_minutes=10, seed=seed + i,
            start=f"2021-{10 + i:02d}-01")
        wdt = weekday_slot(index, 10)
        wdt = wdt / wdt.max()
        time_feat = np.tile(wdt[:, None], (1, num_nodes))
        months.append(np.stack([values, time_feat], axis=-1).astype(np.float32))
    return build_expytky(months[:2], months[2:], his_len, seq_len,
                         batch_size, **kw)
