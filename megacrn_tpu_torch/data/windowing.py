"""Offline windowing: the ``generate_training_data.py`` semantics, vectorised
(counterpart of ``megacrn_tpu/data/windowing.py``; numpy only).

The reference builds windows with a Python loop over sample indices
(``generate_training_data.py:46-50``); here the same windows come from a
strided gather. Offsets, channel stack, and chronological 70/10/20 split are
identical so the resulting ``{train,val,test}`` arrays match element-for-
element given the same source series.

The calendar features come from ``datetime64`` arithmetic instead of
pandas' ``.dt`` accessors: 1970-01-01 was a Thursday, so pandas' weekday
(Monday = 0) is ``(days since the epoch + 3) % 7``. The results equal the
JAX package's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def calendar_fields(index) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(weekday, hour, minute) int64 arrays of a datetime64 index, as pandas'
    ``.dt.weekday`` (Monday = 0), ``.dt.hour`` and ``.dt.minute`` give
    them."""
    stamps = np.asarray(index).astype("datetime64[m]")
    days = stamps.astype("datetime64[D]")
    minute_of_day = (stamps - days).astype(np.int64)
    weekday = (days.astype(np.int64) + 3) % 7
    return weekday, minute_of_day // 60, minute_of_day % 60


def weekday_slot(index, interval_minutes: int) -> np.ndarray:
    """``weekday * slots_per_day + slot of the day``, int64 (the reference's
    getDayTimestamp before normalisation)."""
    weekday, hour, minute = calendar_fields(index)
    slots = 24 * 60 // interval_minutes
    return weekday * slots + (hour * 60 + minute) // interval_minutes


def time_in_day_feature(index: "np.ndarray", num_nodes: int) -> np.ndarray:
    """Fraction-of-day channel from a datetime64 index
    (generate_training_data.py:32-33)."""
    time_ind = (index - index.astype("datetime64[D]")) / np.timedelta64(1, "D")
    return np.tile(time_ind.astype(np.float32),
                   [1, num_nodes, 1]).transpose((2, 1, 0))


def weekday_time_feature(index, num_nodes: int,
                         interval_minutes: int = 5) -> np.ndarray:
    """getDayTimestamp parity (model/utils.py:62-70): normalized
    ``weekday * slots_per_day + slot`` channel (288 slots at 5-min data).
    Returns (T, N, 1)."""
    wdt = weekday_slot(index, interval_minutes)
    wdt = (wdt / wdt.max()).astype(np.float32)
    return np.tile(wdt[:, None, None], (1, num_nodes, 1))


def one_hot_time_feature(index, holiday_fn=None) -> np.ndarray:
    """get_onehottime parity (model_EXPYTKY/utils.py:114-127): one-hot
    weekday (7) + hour (24) + 10-min interval (6) + is-holiday flag.

    ``holiday_fn(timestamp) -> bool`` plugs in a calendar (the reference uses
    jpholiday, absent here); it receives each timestamp as a
    ``datetime.datetime``. The default counts only weekends as holidays.
    Returns (T, 38) float32.
    """
    weekday, hour, minute = calendar_fields(index)
    t = len(weekday)
    out = np.zeros((t, 7 + 24 + 6 + 1), np.float32)
    out[np.arange(t), weekday] = 1
    out[np.arange(t), 7 + hour] = 1
    out[np.arange(t), 31 + minute // 10] = 1
    weekend = weekday >= 5
    if holiday_fn is not None:
        stamps = np.asarray(index).astype("datetime64[us]").astype(object)
        hol = np.array([bool(holiday_fn(x)) for x in stamps]) | weekend
    else:
        hol = weekend
    out[:, -1] = hol.astype(np.float32)
    return out


def day_in_week_feature(index, num_nodes: int) -> np.ndarray:
    """One-hot weekday channels (generate_training_data.py:35-38; off by
    default in the reference)."""
    num_samples = len(index)
    dow = ((index.astype("datetime64[D]").view("int64") + 4) % 7)  # 1970-01-01 was Thursday
    out = np.zeros((num_samples, num_nodes, 7))
    out[np.arange(num_samples), :, dow] = 1
    return out


def window_series(
    data: np.ndarray, x_offsets: np.ndarray, y_offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows over the leading time axis.

    data: (T, N, C). Returns x (S, len(x_offsets), N, C), y likewise, where t
    ranges over [|min(x_offsets)|, T - |max(y_offsets)|) exactly as
    generate_training_data.py:44-50.
    """
    num_samples = data.shape[0]
    min_t = abs(int(min(x_offsets)))
    max_t = abs(num_samples - abs(int(max(y_offsets))))
    anchors = np.arange(min_t, max_t)
    if data.ndim == 3 and data.dtype == np.float32:
        # The host library's gather (data.native; numpy without it).
        from megacrn_tpu_torch.data import native

        x = native.window_gather(data, anchors, np.asarray(x_offsets))
        y = native.window_gather(data, anchors, np.asarray(y_offsets))
    else:
        x = data[anchors[:, None] + np.asarray(x_offsets)[None, :]]
        y = data[anchors[:, None] + np.asarray(y_offsets)[None, :]]
    return x, y


def generate_seq2seq_dataset(
    values: np.ndarray,
    index: Optional[np.ndarray] = None,
    seq_len: int = 12,
    horizon: int = 12,
    add_time_in_day: bool = True,
    add_day_in_week: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(T, N) series -> windowed (x, y) with the reference channel stack."""
    num_nodes = values.shape[1]
    channels = [np.expand_dims(values, -1)]
    if add_time_in_day:
        if index is None:
            raise ValueError("time_in_day channel requires a datetime index")
        channels.append(time_in_day_feature(index, num_nodes))
    if add_day_in_week:
        channels.append(day_in_week_feature(index, num_nodes))
    data = np.concatenate(channels, axis=-1).astype(np.float32)
    x_offsets = np.arange(-(seq_len - 1), 1)
    y_offsets = np.arange(1, horizon + 1)
    return window_series(data, x_offsets, y_offsets)


def ratio_windows(
    values: np.ndarray,
    values_time: Optional[np.ndarray],
    his_len: int,
    seq_len: int,
    trainval_ratio: float,
    mode: str,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """MegaCRNx ratio-based windowing, getXSYS/getXSYSTIME parity
    (model_futurework/traintest_MegaCRNx.py:21-55).

    ``values``/``values_time``: (T, N). Train windows anchor at
    ``i in [0, train_num - seq_len - his_len + 1)``; test windows at
    ``i in [train_num - his_len, T - seq_len - his_len + 1)`` where
    ``train_num = int(T * trainval_ratio)``. x = values[i : i+his_len],
    y = values[i+his_len : i+his_len+seq_len], and the covariate is the
    TIME channel of the target window. Returns (XS, YS, YCOV) each
    (S, L, N, 1) float32; YCOV is None when ``values_time`` is None.
    """
    t_total = values.shape[0]
    train_num = int(t_total * trainval_ratio)
    if mode == "train":
        anchors = np.arange(0, train_num - seq_len - his_len + 1)
    elif mode == "test":
        anchors = np.arange(train_num - his_len,
                            t_total - seq_len - his_len + 1)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x_offsets = np.arange(0, his_len)
    y_offsets = np.arange(his_len, his_len + seq_len)
    xs = values[anchors[:, None] + x_offsets[None, :]][..., None]
    ys = values[anchors[:, None] + y_offsets[None, :]][..., None]
    ycov = None
    if values_time is not None:
        ycov = values_time[anchors[:, None] + y_offsets[None, :]][..., None]
    return (xs.astype(np.float32), ys.astype(np.float32),
            None if ycov is None else ycov.astype(np.float32))


def chronological_split(
    x: np.ndarray, y: np.ndarray, train_frac: float = 0.7, test_frac: float = 0.2
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """70/10/20 split with the reference's rounding
    (generate_training_data.py:79-92: test = round(S*0.2) LAST samples,
    train = round(S*0.7) first, val = remainder)."""
    num_samples = x.shape[0]
    num_test = round(num_samples * test_frac)
    num_train = round(num_samples * train_frac)
    num_val = num_samples - num_test - num_train
    return {
        "train": (x[:num_train], y[:num_train]),
        "val": (x[num_train:num_train + num_val], y[num_train:num_train + num_val]),
        "test": (x[-num_test:], y[-num_test:]),
    }


def save_npz_splits(splits, output_dir: str, seq_len: int = 12,
                    horizon: int = 12):
    """Write {train,val,test}.npz with the reference key layout
    (generate_training_data.py:94-103)."""
    import os

    x_offsets = np.arange(-(seq_len - 1), 1).reshape(-1, 1)
    y_offsets = np.arange(1, horizon + 1).reshape(-1, 1)
    for cat, (x, y) in splits.items():
        np.savez_compressed(
            os.path.join(output_dir, f"{cat}.npz"),
            x=x, y=y, x_offsets=x_offsets, y_offsets=y_offsets)
