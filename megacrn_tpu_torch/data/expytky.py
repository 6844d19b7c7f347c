"""EXPY-TKY monthly-CSV pipeline (counterpart of
``megacrn_tpu/data/expytky.py``; numpy and the standard library only).

Reproduces ``model_EXPYTKY/utils.py:53-112`` and the harness data flow
(``model_EXPYTKY/traintest_MegaCRN.py:262-278``): per-month CSV of link
speeds -> (T, N_link, 1) with clamping, sub-road subsetting, normalized
weekday-time covariate, stride-1 windowing, and the month-based train/test
split with sklearn-style per-column scaling.

The CSVs (``.csv`` or ``.csv.gz``) are read with ``csv`` instead of pandas:
a column of integers comes back int64 and any other numeric column float64
(an empty field is NaN), as ``pandas.read_csv`` infers them; timestamps
parse as ``datetime64``, and a UTC offset is dropped, so the calendar
fields are the wall-clock ones pandas gives.
"""
from __future__ import annotations

import csv
import gzip
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from megacrn_tpu_torch.data.scalers import ColumnScaler, fit_columnwise
from megacrn_tpu_torch.data.windowing import weekday_slot

_UTC_OFFSET = re.compile(r"(Z|[+-]\d\d:?\d\d)$")


def read_csv_column(path: str, name: str) -> np.ndarray:
    """One column of a CSV file (gzip-compressed when ``path`` ends in
    .gz), as an array of strings."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        reader = csv.reader(f)
        col = next(reader).index(name)
        return np.array([row[col] for row in reader])


def _numeric(strings: np.ndarray) -> np.ndarray:
    """int64 when every field is an integer, else float64 (empty -> NaN)."""
    try:
        return strings.astype(np.int64)
    except ValueError:
        return np.where(strings == "", "nan", strings).astype(np.float64)


def _datetime64(timestamps) -> np.ndarray:
    """datetime64 stamps from datetime64 values or strings; each distinct
    string is parsed once (a month's CSV repeats each stamp per link)."""
    stamps = np.asarray(timestamps)
    if stamps.dtype.kind == "M":
        return stamps
    uniq, inverse = np.unique(stamps.astype(str), return_inverse=True)
    wall = [_UTC_OFFSET.sub("", s.strip()) for s in uniq]
    return np.array(wall, dtype="datetime64[ns]")[inverse]


def clamp_speeds(data: np.ndarray) -> np.ndarray:
    """model_EXPYTKY/utils.py:56-57: negatives -> 0, >200 -> 100."""
    data = np.array(data, copy=True)
    data[data < 0] = 0
    data[data > 200.0] = 100.0
    return data


def load_speed_csv(path: str, n_link: int, sub_idx: Optional[np.ndarray] = None,
                   feature: str = "speed") -> np.ndarray:
    """model_EXPYTKY/utils.py:53-60: CSV rows are (time x link) flattened;
    reshape to (T, N_link, 1), clamp, subset."""
    values = _numeric(read_csv_column(path, feature))[:, None]
    data = values.reshape(-1, n_link, values.shape[-1])
    data = clamp_speeds(data)
    if sub_idx is not None:
        data = data[:, sub_idx, :]
    return data


def weekdaytime_feature(timestamps, n_link: int,
                        sub_idx: Optional[np.ndarray] = None,
                        interval_minutes: int = 10) -> np.ndarray:
    """model_EXPYTKY/utils.py:62-71: normalized weekday*144 + 10-min slot.

    ``timestamps`` is the flat (time x link) timestamp column (one entry per
    row of the CSV, i.e. repeated per link).
    """
    wdt = weekday_slot(_datetime64(timestamps), interval_minutes)
    wdt = wdt / wdt.max()
    data = wdt.reshape(-1, n_link, 1)
    if sub_idx is not None:
        data = data[:, sub_idx, :]
    return data


def load_time_csv(path: str, n_link: int,
                  sub_idx: Optional[np.ndarray] = None) -> np.ndarray:
    return weekdaytime_feature(read_csv_column(path, "timestamp"), n_link,
                               sub_idx)


def load_adjacency(adj_path: str, sub_idx: Optional[np.ndarray] = None) -> np.ndarray:
    """model_EXPYTKY/utils.py:83-88: 0/1 road adjacency with subsetting.
    (Loaded but unused by the reference model; here it feeds the sparse
    SpMM performance path.)"""
    a = np.load(adj_path)
    if sub_idx is not None:
        a = a[sub_idx, :][:, sub_idx]
    return a


def get_seq_windows(data: np.ndarray, seq_len: int) -> np.ndarray:
    """model_EXPYTKY/utils.py:90-92: stride-1 windows of length seq_len."""
    t = data.shape[0]
    anchors = np.arange(0, t - seq_len + 1)
    return data[anchors[:, None] + np.arange(seq_len)[None, :]]


def window_xy(data_list: Sequence[np.ndarray], his_len: int, seq_len: int,
              single_step: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """model_EXPYTKY/utils.py:94-112: per-month windows vstacked; x = first
    his_len steps, y = last seq_len steps (or just the first of them when
    ``single_step``)."""
    xs, ys = [], []
    for data in data_list:
        w = get_seq_windows(data, his_len + seq_len)
        xs.append(w[:, :his_len])
        if single_step:
            ys.append(w[:, -seq_len:-seq_len + 1])
        else:
            ys.append(w[:, -seq_len:])
    return np.vstack(xs), np.vstack(ys)


def scale_months(
    train_months: List[np.ndarray], test_months: List[np.ndarray],
    fit_on: str = "train+test",
) -> Tuple[List[np.ndarray], List[np.ndarray], ColumnScaler]:
    """Per-column scaling over the concatenated month matrices
    (model_EXPYTKY/traintest_MegaCRN.py:262-274). ``fit_on='train+test'``
    replicates the reference (its own comment flags the leak);
    ``fit_on='train'`` is the clean mode."""
    train_mat = np.vstack([m[..., 0] for m in train_months])
    test_mat = np.vstack([m[..., 0] for m in test_months])
    mean, std = fit_columnwise(train_mat, test_mat, fit_on=fit_on)
    scaler = ColumnScaler(mean, std)

    def apply(months):
        return [np.concatenate(
            [scaler.transform(m[..., 0])[..., None], m[..., 1:]], axis=-1)
            for m in months]

    return apply(train_months), apply(test_months), scaler
