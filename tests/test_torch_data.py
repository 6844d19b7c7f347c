"""The port's data pipeline (megacrn_tpu_torch.data) held against the JAX
package's on the same seeded numpy inputs. Every array must be EQUAL, not
close: the pipeline is numpy on both sides, and the port derives the
calendar features from datetime64 arithmetic where the JAX package asks
pandas."""
import gzip
import os
import pickle

import numpy as np
import pytest

from megacrn_tpu.data import datasets as jdatasets
from megacrn_tpu.data import expytky as jexpytky
from megacrn_tpu.data import loader as jloader
from megacrn_tpu.data import native as jnative
from megacrn_tpu.data import scalers as jscalers
from megacrn_tpu.data import synthetic as jsynthetic
from megacrn_tpu.data import windowing as jwindowing
from megacrn_tpu_torch.data import datasets as tdatasets
from megacrn_tpu_torch.data import expytky as texpytky
from megacrn_tpu_torch.data import loader as tloader
from megacrn_tpu_torch.data import scalers as tscalers
from megacrn_tpu_torch.data import synthetic as tsynthetic
from megacrn_tpu_torch.data import windowing as twindowing


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _scaled_equal(got, want):
    """Arrays that went through the channel-0 scaling. The JAX pipeline
    scales with its host library where g++ builds it (as here) and the port
    follows that arithmetic exactly; the library's numpy fallback divides
    instead, within an ulp."""
    if jnative.available():
        _equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)


def _same_batches(tl, jl, epochs=(None,)):
    assert len(tl) == len(jl) and tl.true_size == jl.true_size
    for e in epochs:
        if e is not None:
            tl.set_epoch(e)
            jl.set_epoch(e)
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) > 0
        for (tx, ty), (jx, jy) in zip(tb, jb):
            _scaled_equal(tx, jx)
            _scaled_equal(ty, jy)


@pytest.mark.parametrize("kw", [
    dict(num_steps=300, num_nodes=8, seed=3),
    dict(num_steps=500, num_nodes=12, interval_minutes=10, seed=1,
         missing_rate=0.1, start="2021-10-01", min_speed=20.0),
])
def test_synthetic_speed_series_is_bit_identical(kw):
    tv, ti = tsynthetic.synthetic_speed_series(**kw)
    jv, ji = jsynthetic.synthetic_speed_series(**kw)
    assert tv.dtype == jv.dtype == np.float32
    _equal(tv, jv)
    assert ti.dtype == ji.dtype
    _equal(ti, ji)


def _index(interval):
    """10 days across a month end and a week, from 2021-10-27 17:35."""
    n = 10 * 24 * 60 // interval
    return (np.datetime64("2021-10-27T17:35")
            + np.arange(n) * np.timedelta64(interval, "m"))


@pytest.mark.parametrize("interval", [5, 10])
def test_time_features_equal_pandas_ones(interval):
    index = _index(interval)
    assert index[0].astype("datetime64[M]") != index[-1].astype(
        "datetime64[M]")
    _equal(twindowing.weekday_time_feature(index, 3, interval),
           jwindowing.weekday_time_feature(index, 3, interval))
    _equal(twindowing.time_in_day_feature(index, 3),
           jwindowing.time_in_day_feature(index, 3))
    _equal(twindowing.day_in_week_feature(index, 3),
           jwindowing.day_in_week_feature(index, 3))
    _equal(twindowing.one_hot_time_feature(index),
           jwindowing.one_hot_time_feature(index))

    def holiday(ts):  # a calendar: the first of each month
        return ts.day == 1

    _equal(twindowing.one_hot_time_feature(index, holiday),
           jwindowing.one_hot_time_feature(index, holiday))
    # nanosecond stamps (what pandas hands back) give the same fields
    _equal(twindowing.weekday_time_feature(index.astype("datetime64[ns]"),
                                           2, interval),
           jwindowing.weekday_time_feature(index, 2, interval))


def test_calendar_fields_before_the_epoch():
    index = np.array(["1969-12-28T23:59", "1969-12-31T00:00",
                      "1970-01-01T00:00", "2000-02-29T12:30"],
                     dtype="datetime64[m]")
    weekday, hour, minute = twindowing.calendar_fields(index)
    _equal(weekday, [6, 2, 3, 1])  # Sun, Wed, Thu, Tue (Monday = 0)
    _equal(hour, [23, 0, 0, 12])
    _equal(minute, [59, 0, 0, 30])


@pytest.mark.parametrize("interval", [5, 10])
def test_expytky_weekdaytime_from_strings(interval):
    """The CSV's flat timestamp column (one stamp per link per time) as
    strings, a UTC offset among the formats, with a road subset."""
    index = _index(interval)[:300]
    text = np.datetime_as_string(index, unit="s")
    stamps = np.repeat(np.char.replace(text, "T", " "), 4)
    sub = np.array([3, 0])
    _equal(texpytky.weekdaytime_feature(stamps, 4, sub, interval),
           jexpytky.weekdaytime_feature(stamps, 4, sub, interval))
    offset = np.char.add(stamps, "+09:00")
    _equal(texpytky.weekdaytime_feature(offset, 4, None, interval),
           jexpytky.weekdaytime_feature(offset, 4, None, interval))


def test_seq2seq_windows_and_chronological_split_equal():
    values, index = jsynthetic.synthetic_speed_series(211, 5, seed=2)
    tx, ty = twindowing.generate_seq2seq_dataset(values, index, 6, 4)
    jx, jy = jwindowing.generate_seq2seq_dataset(values, index, 6, 4)
    _equal(tx, jx)
    _equal(ty, jy)
    _equal(twindowing.generate_seq2seq_dataset(
        values, index, 3, 3, add_day_in_week=True)[0],
        jwindowing.generate_seq2seq_dataset(
            values, index, 3, 3, add_day_in_week=True)[0])
    ts, js = (twindowing.chronological_split(tx, ty),
              jwindowing.chronological_split(jx, jy))
    assert list(ts) == list(js) == ["train", "val", "test"]
    for cat in ts:
        for a, b in zip(ts[cat], js[cat]):
            _equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(shuffle=True),
    dict(shuffle=True, reshuffle_each_epoch=True, seed=7),
    dict(shuffle=True, reshuffle_each_epoch=True),
    dict(pad_with_last_sample=False, keep_tail=True),
    dict(pad_with_last_sample=False),
])
def test_batch_loader_batches_equal(kw):
    """Padding, the construction-time permutation from the same rng, the
    (seed, epoch) reshuffle, and keep_tail."""
    rs = np.random.RandomState(0)
    xs = rs.randn(45, 3, 4, 2).astype(np.float32)
    ys = rs.randn(45, 3, 4, 2).astype(np.float32)
    tl = tloader.BatchLoader(xs, ys, 8, rng=np.random.default_rng(5), **kw)
    jl = jloader.BatchLoader(xs, ys, 8, rng=np.random.default_rng(5), **kw)
    _same_batches(tl, jl, epochs=(0, 1, 3) if "seed" in kw else (None,))


def test_prepare_x_y_and_load_pickle(tmp_path):
    rs = np.random.RandomState(1)
    x = rs.randn(2, 3, 4, 2).astype(np.float64)
    y = rs.randn(2, 3, 4, 3).astype(np.float32)
    for a, b in zip(tloader.prepare_x_y(x, y, 1, 1),
                    jloader.prepare_x_y(x, y, 1, 1)):
        assert a.dtype == b.dtype == np.float32 and a.flags.c_contiguous
        _equal(a, b)
    path = tmp_path / "adj.pkl"
    with open(path, "wb") as f:
        pickle.dump({"adj": np.eye(3)}, f)
    _equal(tloader.load_pickle(str(path))["adj"], np.eye(3))


def test_scalers_equal():
    rs = np.random.RandomState(2)
    train = rs.randn(40, 6).astype(np.float32)
    test = rs.randn(10, 6).astype(np.float32)
    train[:, 2] = 3.0  # zero variance -> scale 1
    for fit_on in ("train", "train+test"):
        for a, b in zip(tscalers.fit_columnwise(train, test, fit_on),
                        jscalers.fit_columnwise(train, test, fit_on)):
            _equal(a, b)
    with pytest.raises(ValueError):
        tscalers.fit_columnwise(train, None, "train+test")
    ts, js = (tscalers.StandardScaler.fit(train),
              jscalers.StandardScaler.fit(train))
    assert (ts.mean, ts.std) == (js.mean, js.std)
    _equal(ts.inverse_transform(ts.transform(train)),
           js.inverse_transform(js.transform(train)))
    mean, std = jscalers.fit_columnwise(train)
    _equal(tscalers.ColumnScaler(mean, std).transform(train),
           jscalers.ColumnScaler(mean, std).transform(train))


@pytest.mark.parametrize("reshuffle", [False, True])
def test_build_synthetic_equal(reshuffle):
    kw = dict(num_nodes=8, num_steps=300, seq_len=6, horizon=6,
              batch_size=32, seed=3, reshuffle_each_epoch=reshuffle,
              shuffle_seed=0 if reshuffle else None)
    td = tdatasets.build_synthetic(shuffle_rng=np.random.default_rng(11),
                                   **kw)
    jd = jdatasets.build_synthetic(shuffle_rng=np.random.default_rng(11),
                                   **kw)
    assert (td["scaler_mean"], td["scaler_std"]) == (jd["scaler_mean"],
                                                     jd["scaler_std"])
    for cat in ("train", "val", "test"):
        _scaled_equal(td[f"x_{cat}"], jd[f"x_{cat}"])
        _scaled_equal(td[f"y_{cat}"], jd[f"y_{cat}"])
        _same_batches(td[f"{cat}_loader"], jd[f"{cat}_loader"],
                      epochs=(0, 1) if reshuffle else (None,))


def test_build_expytky_synthetic_equal():
    kw = dict(num_nodes=8, steps_per_month=300, his_len=6, seq_len=6,
              batch_size=32, seed=3, val_ratio=0.25, shuffle_seed=0)
    td = tdatasets.build_expytky_synthetic(**kw)
    jd = jdatasets.build_expytky_synthetic(**kw)
    _equal(td["scaler"].mean, jd["scaler"].mean)
    _equal(td["scaler"].std, jd["scaler"].std)
    assert (td["scaler_mean"], td["scaler_std"]) == (0.0, 1.0)
    _same_batches(td["train_loader"], jd["train_loader"], epochs=(0, 1, 2))
    for cat in ("val", "test"):
        _same_batches(td[f"{cat}_loader"], jd[f"{cat}_loader"])


def _write_month_csv(path, n_time, n_link, rs, integer_speeds=False):
    stamps = (np.datetime64("2021-10-30T22:00")
              + np.arange(n_time) * np.timedelta64(10, "m"))
    speeds = rs.uniform(-20, 260, (n_time, n_link))
    if integer_speeds:
        speeds = np.round(speeds).astype(int)
    with gzip.open(path, "wt", newline="") as f:
        f.write("timestamp,linkid,speed\n")
        for t in range(n_time):
            stamp = str(stamps[t]).replace("T", " ") + ":00"
            for link in range(n_link):
                v = speeds[t, link]
                f.write(f"{stamp},{link},"
                        f"{v if integer_speeds else round(float(v), 2)}\n")


@pytest.mark.parametrize("integer_speeds", [False, True])
def test_load_speed_and_time_csv_equal(tmp_path, integer_speeds):
    path = str(tmp_path / "expy-tky_202110.csv.gz")
    _write_month_csv(path, 30, 5, np.random.RandomState(4), integer_speeds)
    sub = np.array([4, 1, 2])
    for s in (None, sub):
        ts = texpytky.load_speed_csv(path, 5, s)
        js = jexpytky.load_speed_csv(path, 5, s)
        assert ts.dtype == js.dtype and ts.shape == js.shape
        _equal(ts, js)
        _equal(texpytky.load_time_csv(path, 5, s),
               jexpytky.load_time_csv(path, 5, s))


def test_expytky_months_windows_and_adjacency_equal(tmp_path):
    rs = np.random.RandomState(5)
    months = [np.concatenate([rs.uniform(-5, 250, (40, 6, 1)),
                              rs.rand(40, 6, 1)], -1).astype(np.float32)
              for _ in range(3)]
    _equal(texpytky.clamp_speeds(months[0]), jexpytky.clamp_speeds(months[0]))
    for fit_on in ("train", "train+test"):
        got = texpytky.scale_months(months[:2], months[2:], fit_on)
        want = jexpytky.scale_months(months[:2], months[2:], fit_on)
        for a, b in zip(got[0] + got[1], want[0] + want[1]):
            _equal(a, b)
        _equal(got[2].mean, want[2].mean)
    for single in (False, True):
        for a, b in zip(texpytky.window_xy(months, 6, 4, single),
                        jexpytky.window_xy(months, 6, 4, single)):
            _equal(a, b)
    adj = (rs.rand(6, 6) < 0.4).astype(np.float32)
    path = str(tmp_path / "adj01.npy")
    np.save(path, adj)
    sub = np.array([5, 0, 3])
    _equal(texpytky.load_adjacency(path, sub),
           jexpytky.load_adjacency(path, sub))
    assert os.path.exists(path)
