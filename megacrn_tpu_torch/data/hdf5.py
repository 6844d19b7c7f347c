"""The pandas "fixed" HDF5 layout, read without pandas.

``metr-la.h5`` and ``pems-bay.h5`` hold one DataFrame (time x sensor) that
``DataFrame.to_hdf(format="fixed")`` wrote through PyTables; the JAX CLIs
read them with ``pd.read_hdf`` (``cli/traintest_megacrnx.py:70-77``,
``cli/traintest_gts.py:79-83``). The port imports no pandas, so this module
reads the same layout with h5py: a group per frame whose attributes say
``pandas_type = "frame"`` and ``nblocks``; ``axis0`` the column labels,
``axis1`` the index (int64 nanoseconds where its ``kind`` attribute is
``datetime64``), and per block ``block{i}_items`` (its columns) and
``block{i}_values`` (stored time-major, with the attribute ``transposed``).
h5py is imported only when a file is read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _text(v) -> str:
    if isinstance(v, (bytes, np.bytes_)):
        return v.decode()
    return str(v)


def _index(ds) -> np.ndarray:
    data = ds[()]
    if _text(ds.attrs.get("kind", "")) == "datetime64":
        return data.astype("datetime64[ns]")
    return data


def _block(ds) -> np.ndarray:
    """A block's values as (rows, columns)."""
    data = ds[()]
    return data if bool(ds.attrs.get("transposed", False)) else data.T


def read_hdf(path: str, key: Optional[str] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(values (T, N), index (T,), columns (N,)) of the DataFrame that
    ``pd.read_hdf(path, key)`` returns: ``values`` as ``df.values``, the
    index as datetime64[ns] where it is a DatetimeIndex. ``key`` may be
    omitted when the file holds one frame. Exits naming h5py when it is not
    installed."""
    try:
        import h5py
    except ImportError:
        raise SystemExit(
            f"reading {path} needs the h5py package, which is not installed "
            "(the port reads the pandas HDF5 layout with h5py, not pandas)")
    with h5py.File(path, "r") as f:
        if key is None:
            groups = [k for k in f if isinstance(f[k], h5py.Group)]
            if len(groups) != 1:
                raise ValueError(f"{path} holds {len(groups)} groups "
                                 f"{groups}; give the key")
            key = groups[0]
        g = f[key]
        if _text(g.attrs.get("pandas_type", "")) != "frame":
            raise ValueError(
                f"{path}:{key} is not a DataFrame in the pandas fixed format "
                f"(pandas_type {_text(g.attrs.get('pandas_type', ''))!r})")
        columns = _index(g["axis0"])
        index = _index(g["axis1"])
        blocks = [(_index(g[f"block{i}_items"]), _block(g[f"block{i}_values"]))
                  for i in range(int(g.attrs["nblocks"]))]
    if len(blocks) == 1 and np.array_equal(blocks[0][0], columns):
        return blocks[0][1], index, columns
    where = {c: j for j, c in enumerate(columns.tolist())}
    values = np.empty((len(index), len(columns)),
                      np.result_type(*[v for _, v in blocks]))
    for items, vals in blocks:
        values[:, [where[c] for c in items.tolist()]] = vals
    return values, index, columns
