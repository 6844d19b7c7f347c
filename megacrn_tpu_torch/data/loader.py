"""Batch iteration with reference-parity padding and shuffling (counterpart
of ``megacrn_tpu/data/loader.py``; numpy only).

Reference ``DataLoader`` (``model/utils.py:6-43``): pads the tail by repeating
the last sample until divisible by batch_size, shuffles ONCE at construction
(one fixed permutation reused every epoch), yields numpy batches. Both that
parity behavior and a proper per-epoch reshuffle (``reshuffle_each_epoch=True``)
are supported. The gathers are numpy fancy indexing, which gives the same
arrays as the JAX package's g++ host library.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from megacrn_tpu_torch.train.telemetry import span


def load_pickle(pickle_file: str):
    """Reference-parity pickle loader (model/utils.py:162-172): retries with
    latin1 encoding on UnicodeDecodeError — python2-era DCRNN sensor-graph
    pickles (adj_mx.pkl) need it; anything else re-raises. Unpickling runs
    code: load only files you trust."""
    import pickle

    try:
        with open(pickle_file, "rb") as f:
            return pickle.load(f)
    except UnicodeDecodeError:
        with open(pickle_file, "rb") as f:
            return pickle.load(f, encoding="latin1")


class BatchLoader:
    def __init__(
        self,
        xs: np.ndarray,
        ys: np.ndarray,
        batch_size: int,
        pad_with_last_sample: bool = True,
        shuffle: bool = False,
        reshuffle_each_epoch: bool = False,
        rng: Optional[np.random.Generator] = None,
        seed: Optional[int] = None,
        keep_tail: bool = False,
    ):
        """``keep_tail`` (with ``pad_with_last_sample=False``) yields a short
        final batch instead of dropping the remainder — torch
        ``DataLoader(drop_last=False)`` semantics, used by the MegaCRNx
        harness (model_futurework/traintest_MegaCRNx.py:123-125)."""
        self.batch_size = batch_size
        # Seeded mode: with ``seed`` set and ``set_epoch(e)`` called, the
        # epoch-e permutation is a pure function of (seed, e) — a resumed run
        # sees the exact batch order of the uninterrupted one (the stateful
        # ``rng`` alternative advances opaquely and cannot be checkpointed).
        self._seed = seed
        self._epoch: Optional[int] = None
        self.true_size = len(xs)  # before padding (for trim-after-concat eval)
        if pad_with_last_sample and len(xs) % batch_size != 0:
            num_padding = (batch_size - (len(xs) % batch_size)) % batch_size
            xs = np.concatenate([xs, np.repeat(xs[-1:], num_padding, axis=0)], axis=0)
            ys = np.concatenate([ys, np.repeat(ys[-1:], num_padding, axis=0)], axis=0)
        self.size = len(xs)
        self.keep_tail = keep_tail and not pad_with_last_sample
        if self.keep_tail:
            self.num_batch = -(-self.size // batch_size)  # ceil
        else:
            self.num_batch = self.size // batch_size
        self.rng = rng or np.random.default_rng()
        self.reshuffle_each_epoch = shuffle and reshuffle_each_epoch
        if shuffle and not reshuffle_each_epoch:
            # Parity: one construction-time permutation (model/utils.py:25-27).
            perm = self.rng.permutation(self.size)
            xs, ys = self._gather(xs, perm), self._gather(ys, perm)
        self.xs, self.ys = xs, ys

    @staticmethod
    def _gather(a, perm):
        """``a[perm]``; float32 rows through the host library
        (``data.native``), as the JAX package gathers them."""
        if a.dtype == np.float32:
            from megacrn_tpu_torch.data import native

            return native.index_gather(a, perm)
        return a[perm]

    def __len__(self) -> int:
        return self.num_batch

    def set_epoch(self, epoch: int) -> None:
        """Pin the reshuffle permutation to (seed, epoch); no-op unless the
        loader was built with a ``seed`` (torch DistributedSampler.set_epoch
        semantics, for checkpoint-exact resume)."""
        self._epoch = epoch

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        xs, ys = self.xs, self.ys
        if self.reshuffle_each_epoch:
            if self._seed is not None and self._epoch is not None:
                gen = np.random.default_rng((self._seed, self._epoch))
            else:
                gen = self.rng
            with span("data.reshuffle", bytes=xs.nbytes + ys.nbytes):
                perm = gen.permutation(self.size)
                xs, ys = self._gather(xs, perm), self._gather(ys, perm)
        for i in range(self.num_batch):
            s = i * self.batch_size
            yield xs[s:s + self.batch_size], ys[s:s + self.batch_size]


def prepare_x_y(
    x: np.ndarray, y: np.ndarray, input_dim: int, output_dim: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split raw (B, T, N, C) windows into model inputs
    (model/traintest_MegaCRN.py:33-48): encoder sees x[..., :input_dim]; the
    target is y[..., :output_dim]; the remaining y channels become the decoder
    covariate y_cov."""
    with span("data.prepare"):
        x0 = np.ascontiguousarray(x[..., :input_dim], dtype=np.float32)
        y0 = np.ascontiguousarray(y[..., :output_dim], dtype=np.float32)
        y_cov = np.ascontiguousarray(y[..., output_dim:], dtype=np.float32)
    return x0, y0, y_cov
