"""``train.prefetch.device_prefetch`` held against the JAX package's
(megacrn_tpu/train/prefetch.py): the same batches in the same order, at
most ``depth`` placed ahead of the one handed out, empty and one-batch
iterators, and the identity placement on the CPU. The card's placement
(pinned copies on a side stream) runs in chip_smoke.py phase 20 (d)."""
import numpy as np
import pytest
import torch

from megacrn_tpu.train import prefetch as jprefetch
from megacrn_tpu_torch.data.loader import BatchLoader, prepare_x_y
from megacrn_tpu_torch.train.prefetch import device_prefetch


def _recording():
    placed = []

    def place(batch):
        placed.append(batch)
        return ("placed", batch)

    return placed, place


@pytest.mark.parametrize("n,depth", [(0, 2), (1, 2), (5, 1), (5, 2),
                                     (5, 7)])
def test_same_batches_order_and_lookahead_as_jax(n, depth):
    """Each batch handed out once, in order, placed by ``place_fn``; when
    batch k is handed out, batches up to k + depth have been placed (the
    JAX generator's schedule), never more."""
    got_placed, got_place = _recording()
    want_placed, want_place = _recording()
    got, want = [], []
    for b in device_prefetch(range(n), got_place, depth=depth):
        got.append((b, len(got_placed)))
    for b in jprefetch.device_prefetch(range(n), want_place, depth=depth):
        want.append((b, len(want_placed)))
    assert got == want
    assert [b for b, _ in got] == [("placed", k) for k in range(n)]
    for k, (_, placed) in enumerate(got):
        assert placed == min(n, k + 1 + depth)


def test_cpu_placement_is_the_identity_on_loader_batches():
    """On the CPU the default placement hands the loader's prepared arrays
    out in the loader's order as tensors over the same memory."""
    rs = np.random.RandomState(0)
    x, y = (rs.randn(40, 3, 5, 2).astype(np.float32) for _ in "xy")
    loader = BatchLoader(x, y, 8, shuffle=True,
                         rng=np.random.default_rng(1))
    want = [prepare_x_y(a, b, 1, 1) for a, b in loader]
    got = list(device_prefetch(want, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for ga, wa in zip(g, w):
            assert isinstance(ga, torch.Tensor)
            assert ga.data_ptr() == wa.ctypes.data
            np.testing.assert_array_equal(ga.numpy(), wa)


def test_depth_below_one_is_refused():
    with pytest.raises(ValueError, match="depth"):
        list(device_prefetch(range(3), lambda b: b, depth=0))
