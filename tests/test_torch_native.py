"""The port's binding of the host-pipeline library (``data/native.py`` over
``native/megacrn_data.cc``, built with g++ into ``build/``): the five cases
of tests/test_native.py, each entry held bit for bit against the port's
numpy path and against the JAX package's binding on the same arrays."""
import os

import numpy as np
import pytest

from megacrn_tpu.data import native as jnative
from megacrn_tpu_torch.data import native
from megacrn_tpu_torch.data.loader import prepare_x_y

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def numpy_path(monkeypatch):
    """The port's entries with the library taken away: their numpy path."""
    def run(fn, *args):
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            return fn(*args)
    return run


def test_native_library_builds_into_build():
    assert native.available(), "g++ build of native/megacrn_data.cc failed"
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert str(lib).startswith(os.path.join(ROOT, "build", "megacrn_data-"))
    assert lib.exists() and native._load().mcrn_version() == 1


def test_window_gather_matches_numpy_and_jax(numpy_path):
    rng = np.random.RandomState(0)
    data = rng.randn(50, 7, 2).astype(np.float32)
    anchors = np.arange(11, 38)
    offsets = np.arange(-11, 1)
    got = native.window_gather(data, anchors, offsets)
    np.testing.assert_array_equal(got, data[anchors[:, None]
                                            + offsets[None, :]])
    np.testing.assert_array_equal(
        got, numpy_path(native.window_gather, data, anchors, offsets))
    np.testing.assert_array_equal(
        got, jnative.window_gather(data, anchors, offsets))
    with pytest.raises(IndexError):
        native.window_gather(data, np.array([45]), offsets + 12)


def test_index_gather_matches_numpy_and_jax(numpy_path):
    rng = np.random.RandomState(1)
    src = rng.randn(40, 3, 4).astype(np.float32)
    idx = rng.permutation(40)[:17]
    got = native.index_gather(src, idx)
    np.testing.assert_array_equal(got, src[idx])
    np.testing.assert_array_equal(got, numpy_path(native.index_gather, src,
                                                  idx))
    np.testing.assert_array_equal(got, jnative.index_gather(src, idx))


def test_scale_channel_inplace_matches_numpy_and_jax(numpy_path):
    """In place on channel 0 only, the library's ``(x - mean) * (1/std)``
    in f32: the port's numpy path gives it bit for bit (the JAX package's
    numpy fallback divides, within an ulp); the JAX binding's library
    gives the same bits."""
    rng = np.random.RandomState(2)
    data = rng.randn(10, 4, 3).astype(np.float32)
    got, plain, jax_side = data.copy(), data.copy(), data.copy()
    native.scale_channel_inplace(got, 0, 54.4, 19.3)
    numpy_path(native.scale_channel_inplace, plain, 0, 54.4, 19.3)
    jnative.scale_channel_inplace(jax_side, 0, 54.4, 19.3)
    np.testing.assert_array_equal(got, plain)
    assert jnative.available()
    np.testing.assert_array_equal(got, jax_side)
    np.testing.assert_array_equal(got[..., 1:], data[..., 1:])
    np.testing.assert_allclose(got[..., 0], (data[..., 0] - 54.4) / 19.3,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="float32"):
        native.scale_channel_inplace(data.astype(np.float64), 0, 0.0, 1.0)


def test_prepare_xy_matches_python_and_jax(numpy_path):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6, 5, 2).astype(np.float32)
    y = rng.randn(4, 6, 5, 2).astype(np.float32)
    got = native.prepare_xy(x, y, 1, 1)
    for want in (prepare_x_y(x, y, 1, 1),
                 numpy_path(native.prepare_xy, x, y, 1, 1),
                 jnative.prepare_xy(x, y, 1, 1)):
        for g, w in zip(got, want):
            assert g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
