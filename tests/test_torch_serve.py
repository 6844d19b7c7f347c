"""The port's serving path (megacrn_tpu_torch/serve.py) held against the
JAX package's (megacrn_tpu/serve.py) on the same weights and requests."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu import serve as jserve
from megacrn_tpu.config import MegaCRNConfig as JConfig
from megacrn_tpu.kernels.spmm_coo import \
    build_stacked_road_pack as jbuild_pack
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.ops.scaling import inverse_transform as jinverse
from megacrn_tpu.train import checkpoint as jckpt
from megacrn_tpu_torch import serve as tserve
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.ops.scaling import inverse_transform
from megacrn_tpu_torch.train import checkpoint as tckpt

torch.set_num_threads(1)
MEAN, STD = 50.0, 10.0
N = 20


def _setup(backend):
    kw = dict(num_nodes=N, rnn_units=8, mem_num=4, mem_dim=8, horizon=3,
              seq_len=4, graph_backend=backend)
    jcfg = JConfig(use_curriculum_learning=False, **kw)
    tcfg = MegaCRNConfig(**kw)
    params = jmegacrn.init_params(jax.random.PRNGKey(0), jcfg)
    jpack = tpack = None
    if backend == "road_sparse":
        sups = list(dual_random_walk_supports(
            synthetic_road_adjacency(N, avg_degree=4, seed=1)))
        jpack = jbuild_pack(sups, impl="pallas")
        tpack = build_stacked_road_pack(sups)
    return jcfg, tcfg, params, jpack, tpack


def _requests(b, seed=0):
    """Raw speeds in [0, 70] with ~2% missing readings (exact zeros)."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, 4, N, 1) * 70).astype(np.float32)
    x[rs.rand(*x.shape) < 0.02] = 0.0
    return x, rs.randn(b, 3, N, 1).astype(np.float32)


def _pair(tmp_path, backend, max_batch=4):
    """The JAX and the port Predictor, both from one JAX-written .npz."""
    jcfg, tcfg, params, jpack, tpack = _setup(backend)
    path = str(tmp_path / "model.npz")
    jckpt.save_checkpoint(path, params,
                          metadata={"scaler_mean": MEAN, "scaler_std": STD})
    jpred = jserve.Predictor(params, jcfg, MEAN, STD, max_batch,
                             road_supports=jpack)
    tpred = tserve.Predictor.from_checkpoint(path, tcfg, max_batch=max_batch,
                                             road_supports=tpack,
                                             device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("backend", ["dense", "road_sparse"])
def test_predictor_matches_jax(tmp_path, backend):
    jpred, tpred = _pair(tmp_path, backend)
    x, yc = _requests(3)
    want = jpred.predict(x, yc)
    got = tpred.predict(x, yc)
    assert got.shape == (3, 3, N, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * STD)


def test_predictor_chunks_and_pads_like_jax(tmp_path):
    jpred, tpred = _pair(tmp_path, "road_sparse")
    x, _ = _requests(7, seed=1)  # 7 = 4 + 3: JAX pads the 3 to 4, the
    # port runs them as 3
    got = tpred.predict(x)
    np.testing.assert_allclose(got, jpred.predict(x), rtol=1e-4,
                               atol=1e-4 * STD)
    # Per-row results equal the row-at-a-time ones: no padding bleed.
    single = np.concatenate([tpred.predict(x[i:i + 1]) for i in range(7)])
    np.testing.assert_allclose(got, single, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predictor_casts_only_the_forward_pack_once(dtype):
    """Serving reads only the forward pack: the Predictor casts it to the
    compute dtype once, and leaves the backward's pack_t as built."""
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    _, tcfg, _, _, tpack = _setup("road_sparse")
    tcfg = dataclasses.replace(tcfg, compute_dtype=dtype)
    model = MegaCRN(tcfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    pred = tserve.Predictor(model, tcfg, MEAN, STD, 4, road_supports=tpack,
                            device="cpu")
    served = pred.road_supports
    assert served.pack.data.dtype == getattr(torch, dtype)
    assert served.pack_t is tpack.pack_t
    # The forward's own cast to compute_dtype is then a no-op.
    assert served.to(dtype=getattr(torch, dtype)).pack.data is \
        served.pack.data
    x, _ = _requests(2)
    assert np.isfinite(pred.predict(x)).all()


def test_run_batched_pads_by_repeating_the_last_row():
    """The last chunk reaches ``fwd`` as its own rows: no copy of the last
    row is added to it."""
    seen = []

    def fwd(a):
        seen.append(a.copy())
        return a * 2

    x = np.arange(5, dtype=np.float32)[:, None]
    out = tserve._run_batched(fwd, 4, (x,))
    np.testing.assert_array_equal(out, x * 2)
    np.testing.assert_array_equal(seen[1][:, 0], [4])


def _record_batches(pred):
    """Wrap ``pred.model.forward`` to record the batch dimension of each
    call."""
    seen, forward = [], pred.model.forward

    def recorded(x, *args, **kwargs):
        seen.append(x.shape[0])
        return forward(x, *args, **kwargs)

    pred.model.forward = recorded
    return seen


def test_forward_sees_each_chunk_at_its_own_size(tmp_path):
    jpred, tpred = _pair(tmp_path, "road_sparse")
    seen = _record_batches(tpred)
    x, yc = _requests(7, seed=3)
    got = tpred.predict(x, yc)
    assert seen == [4, 3]
    np.testing.assert_allclose(got, jpred.predict(x, yc), rtol=1e-4,
                               atol=1e-4 * STD)

    seen.clear()
    tstream = tserve.StreamingForecaster(tpred)
    jstream = jserve.StreamingForecaster(jpred)
    rs = np.random.RandomState(4)
    for t in range(5):  # seq_len 4: 3 warming pushes, then 2 forecasts
        obs = rs.rand(N).astype(np.float32) * 70
        got, want = tstream.push(obs), jstream.push(obs)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * STD)
    assert seen == [1, 1]


def test_streaming_forecaster_warms_up_then_forecasts(tmp_path):
    jpred, tpred = _pair(tmp_path, "dense")
    tstream = tserve.StreamingForecaster(tpred)
    jstream = jserve.StreamingForecaster(jpred)
    rs = np.random.RandomState(2)
    for t in range(6):
        obs = rs.rand(N).astype(np.float32) * 70
        got, want = tstream.push(obs), jstream.push(obs)
        if t < 3:  # warming (seq_len=4)
            assert got is None and want is None
        else:
            assert got.shape == (3, N, 1) and np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * STD)


def test_streaming_forecaster_passes_covariates_like_jax(tmp_path):
    jpred, tpred = _pair(tmp_path, "road_sparse")

    def cov(t):  # (horizon, N, ycov) covariates for the step after t
        return np.full((3, N, 1), 0.1 * t, np.float32)

    tstream = tserve.StreamingForecaster(tpred, cov_fn=cov)
    jstream = jserve.StreamingForecaster(jpred, cov_fn=cov)
    plain = tserve.StreamingForecaster(tpred)
    rs = np.random.RandomState(4)
    for _ in range(5):
        obs = rs.rand(N).astype(np.float32) * 70
        got, want, no_cov = (tstream.push(obs), jstream.push(obs),
                             plain.push(obs))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * STD)
    assert np.abs(got - no_cov).max() > 1e-3  # the covariates were used


def test_checkpoint_written_by_port_loads_in_jax(tmp_path):
    from megacrn_tpu_torch.interop import flat_from_state_dict

    jcfg, tcfg, params, _, _ = _setup("dense")
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, params, metadata={"scaler_mean": MEAN},
                          arrays={"key": np.arange(2, dtype=np.uint32)})
    flat, opt, meta = tckpt.load_checkpoint(path)
    assert opt is None and meta["scaler_mean"] == MEAN
    np.testing.assert_array_equal(meta["key"], [0, 1])
    pred = tserve.Predictor(flat, tcfg, device="cpu")
    # Back out through the port's writer, into the JAX reader.
    out = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(out, flat_from_state_dict(
        pred.model.state_dict(), tcfg.num_layers),
        metadata={"scaler_std": STD})
    template = jmegacrn.init_params(jax.random.PRNGKey(1), jcfg)
    back, _, meta = jckpt.load_checkpoint(out, template)
    assert meta["scaler_std"] == STD
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_orbax_directory_checkpoint_raises(tmp_path):
    """A directory the JAX package wrote with Orbax is refused by name,
    pointing at .npz (the port's own directories are
    torch.distributed.checkpoint ones: tests/test_torch_checkpoint_dir.py),
    by the reader and by a predictor."""
    jcfg = JConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                   horizon=2, seq_len=2)
    path = str(tmp_path / "orbax_ckpt")
    jckpt.save_checkpoint_orbax(
        path, jmegacrn.init_params(jax.random.PRNGKey(0), jcfg),
        metadata={"epoch": 0})
    with pytest.raises(ValueError, match="Orbax.*npz"):
        tckpt.load_checkpoint(path)
    with pytest.raises(ValueError, match="Orbax"):
        tserve.Predictor.from_checkpoint(
            path, MegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3,
                                mem_dim=4, horizon=2, seq_len=2),
            device="cpu")


def test_inverse_transform_zero_snap_matches_jax():
    mean, std = 54.4, 19.3
    rs = np.random.RandomState(3)
    y = rs.rand(64).astype(np.float32) * 70
    y[::4] = 0.0  # missing readings
    xn = ((y - np.float32(mean)) / np.float32(std)).astype(np.float32)
    # Around the missing-reading value, a few ulps either way: some land in
    # the half-ulp window that snaps to exactly zero.
    near = [np.float32((0 - np.float32(mean)) / np.float32(std))]
    for _ in range(8):
        near = ([np.nextafter(near[0], np.float32(-np.inf))] + near
                + [np.nextafter(near[-1], np.float32(np.inf))])
    xn = np.concatenate([xn, np.array(near, np.float32)])
    got = inverse_transform(torch.from_numpy(xn), std, mean).numpy()
    want = np.asarray(jinverse(jnp.asarray(xn), std, mean))
    np.testing.assert_array_equal(got, want)
    assert (got[:64:4] == 0.0).all() and (got[64:] == 0.0).any()


def test_predictor_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means the card")
    from megacrn_tpu_torch.models.megacrn import MegaCRN

    tcfg = _setup("dense")[1]
    model = MegaCRN(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.Predictor(model, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MegaCRN(tcfg)


GOLDEN_FIELDS = ("num_nodes", "input_dim", "output_dim", "horizon",
                 "seq_len", "rnn_units", "num_layers", "cheb_k", "ycov_dim",
                 "mem_num", "mem_dim")


def _golden_predictor():
    """A dense Predictor on the reference golden's weights (mean 0, std 1,
    so the forecasts are the golden's outputs), its request and its
    forecasts."""
    blob = dict(np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                     "megacrn_small.npz")))
    cfg = MegaCRNConfig(**{k: int(v) for k, v in zip(GOLDEN_FIELDS,
                                                     blob["meta/config"])})
    pred = tserve.Predictor(blob, cfg, 0.0, 1.0, max_batch=2, device="cpu")
    return pred, (blob["in/x"], blob["in/y_cov"]), blob["out/output"]


@pytest.mark.parametrize("backend", ["dense", "road_sparse"])
def test_cpu_predictor_captures_no_graph(tmp_path, backend):
    """On the CPU every chunk runs the eager forward: no graph is kept,
    no ``serve.capture`` is recorded and every ``serve.forward`` counts
    ``graphed=0``; the forecasts hold against the reference golden (dense)
    or the JAX predictor (road_sparse)."""
    from megacrn_tpu_torch.train import telemetry as tele

    if backend == "dense":
        tpred, request, want = _golden_predictor()
        tol = dict(atol=5e-5, rtol=1e-4)
    else:
        jpred, tpred = _pair(tmp_path, backend)
        request = _requests(7, seed=5)
        want = jpred.predict(*request)
        tol = dict(rtol=1e-4, atol=1e-4 * STD)
    tele.clear()
    first, again = tpred.predict(*request), tpred.predict(*request)
    recorded = tele.spans()
    tele.clear()
    assert tpred._graphs is None
    assert not [s for s in recorded if s.name == "serve.capture"]
    forwards = [s for s in recorded if s.name == "serve.forward"]
    assert len(forwards) == 4 and all(s.counts == {"graphed": 0}
                                      for s in forwards)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_allclose(first, want, **tol)
