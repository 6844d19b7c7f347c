"""The port's metrics, eval modes and fit-loop helpers (ops/metrics,
train/{eval_modes,telemetry,logs,checkpoint}, nn/init.xavier_uniform,
train/loop.evaluate) held against the JAX package on the same seeded numpy
inputs."""
import json
import logging
import os

import numpy as np
import pytest
import torch

from megacrn_tpu.config import MegaCRNConfig as JMegaCRNConfig
from megacrn_tpu.data import loader as jloader
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.ops import metrics as jmetrics
from megacrn_tpu.train import checkpoint as jckpt
from megacrn_tpu.train import eval_modes as jeval_modes
from megacrn_tpu.train import logs as jlogs
from megacrn_tpu.train import loop as jloop
from megacrn_tpu.train import telemetry as jtele
from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig
from megacrn_tpu_torch.data import loader as tloader
from megacrn_tpu_torch.data.scalers import ColumnScaler
from megacrn_tpu_torch.interop import flat_from_state_dict, params_from_flat
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.nn import init as tinit
from megacrn_tpu_torch.ops import metrics as tmetrics
from megacrn_tpu_torch.train import checkpoint as tckpt
from megacrn_tpu_torch.train import eval_modes as teval_modes
from megacrn_tpu_torch.train import logs as tlogs
from megacrn_tpu_torch.train import loop as tloop
from megacrn_tpu_torch.train import optim as toptim
from megacrn_tpu_torch.train import telemetry as ttele


def _targets(seed, shape=(7, 6, 5, 1)):
    """Speeds with exact zeros (missing), tiny values (the EXPY-TKY flavour
    zeroes < 1e-5) and a prediction near them."""
    rs = np.random.RandomState(seed)
    y = rs.uniform(0.0, 70.0, shape).astype(np.float32)
    y[rs.rand(*shape) < 0.1] = 0.0
    y[rs.rand(*shape) < 0.05] = 3e-6
    p = (y + rs.randn(*shape) * 4.0).astype(np.float32)
    p[rs.rand(*shape) < 0.05] = 5e-6
    return y, p


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_metrics_equal_both_flavours(seed):
    y, p = _targets(seed)
    for name in ("mse", "rmse", "mae", "mape"):
        assert getattr(tmetrics, name)(y, p) == getattr(jmetrics, name)(y, p)
    assert tmetrics.mape(y, p, np.nan) == jmetrics.mape(y, p, np.nan)
    assert tmetrics.evaluate(y, p) == jmetrics.evaluate(y, p)
    y_before = y.copy()
    assert tmetrics.evaluate_expytky(y, p) == jmetrics.evaluate_expytky(y, p)
    np.testing.assert_array_equal(y, y_before)  # on copies
    assert np.isnan(tmetrics.mae(np.zeros(3), np.ones(3))) == np.isnan(
        jmetrics.mae(np.zeros(3), np.ones(3)))


def _loader(seed, n=45, batch=8, channels=2):
    rs = np.random.RandomState(seed)
    xs = rs.randn(n, 4, 5, channels).astype(np.float32)
    ys = rs.uniform(-1.0, 2.0, (n, 6, 5, channels)).astype(np.float32)
    ys[..., 0][rs.rand(n, 6, 5) < 0.1] = 0.0
    return xs, ys, batch


def _predict_np(x0, y_cov):
    """A deterministic stand-in for the model: same numbers on both
    sides."""
    base = np.tanh(x0.sum(1, keepdims=True))  # (B, 1, N, 1)
    return (base + y_cov[..., :1]).astype(np.float32)


def test_eval_expytky_equal_on_the_same_predictions():
    xs, ys, b = _loader(2)
    rs = np.random.RandomState(3)
    scaler = ColumnScaler(rs.uniform(20, 60, 5), rs.uniform(5, 15, 5))
    got = teval_modes.eval_expytky(
        lambda x0, yc: torch.from_numpy(_predict_np(x0, yc)),
        tloader.BatchLoader(xs, ys, b), 1, 1, scaler)
    want = jeval_modes.eval_expytky(_predict_np, jloader.BatchLoader(xs, ys, b),
                                    1, 1, scaler)
    assert set(got) == set(want) and "mae_6" in got
    for k in want:
        assert got[k] == want[k], k


def test_eval_concat_matches_on_the_same_predictions():
    """Trim to the true sample count, the bare inverse transform and the
    masked losses over the concatenation. The JAX flavour reduces with XLA
    (jnp) and the port with torch, so only the f32 summation order differs:
    rtol 1e-6."""
    xs, ys, b = _loader(4)
    got = teval_modes.eval_concat(
        lambda x0, yc: torch.from_numpy(_predict_np(x0, yc)),
        tloader.BatchLoader(xs, ys, b), 1, 1, 40.0, 12.0,
        horizon_steps=(3, 6, 12))
    want = jeval_modes.eval_concat(_predict_np, jloader.BatchLoader(xs, ys, b),
                                   1, 1, 40.0, 12.0, horizon_steps=(3, 6, 12))
    assert set(got) == set(want) == {"mae", "mape", "rmse", "mae_3", "mape_3",
                                     "rmse_3", "mae_6", "mape_6", "rmse_6"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_evaluate_drains_in_blocks_and_summarises_like_jax():
    """train.loop.evaluate over 23 batches (blocks of 10, 10, 3) with a
    stand-in eval step on both sides."""
    xs, ys, b = _loader(5, n=23 * 4, batch=4)
    jcfg = JMegaCRNConfig(num_nodes=5, horizon=6, seq_len=4)
    cfg = MegaCRNConfig(num_nodes=5, horizon=6, seq_len=4)
    keys = ["loss", "mae", "mape", "mse", "mae_3", "mape_3", "mse_3",
            "mae_6", "mape_6", "mse_6"]

    def step_np(x0, y0, yc):
        d = _predict_np(x0, yc) - y0
        return {k: np.float32(np.abs(d).mean() * (i + 1))
                for i, k in enumerate(keys)}

    calls = []

    def step_t(x0, y0, yc):
        calls.append(1)
        return {k: torch.tensor(v) for k, v in step_np(
            x0.numpy(), y0.numpy(), yc.numpy()).items()}

    got = tloop.evaluate(step_t, tloader.BatchLoader(xs, ys, b), cfg, 1, 1)
    want = jloop.evaluate(step_np, jloader.BatchLoader(xs, ys, b), jcfg, 1, 1)
    assert len(calls) == 23
    assert got == want


def test_edge_traversals_and_step_timer():
    for kw in (dict(num_nodes=207, cheb_k=3, seq_len=12, horizon=12,
                    batch=64), dict(num_nodes=1843, cheb_k=3, seq_len=6,
                                    horizon=6, batch=64, nnz=40000)):
        assert (ttele.edge_traversals_per_step(**kw)
                == jtele.edge_traversals_per_step(**kw))
    assert ttele.peak_device_memory(torch.device("cpu")) is None


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ttele.profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_xavier_uniform_bound_and_reinit():
    g = torch.Generator().manual_seed(0)
    w = tinit.xavier_uniform((300, 100), g)
    bound = np.sqrt(6.0 / 400)
    assert w.abs().max().item() <= bound
    assert w.abs().max().item() > 0.98 * bound  # fills the interval
    np.testing.assert_allclose(w.std().item(), bound / np.sqrt(3), rtol=0.02)
    again = tinit.xavier_uniform((300, 100), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)

    cfg = MegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                        horizon=2, seq_len=2)
    model = MegaCRN(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tloop._reinit_xavier_uniform(model, torch.Generator().manual_seed(1))
    for name, p in model.named_parameters():
        assert not torch.equal(p, before[name]), name
        if p.dim() > 1:
            b = np.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            assert p.abs().max().item() <= b, name
        else:  # U(0, 1) on 1-D params
            assert 0.0 <= p.min().item() and p.max().item() < 1.0, name


def test_run_dir_contract_matches_jax(tmp_path):
    t = tlogs.RunDir(str(tmp_path / "t"), "SYNTH", timestring="20260101000000")
    j = jlogs.RunDir(str(tmp_path / "j"), "SYNTH", timestring="20260101000000",
                     snapshot_sources=False)
    for attr in ("path", "prefix", "logging_path", "score_path",
                 "epochlog_path", "checkpoint_path", "metrics_path"):
        assert os.path.relpath(getattr(t, attr), str(tmp_path / "t")) == \
            os.path.relpath(getattr(j, attr), str(tmp_path / "j")), attr
    snap = os.path.join(t.path, "src_snapshot", "megacrn_tpu_torch")
    assert os.path.exists(os.path.join(snap, "train", "loop.py"))
    assert os.path.exists(os.path.join(snap, "kernels", "csrc",
                                       "spmm_coo.cu"))
    logger = t.get_logger()
    logger.info("a", 1, 2.5)
    t.log_metrics({"epoch": 1})
    t.append_scores("s")
    t.append_epochlog("e")
    tlogs.echo_hparams(logger, model=MegaCRNConfig())
    with open(t.logging_path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "a 1 2.5" and "model.num_nodes 207" in lines
    record = logging.LogRecord("x", logging.INFO, "", 0, "m", ("b", 3), None)
    assert (tlogs.SpaceJoinFormatter().format(record)
            == jlogs.SpaceJoinFormatter().format(
                logging.LogRecord("x", logging.INFO, "", 0, "m", ("b", 3),
                                  None)))
    tlogs.RunDir(str(tmp_path / "t"), "SYNTH", timestring="20250101000000",
                 snapshot_sources=False)
    assert tlogs.RunDir.latest_timestring(str(tmp_path / "t"), "SYNTH") == \
        "20260101000000"
    assert tlogs.RunDir.latest_timestring(str(tmp_path / "t"), "EXPYTKY") \
        is None


def _trained_optimizer(cfg, seed=0, steps=2):
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    tcfg = TrainConfig(lr_milestones=(1, 3))
    opt = toptim.make_optimizer(model.parameters(), tcfg)
    sched = toptim.make_lr_scheduler(opt, tcfg)
    rs = np.random.RandomState(seed)
    for _ in range(steps):
        for p in model.parameters():
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        opt.step()
        sched.step()
    return model, opt, sched


def test_checkpoint_round_trips_the_restartable_state(tmp_path):
    cfg = MegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                        horizon=2, seq_len=2)
    model, opt, sched = _trained_optimizer(cfg)
    gen = torch.Generator().manual_seed(9)
    torch.rand(5, generator=gen)
    path = str(tmp_path / "c.npz")
    named = list(model.named_parameters())
    tckpt.save_checkpoint(
        path, flat_from_state_dict(model.state_dict(), 1),
        tckpt.optimizer_state(opt, sched, named),
        metadata={"epoch": 3, "best_val": 1.5},
        arrays={"sampling_rng_state": gen.get_state(),
                "scaler_mean_arr": np.arange(6.0)})
    flat, opt_state, meta = tckpt.load_checkpoint(path)
    assert meta["epoch"] == 3 and meta["best_val"] == 1.5
    np.testing.assert_array_equal(meta["scaler_mean_arr"], np.arange(6.0))
    assert "torch/adam/proj.0.weight/exp_avg_sq" in opt_state

    # A fresh model/optimizer restored from the file continues identically.
    model2, opt2, sched2 = _trained_optimizer(cfg, seed=1, steps=0)
    model2.load_state_dict(params_from_flat(flat, cfg))
    tckpt.restore_optimizer(opt2, sched2, opt_state,
                            list(model2.named_parameters()))
    gen2 = torch.Generator()
    gen2.set_state(torch.from_numpy(meta["sampling_rng_state"]))
    assert torch.equal(torch.rand(3, generator=gen),
                       torch.rand(3, generator=gen2))
    assert sched2.last_epoch == sched.last_epoch == 2
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    rs = np.random.RandomState(7)
    for m, o, s in ((model, opt, sched), (model2, opt2, sched2)):
        rs.seed(7)
        for _ in range(2):
            for p in m.parameters():
                p.grad = torch.from_numpy(
                    rs.randn(*p.shape).astype(np.float32))
            o.step()
            s.step()
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), k
    assert opt2.param_groups[0]["lr"] == opt.param_groups[0]["lr"]


def test_jax_checkpoint_loads_params_and_refuses_resume(tmp_path):
    """A JAX-written file (optax state under opt/) loads its params into
    the port; resuming a torch Adam from its optax state raises."""
    import jax
    import optax

    jcfg = JMegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                          horizon=2, seq_len=2)
    params = jmegacrn.init_params(jax.random.PRNGKey(0), jcfg)
    opt_state = optax.adam(1e-3).init(params)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, params, opt_state, metadata={"epoch": 0})
    flat, opt_flat, meta = tckpt.load_checkpoint(path)
    cfg = MegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                        horizon=2, seq_len=2)
    model = MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat, cfg))
    np.testing.assert_array_equal(model.memory["Memory"].detach().numpy(),
                                  np.asarray(params["memory"]["Memory"]))
    assert opt_flat and not any(k.startswith("torch/") for k in opt_flat)
    opt = toptim.make_optimizer(model.parameters(), TrainConfig())
    sched = toptim.make_lr_scheduler(opt, TrainConfig())
    with pytest.raises(ValueError, match="no optimizer state written by"):
        tckpt.restore_optimizer(opt, sched, opt_flat,
                                list(model.named_parameters()))
    # A directory that holds no checkpoint is refused.
    with pytest.raises(ValueError, match="no checkpoint"):
        tckpt.load_checkpoint(str(tmp_path))
