"""The port's directory checkpoints (``ckpt_backend="orbax"``), written with
torch.distributed.checkpoint (``train.checkpoint.save_checkpoint_dcp``):
the round trip, resume from them on one device and on a two-rank data
mesh (each against the uninterrupted run, bit for bit), the two family
CLIs and their predictors, and the trajectory against the JAX package's
``fit(ckpt_backend="orbax")`` at the tolerance of the ``.npz`` trajectory
tests (tests/test_torch_fit.py). A directory Orbax wrote is refused:
tests/test_torch_serve.py."""
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from megacrn_tpu import config as jconfig
from megacrn_tpu import interop as jinterop
from megacrn_tpu.data import datasets as jdatasets
from megacrn_tpu.train import logs as jlogs
from megacrn_tpu.train import loop as jloop
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch import serve as tserve
from megacrn_tpu_torch.cli import traintest_gts, traintest_megacrnx
from megacrn_tpu_torch.data import datasets as tdatasets
from megacrn_tpu_torch.interop import flat_from_state_dict
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.parallel import launch
from megacrn_tpu_torch.train import checkpoint as tckpt
from megacrn_tpu_torch.train import logs as tlogs
from megacrn_tpu_torch.train import loop as tloop

import torch_mesh_ranks
from test_torch_fit import (_assert_trajectories, _data, _model_kw,
                            _resume_setup, _train_kw, _trajectory)

torch.set_num_threads(1)


def test_directory_round_trip_is_exact_and_overwrites_in_place(tmp_path):
    """Every array (0-d ones too), the metadata and the lossless arrays
    come back equal, dtypes kept; a second save replaces the first whole
    (the best-val overwrite) and leaves no temporary directory."""
    rs = np.random.RandomState(0)
    params = {"memory/Memory": rs.randn(4, 8).astype(np.float32),
              "proj/b": rs.randn(1).astype(np.float64)}
    gen = torch.Generator().manual_seed(5)
    path = str(tmp_path / "run" / "ckpt.npz")
    for epoch in (0, 1):
        params = {k: v + epoch for k, v in params.items()}
        opt = {"torch/lr": np.array([1e-3 / (epoch + 1)]),
               "torch/lr_scheduler/last_epoch": np.array(epoch),
               "torch/adam/proj.0.bias/step": torch.tensor(3.0 + epoch)}
        arrays = {"sampling_rng_state": gen.get_state(),
                  "scaler_mean_arr": np.float32([54.4, 1.0 / 3.0])}
        tckpt.save_checkpoint_dcp(path, params, opt, arrays=arrays,
                                  metadata={"epoch": epoch, "best_val": 0.25})
    assert os.path.isdir(path)
    assert sorted(os.listdir(tmp_path / "run")) == ["ckpt.npz"]
    flat, opt_flat, meta = tckpt.load_checkpoint(path)
    for k, v in params.items():
        assert flat[k].dtype == v.dtype
        np.testing.assert_array_equal(flat[k], v)
    assert opt_flat["torch/lr_scheduler/last_epoch"].shape == ()
    assert int(opt_flat["torch/lr_scheduler/last_epoch"]) == 1
    assert float(opt_flat["torch/adam/proj.0.bias/step"]) == 4.0
    np.testing.assert_array_equal(opt_flat["torch/lr"], [5e-4])
    assert meta["epoch"] == 1 and meta["best_val"] == 0.25
    np.testing.assert_array_equal(meta["sampling_rng_state"],
                                  gen.get_state().numpy())
    assert meta["scaler_mean_arr"].dtype == np.float32
    np.testing.assert_array_equal(meta["scaler_mean_arr"],
                                  arrays["scaler_mean_arr"])


def test_fit_resumes_from_a_directory_checkpoint_exactly(tmp_path):
    """tests/test_torch_fit.py's resume case (curriculum and reshuffle on,
    an LR milestone after the cut) on the directory backend: 2 epochs,
    then ``resume=True`` to 4, equal the uninterrupted 4 epochs bit for
    bit, the losses of every epoch included."""
    cfg, train, data, run = _resume_setup(tmp_path, "cut")
    tloop.fit(cfg, train, data, run, max_epochs=2, device="cpu",
              ckpt_backend="orbax")
    assert os.path.isdir(run.checkpoint_path)
    cfg, train, data, run = _resume_setup(tmp_path, "cut")
    resumed = tloop.fit(cfg, train, data, run, resume=True, device="cpu",
                        ckpt_backend="orbax")
    cfg, train, data, whole_run = _resume_setup(tmp_path, "whole")
    whole = tloop.fit(cfg, train, data, whole_run, device="cpu",
                      ckpt_backend="orbax")
    assert resumed["epochs_run"] == whole["epochs_run"] == 4
    for k, v in whole["params"].items():
        np.testing.assert_array_equal(resumed["params"][k], v, err_msg=k)
    assert resumed["test_metrics"] == whole["test_metrics"]
    assert _trajectory(run.metrics_path) == _trajectory(
        whole_run.metrics_path)


def test_fit_on_a_two_rank_mesh_resumes_from_a_directory_exactly(tmp_path):
    """On a (2, 1) data mesh every rank takes part in the save: 1 epoch,
    then ``resume=True`` to the second, equals the uninterrupted two-epoch
    mesh run bit for bit on both ranks."""
    from test_torch_mesh_harness import _spec

    specs = [dict(_spec("whole", tmp_path / "whole"), mesh=(2, 1),
                  ckpt_backend="orbax"),
             dict(_spec("first", tmp_path / "cut"), mesh=(2, 1),
                  ckpt_backend="orbax", max_epochs=1),
             dict(_spec("resumed", tmp_path / "cut"), mesh=(2, 1),
                  ckpt_backend="orbax", resume=True)]
    with open(tmp_path / "specs.pkl", "wb") as f:
        pickle.dump(specs, f)
    launch.spawn(torch_mesh_ranks.fit_runs, 2,
                 args=(str(tmp_path / "specs.pkl"), str(tmp_path)),
                 coordinator=f"file://{tmp_path / 'rendezvous'}",
                 device="cpu")
    got = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for rank in got:
        for k, v in got[0]["whole"]["params"].items():
            np.testing.assert_array_equal(rank["resumed"]["params"][k], v,
                                          err_msg=k)
    assert _trajectory(got[0]["resumed"]["metrics"]) == _trajectory(
        got[0]["whole"]["metrics"])
    run = tmp_path / "cut" / "T_MegaCRN_0"
    assert os.path.isdir(run / "MegaCRN_0.npz")
    assert sorted(os.listdir(tmp_path / "cut")) == ["T_MegaCRN_0"]


FAMILY_CLIS = {
    "megacrnx": (traintest_megacrnx, [
        "--dataset", "SYNTH", "--num_nodes", "12", "--synth_steps", "300",
        "--his_len", "4", "--seq_len", "4", "--hiddenunits", "8",
        "--mem_num", "4", "--mem_dim", "8", "--epoch", "1",
        "--batch_size", "16"]),
    "gts": (traintest_gts, [
        "--dataset", "SYNTH", "--num_nodes", "12", "--synth_steps", "300",
        "--seq_len", "4", "--horizon", "4", "--rnn_units", "8",
        "--max_diffusion_step", "2", "--knn_k", "3", "--batch_size", "16",
        "--epochs", "1"]),
}


@pytest.mark.parametrize("family", sorted(FAMILY_CLIS))
def test_family_cli_writes_directories_its_predictor_reads(tmp_path,
                                                           family):
    """``--ckpt_backend orbax`` on the MegaCRNx and GTS CLIs: the best
    weights (and GTS's BatchNorm state) as directories, from which the
    family's predictor loads the weights the run returned."""
    cli, argv = FAMILY_CLIS[family]
    result = cli.main(argv + ["--save_dir", str(tmp_path), "--device", "cpu",
                              "--ckpt_backend", "orbax"])
    (run,) = os.listdir(tmp_path)
    path = [os.path.join(tmp_path, run, f)
            for f in os.listdir(os.path.join(tmp_path, run))
            if f.endswith(".npz")][0]
    assert os.path.isdir(path)
    model = result["model"]
    if family == "gts":
        assert os.path.isdir(path + ".bn")
        pred = tserve.GTSPredictor.from_checkpoint(
            path, model.cfg, np.zeros((model.cfg.train_series_len,
                                       model.cfg.num_nodes), np.float32),
            device="cpu")
    else:
        pred = tserve.MegaCRNxPredictor.from_checkpoint(path, model.cfg,
                                                        device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(pred.model.state_dict()[k], v, rtol=0,
                                   atol=0, msg=k)


def test_fit_on_directories_matches_jax_fit_on_orbax(tmp_path):
    """The port's ``fit(ckpt_backend="orbax")`` against the JAX package's
    from the same weights and data: every epoch's train loss and val
    metrics at f32 rtol 5e-3, as the .npz trajectories. The JAX fit stops
    at its final reload: ``load_checkpoint_orbax`` restores with a
    params-only template the directory it saved with the optimizer state,
    which Orbax refuses (a fault of the JAX package, ROADMAP Queue 3); the
    port reloads its directory and tests."""
    kind, tkw = _train_kw("METRLA")
    model_kw = _model_kw()
    model = MegaCRN(tconfig.MegaCRNConfig(**model_kw),
                    generator=torch.Generator().manual_seed(7), device="cpu")
    init = flat_from_state_dict(model.state_dict(), 1)
    jrun = jlogs.RunDir(str(tmp_path / "jax"), "T", snapshot_sources=False,
                        timestring="0")
    with pytest.raises(ValueError, match="tree structures do not match"):
        jloop.fit(jconfig.MegaCRNConfig(**model_kw),
                  jconfig.train_config_for(kind, **tkw),
                  _data(jdatasets, kind), jrun, test_every_epoch=False,
                  ckpt_backend="orbax",
                  initial_params=jinterop.params_from_flat(
                      init, 1, dtype=jax.numpy.float32))
    trun = tlogs.RunDir(str(tmp_path / "port"), "T", snapshot_sources=False,
                        timestring="0")
    result = tloop.fit(tconfig.MegaCRNConfig(**model_kw),
                       tconfig.train_config_for(kind, **tkw),
                       _data(tdatasets, kind), trun, test_every_epoch=False,
                       ckpt_backend="orbax", initial_params=init,
                       device="cpu")
    assert os.path.isdir(jrun.checkpoint_path)
    assert os.path.isdir(trun.checkpoint_path)
    _assert_trajectories(_trajectory(jrun.metrics_path),
                         _trajectory(trun.metrics_path), 5e-3, [])
    assert all(np.isfinite(v) for v in result["test_metrics"].values())


def test_unknown_backend_is_refused(tmp_path):
    cfg, train, data, run = _resume_setup(tmp_path, "bad")
    with pytest.raises(ValueError, match="ckpt_backend"):
        tloop.fit(cfg, train, data, run, device="cpu", ckpt_backend="zarr")
