"""The port's MegaCRNx harness (data/windowing.ratio_windows,
data/hdf5.read_hdf, train/megacrnx_loop.fit_megacrnx,
cli/traintest_megacrnx.py, serve.MegaCRNxPredictor) held against the JAX
package on the CPU at a CI size (12 nodes, 300 steps, 4 -> 4, units 8,
memory 4x8, batch 16)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu import serve as jserve
from megacrn_tpu.cli import traintest_megacrnx as jcli
from megacrn_tpu.data.windowing import ratio_windows as jratio
from megacrn_tpu.models import megacrnx as jx
from megacrn_tpu.ops import losses as jlosses
from megacrn_tpu.train import logs as jlogs
from megacrn_tpu.train import megacrnx_loop as jloop
from megacrn_tpu_torch import serve as tserve
from megacrn_tpu_torch.cli import traintest_megacrnx as tcli
from megacrn_tpu_torch.data.hdf5 import read_hdf
from megacrn_tpu_torch.data.windowing import ratio_windows
from megacrn_tpu_torch.interop import flat_from_megacrnx_state_dict
from megacrn_tpu_torch.models import megacrnx as tx
from megacrn_tpu_torch.train import logs as tlogs
from megacrn_tpu_torch.train import megacrnx_loop as tloop

torch.set_num_threads(1)
BASE = ["--dataset", "SYNTH", "--num_nodes", "12", "--synth_steps", "300",
        "--his_len", "4", "--seq_len", "4", "--hiddenunits", "8",
        "--mem_num", "4", "--mem_dim", "8", "--batch_size", "16",
        "--seed", "1"]
EPOCHS = 2


@pytest.mark.parametrize("mode", ["train", "test"])
@pytest.mark.parametrize("with_time", [True, False])
def test_ratio_windows_equals_jax(mode, with_time):
    rs = np.random.RandomState(0)
    values = rs.rand(50, 5).astype(np.float32)
    vtime = rs.rand(50, 5).astype(np.float32) if with_time else None
    got = ratio_windows(values, vtime, 4, 3, 0.8, mode)
    want = jratio(values, vtime, 4, 3, 0.8, mode)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)


def test_build_data_equals_jax():
    """Both CLIs' SYNTH data from the same flags: equal arrays."""
    got = tcli.build_data(tcli.build_parser().parse_args(BASE))
    want = jcli.build_data(jcli.build_parser().parse_args(BASE))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _jax_tree(flat):
    """The JAX MegaCRNx params pytree of the flat naming (one layer)."""
    def cells(mod):
        return [{sub: {"W": flat[f"{mod}/0/{sub}/W"],
                       "b": flat[f"{mod}/0/{sub}/b"]}
                 for sub in ("gate", "update")}]
    return {"node_embeddings": flat["node_embeddings"],
            "memory": {k: flat[f"memory/{k}"]
                       for k in ("Memory", "Wq", "FC_E")},
            "encoder": cells("encoder"), "decoder": cells("decoder"),
            "proj": {"W": flat["proj/W"], "b": flat["proj/b"]}}


def _records(path):
    epochs, final = [], None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "val_loss" in rec:
                epochs.append((rec["train_loss"], rec["val_loss"]))
            if "final_test" in rec:
                final = rec["final_test"]
    return epochs, final


def _fit_both(base, dtype=np.float32, argv=()):
    """JAX fit_megacrnx and the port's from the same initial weights (the
    port's seeded init) and each package's own data; returns (JAX run dir,
    JAX result, port run dir, port result, config)."""
    args = tcli.build_parser().parse_args(BASE + list(argv))
    data = tcli.build_data(args)
    cfg, tcfg = tcli.configs_from_args(args, data["num_nodes"])
    if dtype == np.float64:
        cfg = tx.MegaCRNxConfig(**dict(cfg.__dict__,
                                       compute_dtype="float64"))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = tx.MegaCRNx(cfg, generator=torch.Generator().manual_seed(7),
                        device="cpu", dtype=tdtype)
    init = flat_from_megacrnx_state_dict(model.state_dict(), 1)
    jargs = jcli.build_parser().parse_args(BASE + list(argv))
    jdata = jcli.build_data(jargs)
    jcfg = jx.MegaCRNxConfig(**cfg.__dict__)
    jrun = jlogs.RunDir(str(base / "jax"), "SYNTH", model_name="MegaCRNx",
                        snapshot_sources=False, timestring="0")
    jres = jloop.fit_megacrnx(
        jcfg, jloop.MegaCRNxTrainConfig(**tcfg.__dict__), jdata, jrun,
        max_epochs=EPOCHS,
        initial_params=jax.tree_util.tree_map(jnp.asarray, _jax_tree(init)))
    trun = tlogs.RunDir(str(base / "port"), "SYNTH", model_name="MegaCRNx",
                        snapshot_sources=False, timestring="0")
    tres = tloop.fit_megacrnx(cfg, tcfg, data, trun, max_epochs=EPOCHS,
                              initial_params=init, device="cpu")
    return jrun, jres, trun, tres, cfg


def _assert_same_run(jrun, jres, trun, tres, rtol):
    (w_epochs, w_final), (g_epochs, g_final) = (_records(jrun.metrics_path),
                                                _records(trun.metrics_path))
    assert len(g_epochs) == len(w_epochs) == EPOCHS
    np.testing.assert_allclose(g_epochs, w_epochs, rtol=rtol)
    assert set(g_final) == set(w_final)
    for k, w in w_final.items():
        np.testing.assert_allclose(g_final[k], w, rtol=rtol, err_msg=k)
    w_m, g_m = jres["test_metrics"], tres["test_metrics"]
    for k in ("mse", "rmse", "mae", "mape", "loss"):
        np.testing.assert_allclose(g_m[k], w_m[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(g_m["per_step"], w_m["per_step"], rtol=rtol)
    assert tres["epochs_run"] == jres["epochs_run"]
    with open(trun.score_path) as f, open(jrun.score_path) as g:
        assert len(f.readlines()) == len(g.readlines()) == 1 + 4
    # both learned
    assert g_epochs[-1][1] < g_epochs[0][1]


@pytest.fixture(scope="module")
def fits_f32(tmp_path_factory):
    return _fit_both(tmp_path_factory.mktemp("fit32"))


def test_fit_megacrnx_matches_jax_f32(fits_f32):
    """Per-epoch train and val losses, the final test metrics, all steps
    and per step, f32 rtol 5e-3 (the summation orders differ and the
    difference compounds over the optimizer steps)."""
    _assert_same_run(*fits_f32[:4], rtol=5e-3)


def _null_mask_divided(labels, null_val):
    """The JAX ``_null_mask`` with torch's rounding: the f32 mean as sum / n
    and the mask divided by it, as ``torch.mean`` and ``/`` round them (the
    reference's ``mask /= torch.mean(mask)``, which the port keeps).
    ``jnp.mean`` multiplies by 1/n instead, and under jit XLA also turns
    the division by the broadcast mean into a multiply by its reciprocal:
    the normalised masks then differ by one f32 ulp for about a third of
    the counts (255 of 768 at this batch), which shows at ~1e-7 in a double
    run whose mask is f32 in both packages. The optimization barriers keep
    XLA from rewriting the two divisions."""
    mask = (labels > null_val).astype(jnp.float32)
    n = jax.lax.optimization_barrier(jnp.asarray(mask.size, jnp.float32))
    mean = jax.lax.optimization_barrier(
        jnp.broadcast_to(jnp.sum(mask) / n, mask.shape))
    return jlosses._NAN_FIX(mask / mean)


def test_null_mask_mean_rounding_is_torch_s_in_the_port():
    """The port's MaskMAE normalises its f32 mask as torch.mean does (the
    reference): equal to the divided JAX mask, and one ulp off jnp.mean's
    for such a count."""
    labels = np.zeros(768, np.float32)
    labels[:5] = 1.0
    from megacrn_tpu_torch.ops import losses as tlosses

    got = tlosses._null_mask(torch.from_numpy(labels), 1e-3).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_null_mask_divided(jnp.asarray(labels), 1e-3)))
    assert not np.array_equal(
        got, np.asarray(jlosses._null_mask(jnp.asarray(labels), 1e-3)))


def test_fit_megacrnx_matches_jax_f64(tmp_path, monkeypatch):
    """Both packages in double: within 1e-9, the JAX MaskMAE's mask
    normalised with torch's rounding (``_null_mask_divided``). x64 is scoped
    to this test."""
    monkeypatch.setattr(jlosses, "_null_mask", _null_mask_divided)
    with jax.enable_x64(True):
        runs = _fit_both(tmp_path, np.float64)
    assert not jax.config.jax_enable_x64
    _assert_same_run(*runs[:4], rtol=1e-9)


def test_predictor_matches_jax_on_a_jax_checkpoint(fits_f32):
    """MegaCRNxPredictor.from_checkpoint on the checkpoint the JAX
    fit_megacrnx wrote, against the JAX predictor: 11 raw windows in
    chunks of 8."""
    jrun, _, _, _, cfg = fits_f32
    want_p = jserve.MegaCRNxPredictor.from_checkpoint(
        jrun.checkpoint_path, jx.MegaCRNxConfig(**cfg.__dict__), max_batch=8)
    got_p = tserve.MegaCRNxPredictor.from_checkpoint(
        jrun.checkpoint_path, cfg, max_batch=8, device="cpu")
    rs = np.random.RandomState(3)
    x = rs.uniform(0, 70, (11, cfg.seq_len, cfg.num_nodes, 1)).astype(
        np.float32)
    yc = rs.uniform(0, 1, (11, cfg.horizon, cfg.num_nodes, 1)).astype(
        np.float32)
    for y_cov in (yc, None):
        got, want = got_p.predict(x, y_cov), want_p.predict(x, y_cov)
        assert got.shape == (11, cfg.horizon, cfg.num_nodes, 1)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


def test_predictor_pads_a_short_chunk_like_jax(fits_f32):
    """MegaCRNx's support sums over the windows of a forward, so a request
    of one window, and a stream's push, run padded to ``max_batch`` as in
    the JAX predictor, and forecast as it does."""
    jrun, _, _, _, cfg = fits_f32
    want_p = jserve.MegaCRNxPredictor.from_checkpoint(
        jrun.checkpoint_path, jx.MegaCRNxConfig(**cfg.__dict__), max_batch=8)
    got_p = tserve.MegaCRNxPredictor.from_checkpoint(
        jrun.checkpoint_path, cfg, max_batch=8, device="cpu")
    seen, forward = [], got_p.model.forward

    def recorded(x, *args, **kwargs):
        seen.append(x.shape[0])
        return forward(x, *args, **kwargs)

    got_p.model.forward = recorded
    rs = np.random.RandomState(5)
    x = rs.uniform(0, 70, (1, cfg.seq_len, cfg.num_nodes, 1)).astype(
        np.float32)
    got, want = got_p.predict(x), want_p.predict(x)
    assert got.shape == (1, cfg.horizon, cfg.num_nodes, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    gstream = tserve.StreamingForecaster(got_p)
    jstream = jserve.StreamingForecaster(want_p)
    for _ in range(cfg.seq_len + 1):
        obs = rs.uniform(0, 70, cfg.num_nodes).astype(np.float32)
        got, want = gstream.push(obs), jstream.push(obs)
        if want is not None:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max())
    assert seen == [8, 8, 8]


def test_cli_writes_every_artifact_and_refuses_the_mesh(tmp_path):
    res = tcli.main(BASE + ["--epoch", "1", "--device", "cpu", "--loss",
                            "MAE", "--decoder", "sequence", "--meta",
                            "False", "--save_dir", str(tmp_path)])
    assert res["epochs_run"] == 1 and np.isfinite(res["test_metrics"]["mae"])
    (run,) = os.listdir(tmp_path)
    assert run.startswith("SYNTH_MegaCRNx_")
    files = os.listdir(tmp_path / run)
    for suffix in (".npz", "_logging.txt", "_epochlog.txt", "_scores.txt",
                   "metrics.jsonl", "src_snapshot"):
        assert any(f.endswith(suffix) for f in files), suffix
    # The mesh is ported (tests/test_torch_mesh_harness.py); one it cannot
    # build is refused before any rank starts.
    for flag in ("--mesh_data", "--mesh_node"):
        with pytest.raises(SystemExit, match="--mesh_data and --mesh_node"):
            tcli.main(BASE + [flag, "0", "--device", "cpu"])


def write_pandas_fixed(path, values, index, columns, blocks=None):
    """A DataFrame in the layout ``DataFrame.to_hdf(format="fixed")`` writes
    through PyTables (the metr-la.h5 layout), written with h5py.
    ``blocks``: [(column positions, stored transposed)], default one block
    of every column, transposed as pandas stores it."""
    import h5py

    blocks = blocks or [(list(range(values.shape[1])), True)]
    with h5py.File(path, "w") as f:
        g = f.create_group("df")
        g.attrs["pandas_type"] = np.bytes_(b"frame")
        g.attrs["pandas_version"] = np.bytes_(b"0.15.2")
        g.attrs["ndim"] = np.int64(2)
        g.attrs["nblocks"] = np.int64(len(blocks))
        g.create_dataset("axis0", data=columns).attrs["kind"] = \
            np.bytes_(b"string")
        g.create_dataset("axis1", data=index.astype("datetime64[ns]").astype(
            np.int64)).attrs["kind"] = np.bytes_(b"datetime64")
        for i, (cols, transposed) in enumerate(blocks):
            g.create_dataset(f"block{i}_items", data=columns[cols]).attrs[
                "kind"] = np.bytes_(b"string")
            vals = values[:, cols]
            ds = g.create_dataset(f"block{i}_values",
                                  data=vals if transposed else vals.T)
            ds.attrs["transposed"] = np.bool_(transposed)


@pytest.mark.parametrize("layout", ["one_block", "two_blocks"])
def test_hdf5_reader_reads_the_pandas_fixed_layout(tmp_path, layout):
    rs = np.random.RandomState(1)
    values = rs.uniform(0, 70, (30, 5))
    index = (np.datetime64("2012-03-01") + np.arange(30)
             * np.timedelta64(5, "m"))
    columns = np.array([b"773869", b"767541", b"767542", b"717447",
                        b"717446"])
    blocks = None if layout == "one_block" else [([0, 3], True),
                                                 ([4, 1, 2], False)]
    path = str(tmp_path / "speed.h5")
    write_pandas_fixed(path, values, index, columns, blocks)
    got, got_index, got_columns = read_hdf(path)
    np.testing.assert_array_equal(got, values)
    np.testing.assert_array_equal(got_index, index.astype("datetime64[ns]"))
    np.testing.assert_array_equal(got_columns, columns)


def test_cli_reads_metrla_h5_and_checks_its_width(tmp_path):
    """--dataset METRLA --data_path <h5>: the CLI's data equals the ratio
    windows of the file's series; a file of another width exits."""
    rs = np.random.RandomState(2)
    values = rs.uniform(0, 70, (120, 207)).astype(np.float32)
    index = (np.datetime64("2012-03-01") + np.arange(120)
             * np.timedelta64(5, "m"))
    path = str(tmp_path / "metr-la.h5")
    write_pandas_fixed(path, values, index,
                       np.array([str(i).encode() for i in range(207)]))
    argv = ["--dataset", "METRLA", "--data_path", path]
    data = tcli.build_data(tcli.build_parser().parse_args(argv))
    assert data["num_nodes"] == 207
    xs, ys, _ = ratio_windows(values, None, 12, 12, 0.8, "train")
    np.testing.assert_array_equal(data["y_trainval"], ys)
    mean, std = data["scaler_mean"], data["scaler_std"]
    np.testing.assert_allclose(data["x_trainval"], (xs - mean) / std,
                               rtol=1e-6)
    with pytest.raises(SystemExit, match="PEMSBAY expects 325"):
        tcli.build_data(tcli.build_parser().parse_args(
            ["--dataset", "PEMSBAY", "--data_path", path]))


def test_hdf5_reader_exits_naming_h5py_when_it_is_missing(monkeypatch,
                                                          tmp_path):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(SystemExit, match="h5py"):
        read_hdf(str(tmp_path / "metr-la.h5"))
