"""The port's GTS harness (train/gts_loop.fit_gts and its eval step,
cli/traintest_gts.py, serve.GTSPredictor under StreamingForecaster, the
reference-name mapping of interop) held against the JAX package on the CPU
at a CI size (10 nodes, 300 steps, 4 -> 4, units 8, diffusion 2,
embedding 16, batch 16)."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu import config as jconfig
from megacrn_tpu import interop as jinterop
from megacrn_tpu import serve as jserve
from megacrn_tpu.data import datasets as jdatasets
from megacrn_tpu.models import gts as jgts
from megacrn_tpu.ops import losses as jlosses
from megacrn_tpu.train import gts_loop as jloop
from megacrn_tpu.train import logs as jlogs
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch import serve as tserve
from megacrn_tpu_torch.cli import traintest_gts as tcli
from megacrn_tpu_torch.data import datasets as tdatasets
from megacrn_tpu_torch.data.synthetic import synthetic_speed_series
from megacrn_tpu_torch.interop import (flat_from_gts_state_dict,
                                       gts_params_from_flat)
from megacrn_tpu_torch.models import gts as tgts
from megacrn_tpu_torch.train import gts_loop as tloop
from megacrn_tpu_torch.train import logs as tlogs

torch.set_num_threads(1)
NODES, STEPS, SEQ, BATCH, EPOCHS = 10, 300, 4, 16, 2
KW = dict(num_nodes=NODES, input_dim=2, output_dim=1, horizon=SEQ,
          seq_len=SEQ, rnn_units=8, max_diffusion_step=2, embedding_dim=16,
          knn_k=3, use_curriculum_learning=False)
CLI = ["--dataset", "SYNTH", "--num_nodes", str(NODES), "--synth_steps",
       str(STEPS), "--seq_len", str(SEQ), "--horizon", str(SEQ),
       "--rnn_units", "8", "--max_diffusion_step", "2", "--knn_k", "3",
       "--batch_size", str(BATCH), "--seed", "0", "--device", "cpu"]


def _tree(flat):
    """A JAX GTS pytree (params or BatchNorm state) of the flat naming."""
    tree = {}
    for k, v in flat.items():
        *parents, leaf = k.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    for mod in ("encoder", "decoder"):
        if mod in tree:
            tree[mod] = [tree[mod][str(i)] for i in range(len(tree[mod]))]
    return tree


def _series():
    values, index = synthetic_speed_series(STEPS, NODES, seed=3)
    return values, index, *tcli.train_feas_and_prior(values, 0.7, 3)


def _records(path):
    epochs, final = [], None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "val" in rec:
                epochs.append((rec["train_loss"], rec["val"]))
            if "final_test" in rec:
                final = rec["final_test"]
    return epochs, final


def _fit_both(base, dtype=np.float32):
    """JAX fit_gts and the port's from the same initial weights and
    BatchNorm state (the port's seeded init), Gumbel noise and curriculum
    off, each on its own package's data from the same series and shuffle
    seed. Returns (JAX run, port run, config)."""
    values, index, feas, prior = _series()
    over = {"compute_dtype": "float64"} if dtype == np.float64 else {}
    cfg = tconfig.GTSConfig(**KW, **over, train_series_len=feas.shape[0])
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = tgts.GTS(cfg, generator=torch.Generator().manual_seed(5),
                     device="cpu", dtype=tdtype)
    init = flat_from_gts_state_dict(model.state_dict(), cfg)
    tcfg = dict(batch_size=BATCH, epochs=EPOCHS, patience=EPOCHS + 1,
                seed=0, lr=0.005)
    runs = []
    for pkg_data, pkg_logs, fit, conf, state in (
            (jdatasets, jlogs, jloop.fit_gts, jconfig,
             tuple(_tree(f) for f in init)),
            (tdatasets, tlogs, tloop.fit_gts, tconfig, init)):
        data = pkg_data.build_from_series(
            values, index, SEQ, SEQ, BATCH,
            shuffle_rng=np.random.default_rng(11))
        run = pkg_logs.RunDir(str(base / pkg_data.__name__.split(".")[0]),
                              "SYNTH", model_name="GTS",
                              snapshot_sources=False, timestring="0")
        kwargs = {"device": "cpu"} if fit is tloop.fit_gts else {}
        fit(conf.GTSConfig(**cfg.__dict__), conf.TrainConfig(**tcfg), data,
            feas, prior, run, max_epochs=EPOCHS, initial_state=state,
            gumbel_noise=False, **kwargs)
        runs.append(run)
    return runs[0], runs[1], cfg


def _assert_same_run(jrun, trun, rtol):
    (w_epochs, w_final), (g_epochs, g_final) = (_records(jrun.metrics_path),
                                                _records(trun.metrics_path))
    assert len(g_epochs) == len(w_epochs) == EPOCHS
    for (w_loss, w_val), (g_loss, g_val) in zip(w_epochs, g_epochs):
        np.testing.assert_allclose(g_loss, w_loss, rtol=rtol)
        assert set(g_val) == set(w_val)
        for k, w in w_val.items():
            np.testing.assert_allclose(g_val[k], w, rtol=rtol,
                                       err_msg=f"val {k}")
    assert set(g_final) == set(w_final)
    for k, w in w_final.items():
        np.testing.assert_allclose(g_final[k], w, rtol=rtol,
                                   err_msg=f"final test {k}")
    assert g_epochs[-1][1]["mae"] < g_epochs[0][1]["mae"]  # both learned


@pytest.fixture(scope="module")
def fits_f32(tmp_path_factory):
    return _fit_both(tmp_path_factory.mktemp("gts32"))


def test_fit_gts_matches_jax_f32(fits_f32):
    """Per-epoch train loss and val metrics and the final test metrics,
    f32 rtol 5e-3 (summation orders differ, compounded over the steps)."""
    _assert_same_run(*fits_f32[:2], rtol=5e-3)


def _dcrnn_mask_divided(y_true):
    """The JAX ``_dcrnn_mask`` with torch's rounding of the f32 mean and the
    division (see test_torch_megacrnx_harness._null_mask_divided: jnp.mean
    multiplies by 1/n, and XLA turns the division by the broadcast mean into
    a multiply by its reciprocal)."""
    mask = (y_true != 0).astype(jnp.float32)
    n = jax.lax.optimization_barrier(jnp.asarray(mask.size, jnp.float32))
    mean = jax.lax.optimization_barrier(
        jnp.broadcast_to(jnp.sum(mask) / n, mask.shape))
    return mask / mean


class _F64Numpy:
    """jax.numpy with ``float32`` read as ``float64`` (the JAX GTS module's
    f32 casts widened; see test_torch_gts._F64Numpy)."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


_JAX_PREPARE = jloop._prepare


def _prepare_f64(x, y, cfg):
    """The JAX harness's batches in double (it casts them to f32; the
    port's forward and loss cast them to the compute dtype)."""
    return tuple(a.astype(np.float64) for a in _JAX_PREPARE(x, y, cfg))


def test_fit_gts_matches_jax_f64(tmp_path, monkeypatch):
    """Both packages in double, within 1e-9: on the JAX side the GTS
    module's f32 casts widened, its batches in double and its masked
    losses' mask normalised with torch's rounding. x64 is scoped to this
    test."""
    monkeypatch.setattr(jgts, "jnp", _F64Numpy())
    monkeypatch.setattr(jlosses, "_dcrnn_mask", _dcrnn_mask_divided)
    monkeypatch.setattr(jloop, "_prepare", _prepare_f64)
    with jax.enable_x64(True):
        jrun, trun, _ = _fit_both(tmp_path, np.float64)
    assert not jax.config.jax_enable_x64
    _assert_same_run(jrun, trun, rtol=1e-9)


def test_eval_step_keeps_the_sigmoid_quirk(fits_f32):
    """The eval's graph loss is BCE(sigmoid(adj_prob), prior)
    (traintest_GTS.py:119): every metric of the port's eval step equals the
    JAX eval step's on the best weights, and the loss is the MAE plus that
    BCE, not the train step's BCE(adj_prob, prior)."""
    jrun, _, cfg = fits_f32
    values, index, feas, prior = _series()
    params = dict(np.load(jrun.checkpoint_path))
    flat = {k[len("params/"):]: v for k, v in params.items()
            if k.startswith("params/")}
    bn = {k[len("params/"):]: v for k, v in
          dict(np.load(jrun.checkpoint_path + ".bn")).items()
          if k.startswith("params/")}
    model = tgts.GTS(cfg, device="cpu")
    model.load_state_dict(gts_params_from_flat(flat, bn, cfg))
    rs = np.random.RandomState(4)
    x = rs.randn(5, SEQ, NODES, 2).astype(np.float32)
    y = rs.randn(5, SEQ, NODES, 1).astype(np.float32)
    tf, tp = torch.from_numpy(feas), torch.from_numpy(prior)
    got = tloop.make_gts_eval_step(model, 40.0, 12.0, tf, tp)(
        torch.from_numpy(x), torch.from_numpy(y))
    want = jloop.make_gts_eval_step(jconfig.GTSConfig(**cfg.__dict__), 40.0,
                                    12.0, feas, prior, gumbel_noise=False)(
        _tree(flat), _tree(bn), x, y, jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5,
                                   err_msg=k)
    with torch.no_grad():
        adj_prob = model.sample_graph(tf)[1].reshape(-1)
    quirk = tloop.bce(torch.sigmoid(adj_prob), tp.reshape(-1))
    plain = tloop.bce(adj_prob, tp.reshape(-1))
    np.testing.assert_allclose(got["loss"].item(),
                               (got["mae"] + quirk).item(), rtol=1e-6)
    assert abs(quirk.item() - plain.item()) > 1e-3


def test_predictor_matches_jax_on_a_jax_checkpoint(fits_f32):
    """GTSPredictor.from_checkpoint on the (params, .bn) pair the JAX
    fit_gts wrote, against the JAX predictor (both sample the graph once,
    argmax, BatchNorm in eval mode): 11 raw windows in chunks of 8; then
    StreamingForecaster over the port's predictor, whose y_cov is ignored."""
    jrun, _, cfg = fits_f32
    _, _, feas, _ = _series()
    want_p = jserve.GTSPredictor.from_checkpoint(
        jrun.checkpoint_path, jconfig.GTSConfig(**cfg.__dict__), feas,
        max_batch=8)
    got_p = tserve.GTSPredictor.from_checkpoint(
        jrun.checkpoint_path, cfg, feas, max_batch=8, device="cpu")
    np.testing.assert_array_equal(got_p.adj.numpy(), np.asarray(want_p.adj))
    rs = np.random.RandomState(3)
    x = np.concatenate([rs.uniform(0, 70, (11, SEQ, NODES, 1)),
                        rs.uniform(0, 1, (11, SEQ, NODES, 1))], -1).astype(
        np.float32)
    got, want = got_p.predict(x), want_p.predict(x)
    assert got.shape == (11, SEQ, NODES, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())

    stream = tserve.StreamingForecaster(got_p, cov_fn=lambda t: np.ones(
        (SEQ, NODES, 1)))
    outs = [stream.push(x[0, t]) for t in range(SEQ)]
    assert all(o is None for o in outs[:-1])
    np.testing.assert_allclose(outs[-1], got[0], rtol=1e-6, atol=1e-6)
    nxt = stream.push(x[1, 0])
    np.testing.assert_allclose(
        nxt, got_p.predict(np.concatenate([x[0, 1:], x[1, :1]])[None])[0],
        rtol=1e-6)


def test_reference_names_map_onto_the_port_by_the_fixed_renaming():
    """The port's GTS state_dict carries the reference's names: the JAX
    package's own reader of a reference state_dict
    (gts_params_from_torch_state_dict) takes it as it is and gives the
    arrays of interop.flat_from_gts_state_dict; and that flat naming loads
    back into the port."""
    cfg = tconfig.GTSConfig(**dict(KW, num_layers=2), train_series_len=40)
    model = tgts.GTS(cfg, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    sd = model.state_dict()
    jparams, jbn = jinterop.gts_params_from_torch_state_dict(
        sd, jconfig.GTSConfig(**cfg.__dict__))
    flat, bn = flat_from_gts_state_dict(sd, cfg)
    for got, want in ((flat, jparams), (bn, jbn)):
        want = {k: np.asarray(v) for k, v in _flat(want).items()}
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    again = tgts.GTS(cfg, device="cpu")
    again.load_state_dict(gts_params_from_flat(flat, bn, cfg))
    for k, v in again.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k]), k
    assert "encoder_model.dcgru_layers.1.gconv_weight_(48, 16)" in sd


def _flat(tree, prefix=""):
    out = {}
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = v
    return out


def test_cli_writes_every_artifact_and_refuses_the_mesh(tmp_path):
    res = tcli.main(CLI + ["--epochs", "1", "--save_dir", str(tmp_path)])
    assert np.isfinite(res["test_metrics"]["mae"])
    (run,) = os.listdir(tmp_path)
    assert run.startswith("SYNTH_GTS_")
    files = os.listdir(tmp_path / run)
    for suffix in (".npz", ".npz.bn", "_logging.txt", "_epochlog.txt",
                   "metrics.jsonl", "src_snapshot"):
        assert any(f.endswith(suffix) for f in files), suffix
    # The mesh is ported (tests/test_torch_mesh_harness.py); one it cannot
    # build is refused before any rank starts.
    with pytest.raises(SystemExit, match="--mesh_data and --mesh_node"):
        tcli.main(CLI + ["--mesh_data", "0"])
    with pytest.raises(SystemExit, match="--data_dir and --raw_h5"):
        tcli.main(["--dataset", "METRLA", "--device", "cpu"])
