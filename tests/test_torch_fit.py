"""The port's fit loop (megacrn_tpu_torch.train.loop.fit) held against the
JAX package's fit: the same data (built by each package from the same
seeds, which the data tests hold equal), the same initial weights (the
port's seeded init handed to JAX through the flat naming), curriculum off so
both decoders are deterministic. Per epoch the train loss and the val
metrics, and the final test metrics, at the CI config of
tests/test_parity_e2e.py (nodes 8, 300 steps, seq 6, units 8, mem 4,
batch 32, 2 epochs)."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from megacrn_tpu import config as jconfig
from megacrn_tpu import interop as jinterop
from megacrn_tpu.cli import traintest as jcli
from megacrn_tpu.data import datasets as jdatasets
from megacrn_tpu.kernels.spmm_coo import \
    build_stacked_road_pack as jbuild_pack
from megacrn_tpu.train import logs as jlogs
from megacrn_tpu.train import loop as jloop
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch.cli import traintest as tcli
from megacrn_tpu_torch.data import datasets as tdatasets
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.interop import flat_from_state_dict
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.train import logs as tlogs
from megacrn_tpu_torch.train import loop as tloop

torch.set_num_threads(1)
NODES, STEPS, SEQ, UNITS, MEM, BATCH, EPOCHS = 8, 300, 6, 8, 4, 32, 2


def _model_kw(**over):
    kw = dict(num_nodes=NODES, rnn_units=UNITS, mem_num=MEM, mem_dim=UNITS,
              horizon=SEQ, seq_len=SEQ, use_curriculum_learning=False)
    kw.update(over)
    return kw


def _train_kw(protocol, **over):
    """The protocol's preset at the CI size: 2 epochs, no early stop, the
    LR decay at epoch 1 so both schedules cross a milestone."""
    kw = dict(batch_size=BATCH, epochs=EPOCHS, patience=EPOCHS + 1, seed=0,
              lr_milestones=(1,))
    kw.update(over)
    return protocol, kw


def _data(pkg, protocol):
    if protocol == "EXPYTKY":
        return pkg.build_expytky_synthetic(
            num_nodes=NODES, steps_per_month=STEPS, his_len=SEQ, seq_len=SEQ,
            batch_size=BATCH, seed=3, val_ratio=0.25, shuffle_seed=0)
    return pkg.build_synthetic(num_nodes=NODES, num_steps=STEPS, seq_len=SEQ,
                               horizon=SEQ, batch_size=BATCH, seed=3,
                               shuffle_rng=np.random.default_rng(11))


def _trajectory(metrics_path):
    """[(train_loss, val metrics)] per epoch and the final test metrics
    from a run's metrics.jsonl (either package writes the same records)."""
    epochs, final = [], None
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if "val" in rec:
                epochs.append((rec["train_loss"], rec["val"]))
            if "final_test" in rec:
                final = rec["final_test"]
    return epochs, final


def _fit_both(tmp_path, protocol, model_kw, train_kw, dtype=np.float32,
              road=False, constants=None):
    """Run JAX fit and the port's fit from the same weights and data;
    returns ((jax epochs, jax final), (port epochs, port final)).
    ``constants``: the (JAX, port) graph constants, else a block-COO pack
    with ``road``."""
    kind, tkw = train_kw
    tcfg_m = tconfig.MegaCRNConfig(**model_kw)
    jcfg_m = jconfig.MegaCRNConfig(**model_kw)
    t_train = tconfig.train_config_for(kind, **tkw)
    j_train = jconfig.train_config_for(kind, **tkw)
    torch_dtype = torch.float64 if dtype == np.float64 else torch.float32
    model = MegaCRN(tcfg_m, generator=torch.Generator().manual_seed(7),
                    device="cpu", dtype=torch_dtype)
    init = flat_from_state_dict(model.state_dict(), 1)
    assert all(v.dtype == dtype for v in init.values())
    jsup, tsup = constants or (None, None)
    if road:
        sups = list(dual_random_walk_supports(
            synthetic_road_adjacency(NODES, avg_degree=4, seed=1)))
        jsup, tsup = jbuild_pack(sups, impl="xla"), build_stacked_road_pack(
            sups)

    def final_fns(pkg_cli, data, sup):
        if kind == "EXPYTKY":
            return pkg_cli._make_expytky_final_eval(
                jcfg_m if pkg_cli is jcli else tcfg_m, data, sup)
        return None

    jdata = _data(jdatasets, kind)
    jrun = jlogs.RunDir(str(tmp_path / "jax"), "T", snapshot_sources=False,
                        timestring="0")
    jinit = jinterop.params_from_flat(init, 1, dtype=jax.numpy.dtype(dtype))
    jloop.fit(jcfg_m, j_train, jdata, jrun, test_every_epoch=False,
              initial_params=jinit, road_supports=jsup,
              final_eval_fn=final_fns(jcli, jdata, jsup))

    tdata = _data(tdatasets, kind)
    trun = tlogs.RunDir(str(tmp_path / "port"), "T", snapshot_sources=False,
                        timestring="0")
    res = tloop.fit(tcfg_m, t_train, tdata, trun, test_every_epoch=False,
                    initial_params=init, road_supports=tsup, device="cpu",
                    final_eval_fn=final_fns(tcli, tdata, tsup))
    assert res["epochs_run"] == EPOCHS
    return _trajectory(jrun.metrics_path), _trajectory(trun.metrics_path)


def _assert_trajectories(want, got, rtol, final_keys):
    (w_epochs, w_final), (g_epochs, g_final) = want, got
    assert len(w_epochs) == len(g_epochs) == EPOCHS
    for (w_loss, w_val), (g_loss, g_val) in zip(w_epochs, g_epochs):
        np.testing.assert_allclose(g_loss, w_loss, rtol=rtol)
        assert set(g_val) == set(w_val)
        for k in w_val:
            np.testing.assert_allclose(g_val[k], w_val[k], rtol=rtol,
                                       err_msg=f"val {k}")
    for k in final_keys:
        np.testing.assert_allclose(g_final[k], w_final[k], rtol=rtol,
                                   err_msg=f"final test {k}")
    # both learned (not parity of divergence)
    assert g_epochs[-1][1]["loss"] < g_epochs[0][1]["loss"]


@pytest.mark.parametrize("protocol", ["METRLA", "EXPYTKY"])
def test_fit_matches_jax_fit_f32_dense(tmp_path, protocol):
    """f32, rtol 5e-3: the summation orders of XLA and torch differ, and
    the difference compounds over the optimizer steps."""
    want, got = _fit_both(tmp_path, protocol, _model_kw(),
                          _train_kw(protocol))
    keys = (["mae", "mape", "rmse", "mae_1", "rmse_6"]
            if protocol == "EXPYTKY" else ["mae", "mape", "rmse", "loss"])
    _assert_trajectories(want, got, 5e-3, keys)
    assert set(got[1]) == set(want[1])


def test_fit_matches_jax_fit_f64_dense(tmp_path):
    """Both packages in double, dense: only the last bits differ
    (<= 1e-9). x64 is scoped to this test."""
    with jax.enable_x64(True):
        want, got = _fit_both(tmp_path, "METRLA",
                              _model_kw(compute_dtype="float64"),
                              _train_kw("METRLA"), dtype=np.float64)
    assert not jax.config.jax_enable_x64
    _assert_trajectories(want, got, 1e-9, ["mae", "mape", "rmse", "loss"])


def test_fit_matches_jax_fit_f32_road_sparse_stacked_pack(tmp_path):
    """road_sparse through a StackedRoadPack (the JAX side runs its XLA
    tile chain, the port the kernel's plain version on the CPU), f32 rtol
    5e-3."""
    want, got = _fit_both(tmp_path, "METRLA",
                          _model_kw(graph_backend="road_sparse"),
                          _train_kw("METRLA"), road=True)
    _assert_trajectories(want, got, 5e-3, ["mae", "mape", "rmse", "loss"])


# The new graph backends and knobs, each as a flag of both CLIs.
CLI_FLAGS = {
    "road_impl_ell": ["--graph_backend", "road_sparse", "--road_impl", "ell"],
    "sparse_meta_node": ["--graph_backend", "sparse_meta",
                         "--sparse_meta_impl", "node"],
    "sparse_meta_block": ["--graph_backend", "sparse_meta",
                          "--sparse_meta_impl", "block"],
    "dense_impl_stacked": ["--dense_impl", "stacked"],
    "remat": ["--graph_backend", "road_sparse", "--road_impl", "pallas",
              "--remat"],
}


@pytest.mark.parametrize("name", sorted(CLI_FLAGS))
def test_fit_on_each_new_cli_flag_matches_jax_fit(tmp_path, name):
    """Each new flag parsed by both CLIs on SYNTH at the CI config: the
    model config and the graph constant come from each package's own
    ``configs_from_args`` and ``build_road_supports``; then per-epoch train
    loss, val metrics and the final test metrics of both fits, f32 rtol
    5e-3 (as above)."""
    argv = ["--dataset", "SYNTH", "--num_nodes", str(NODES), "--rnn_units",
            str(UNITS), "--mem_num", str(MEM), "--mem_dim", str(UNITS),
            "--seq_len", str(SEQ), "--horizon", str(SEQ),
            "--use_curriculum_learning", "False"] + CLI_FLAGS[name]
    jargs = jcli.build_parser().parse_args(argv)
    targs = tcli.build_parser().parse_args(argv)
    jcfg, _ = jcli.configs_from_args(jargs)
    tcfg, _ = tcli.configs_from_args(targs)
    model_kw = dataclasses.asdict(tcfg)
    assert jconfig.MegaCRNConfig(**model_kw) == jcfg
    jsup, _ = jcli.build_road_supports(jargs, jcfg)
    tsup = tcli.build_road_supports(targs, tcfg)
    assert type(tsup).__name__ == type(jsup).__name__
    want, got = _fit_both(tmp_path, "METRLA", model_kw, _train_kw("METRLA"),
                          constants=(jsup, tsup))
    _assert_trajectories(want, got, 5e-3, ["mae", "mape", "rmse", "loss"])


def _resume_setup(tmp_path, name):
    cfg = tconfig.MegaCRNConfig(**_model_kw(use_curriculum_learning=True,
                                            cl_decay_steps=20))
    train = tconfig.train_config_for("METRLA", batch_size=BATCH, epochs=4,
                                     patience=10, seed=0,
                                     lr_milestones=(2,))
    data = tdatasets.build_synthetic(
        num_nodes=NODES, num_steps=STEPS, seq_len=SEQ, horizon=SEQ,
        batch_size=BATCH, seed=3, reshuffle_each_epoch=True, shuffle_seed=0)
    run = tlogs.RunDir(str(tmp_path / name), "T", snapshot_sources=False,
                       timestring="0")
    return cfg, train, data, run


def test_resume_gives_the_uninterrupted_run(tmp_path):
    """Curriculum on (the coins come from the checkpointed generator),
    reshuffle on ((seed, epoch) batches), an LR milestone after the kill:
    2 epochs, a fresh process state, resume to 4 == 4 uninterrupted
    epochs, bit for bit."""
    cfg, train, data, run = _resume_setup(tmp_path, "cut")
    first = tloop.fit(cfg, train, data, run, max_epochs=2, device="cpu")
    assert first["epochs_run"] == 2
    cfg, train, data, run = _resume_setup(tmp_path, "cut")
    resumed = tloop.fit(cfg, train, data, run, resume=True, device="cpu")
    cfg, train, data, run = _resume_setup(tmp_path, "whole")
    whole = tloop.fit(cfg, train, data, run, device="cpu")
    assert resumed["epochs_run"] == whole["epochs_run"] == 4
    assert resumed["best_val"] == whole["best_val"]
    assert set(resumed["params"]) == set(whole["params"])
    for k, v in whole["params"].items():
        np.testing.assert_array_equal(resumed["params"][k], v, err_msg=k)
    assert resumed["test_metrics"] == whole["test_metrics"]


def test_fit_reinit_seed_and_early_stop(tmp_path):
    """The EXPY-TKY preset re-inits from the seed (same seed, same start),
    patience 1 stops after the first epoch that does not improve, and the
    best checkpoint is what the final test reloads."""
    cfg = tconfig.MegaCRNConfig(**_model_kw(rnn_units=4, mem_dim=4))
    train = tconfig.train_config_for("EXPYTKY", batch_size=BATCH, epochs=6,
                                     patience=1, seed=5, lr=0.05)
    assert train.reinit_xavier_uniform
    results = []
    for name in ("a", "b"):
        data = _data(tdatasets, "EXPYTKY")
        run = tlogs.RunDir(str(tmp_path / name), "T", snapshot_sources=False,
                           timestring="0")
        results.append((tloop.fit(cfg, train, data, run, device="cpu",
                                  test_every_epoch=True), run))
    (a, run), (b, _) = results
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k])
    epochs, _ = _trajectory(run.metrics_path)
    vals = [v["loss"] for _, v in epochs]
    assert len(vals) == a["epochs_run"]
    if a["epochs_run"] < 6:  # stopped early: its last epoch did not improve
        assert vals[-1] >= min(vals[:-1])
    assert a["best_val"] == min(vals)
    with open(run.metrics_path) as f:
        records = [json.loads(line) for line in f]
    assert sum("test" in r for r in records) == a["epochs_run"]
    assert all(r["sec_per_step"] > 0 for r in records if "val" in r)


def test_fit_without_card_raises_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: fit would train on it")
    cfg, train, data, run = _resume_setup(tmp_path, "nocard")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.fit(cfg, dataclasses.replace(train, epochs=1), data, run)


@pytest.mark.parametrize("backend,const,want", [
    ("dense_ring", None, "ring"), ("road_sparse", None, "shardmap"),
    ("road_sparse", "coo", "shardmap"), ("road_sparse", "sharded",
                                         "road_node"),
    ("dense", None, "sharded"), ("dense", "coo", "sharded"),
    ("sparse_meta", "pattern", "sharded")])
def test_mesh_run_takes_the_step_of_its_backend(monkeypatch, backend, const,
                                                want):
    """fit's mesh run picks its step as the JAX fit does: the ring step for
    dense_ring; for road_sparse the node-partitioned step on sharded packs
    and the data-parallel one otherwise (with no constant too, whose
    forward then raises); the GSPMD counterpart for dense and sparse_meta,
    whatever constant they are given."""
    from megacrn_tpu_torch.kernels.sparse_graph_node import \
        build_node_pattern
    from megacrn_tpu_torch.kernels.spmm import shard_road_packs
    from megacrn_tpu_torch.parallel import api

    for name in ("ring", "shardmap", "road_node", "sharded"):
        monkeypatch.setattr(api, f"make_{name}_train_step",
                            lambda *a, _name=name, **k: _name)
        monkeypatch.setattr(api, f"make_{name}_eval_forward",
                            lambda *a, **k: None, raising=False)
    adj = synthetic_road_adjacency(NODES, avg_degree=3, seed=0)
    sups = list(dual_random_walk_supports(adj))
    sup = {None: None, "coo": build_stacked_road_pack(sups),
           "sharded": shard_road_packs(sups, 2),
           "pattern": build_node_pattern((adj != 0).astype(np.float32)
                                         + np.eye(NODES, dtype=np.float32))
           }[const]
    cfg = tconfig.MegaCRNConfig(**_model_kw(graph_backend=backend))
    train_step, _ = tloop._mesh_steps(None, cfg, None, None, None, None,
                                      0.0, 1.0, sup)
    assert train_step == want
