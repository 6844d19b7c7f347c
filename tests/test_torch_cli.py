"""The port's traintest CLI (megacrn_tpu_torch.cli.traintest) end to end on
the CPU (``--device cpu``): every capability reachable by flag (the
directory checkpoints of ``--ckpt_backend orbax`` and ``sparse_meta`` on a
node axis among them) and the run-dir artifact contract; the other mesh
runs are in tests/test_torch_mesh_harness.py."""
import json
import os

import numpy as np
import pytest
import torch

from megacrn_tpu_torch.cli.traintest import main
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels import spmm_coo
from megacrn_tpu_torch.kernels.sparse_graph import BlockPattern
from megacrn_tpu_torch.kernels.sparse_graph_node import (
    BucketedNodeELLPattern, NodeELLPattern)
from megacrn_tpu_torch.kernels.spmm_ell_node import (BucketedStackedNodeELL,
                                                     StackedNodeELL)
from megacrn_tpu_torch.train import loop

torch.set_num_threads(1)
BASE = ["--dataset", "SYNTH", "--num_nodes", "16", "--rnn_units", "8",
        "--mem_num", "4", "--mem_dim", "8", "--seq_len", "4",
        "--horizon", "4", "--epochs", "1", "--batch_size", "16",
        "--synth_steps", "200", "--seed", "0",
        "--test_every_epoch", "False"]


def _run(tmp_path, extra, base=BASE):
    result = main(base + ["--save_dir", str(tmp_path), "--device", "cpu"]
                  + extra)
    assert np.isfinite(result["test_metrics"]["mae"])
    return result


def _run_dir(tmp_path):
    (name,) = os.listdir(tmp_path)
    return os.path.join(str(tmp_path), name)


def test_cli_dense(tmp_path):
    result = _run(tmp_path, [])
    assert result["model"].cfg.graph_backend == "dense"
    assert result["epochs_run"] == 1


@pytest.mark.parametrize("impl,kind", [("pallas", "kernel"),
                                       ("auto", "kernel"),
                                       ("xla", "reference")])
def test_cli_road_sparse_backend(tmp_path, monkeypatch, impl, kind):
    """--road_impl pallas (and auto) train through spmm_coo, the kernel's
    wrapper (its plain version on a CPU tensor); xla through the plain
    version directly."""
    calls = []
    wrapper = spmm_coo.spmm_coo

    def counted(a, x):
        calls.append(x.shape[1])
        return wrapper(a, x)

    monkeypatch.setattr(spmm_coo, "spmm_coo", counted)
    _run(tmp_path, ["--graph_backend", "road_sparse", "--road_impl", impl])
    assert (len(calls) > 0) == (kind == "kernel")


def test_cli_adj_path(tmp_path):
    adj = synthetic_road_adjacency(16, avg_degree=4, seed=5)
    adj_path = os.path.join(str(tmp_path), "adj01.npy")
    np.save(adj_path, adj)
    _run(tmp_path / "run", ["--graph_backend", "road_sparse",
                            "--adj_path", adj_path])
    np.save(adj_path, synthetic_road_adjacency(12, seed=5))
    with pytest.raises(SystemExit, match="12 nodes, model expects 16"):
        _run(tmp_path / "run", ["--graph_backend", "road_sparse",
                                "--adj_path", adj_path])


def test_cli_sparse_backend_requires_adjacency(tmp_path):
    with pytest.raises(SystemExit, match="requires --adj_path"):
        main(["--dataset", "METRLA", "--graph_backend", "road_sparse",
              "--data_dir", "does_not_exist", "--save_dir", str(tmp_path),
              "--device", "cpu"])
    assert os.listdir(tmp_path) == []  # before any data or run dir


def test_cli_expytky_synthetic(tmp_path):
    """EXPYTKY with no --data_dir: the synthetic months, the EXPY-TKY
    protocol and its final eval (every horizon step in the scores file)."""
    result = _run(tmp_path, [], base=[
        "--dataset", "EXPYTKY", "--num_nodes", "16", "--rnn_units", "8",
        "--mem_num", "4", "--mem_dim", "8", "--epochs", "1",
        "--batch_size", "64", "--seed", "0", "--test_every_epoch", "False"])
    m = result["test_metrics"]
    assert {f"mae_{s}" for s in range(1, 7)} <= set(m) and "mse" in m
    assert all(np.isfinite(v) for v in m.values())
    with open([os.path.join(_run_dir(tmp_path), f)
               for f in os.listdir(_run_dir(tmp_path))
               if f.endswith("_scores.txt")][0]) as f:
        assert len(f.read().splitlines()) == 6


def test_cli_eval_aggregation_concat(tmp_path):
    result = _run(tmp_path, ["--eval_aggregation", "concat"])
    assert "loss" not in result["test_metrics"]  # the concat flavour's keys
    assert {"mae", "mape", "rmse", "mae_3"} <= set(result["test_metrics"])


@pytest.mark.parametrize("flags", [
    ["--graph_backend", "dense_ring", "--ckpt_backend", "orbax"],
    ["--mesh_data", "2", "--ckpt_backend", "orbax"],
    ["--graph_backend", "sparse_meta", "--mesh_node", "2"],
    ["--ckpt_backend", "orbax"],
], ids=["dense_ring_orbax", "mesh_data_orbax", "sparse_meta_mesh_node",
        "orbax"])
def test_cli_once_refused_flags_run(tmp_path, flags):
    """The flag sets the port refused until it had directory checkpoints
    and ``sparse_meta`` on a node axis now train and test (a mesh flag
    spawns its two CPU ranks); ``--ckpt_backend orbax`` leaves a
    torch.distributed.checkpoint directory that ``load_checkpoint``
    reads."""
    from megacrn_tpu_torch.train import checkpoint as tckpt

    result = main(BASE + ["--save_dir", str(tmp_path), "--device", "cpu"]
                  + flags)
    spawned = "--mesh_data" in flags or "--mesh_node" in flags
    assert (result is None) == spawned
    run = _run_dir(tmp_path)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        (final,) = [r["final_test"] for r in map(json.loads, f)
                    if "final_test" in r]
    assert all(np.isfinite(v) for v in final.values())
    (ckpt_path,) = [os.path.join(run, f) for f in os.listdir(run)
                    if f.endswith(".npz")]
    assert os.path.isdir(ckpt_path) == ("orbax" in flags)
    flat, opt, meta = tckpt.load_checkpoint(ckpt_path)
    assert meta["epoch"] == 0 and opt and "memory/We1" in flat


@pytest.mark.parametrize("flags,backend,constant,knobs", [
    (["--graph_backend", "road_sparse", "--road_impl", "ell"], "road_sparse",
     (StackedNodeELL, BucketedStackedNodeELL), {}),
    (["--graph_backend", "sparse_meta"], "sparse_meta",
     (NodeELLPattern, BucketedNodeELLPattern), {}),
    (["--graph_backend", "sparse_meta", "--sparse_meta_impl", "block"],
     "sparse_meta", BlockPattern, {}),
    (["--dense_impl", "stacked"], "dense", type(None),
     {"dense_impl": "stacked"}),
    (["--remat"], "dense", type(None), {"remat": True}),
    (["--graph_backend", "sparse_meta", "--remat"], "sparse_meta",
     (NodeELLPattern, BucketedNodeELLPattern), {"remat": True}),
])
def test_cli_new_backends_and_knobs_train(tmp_path, monkeypatch, flags,
                                          backend, constant, knobs):
    """The flags this slice ports train end to end: the model config carries
    them and fit gets the graph constant the flag names."""
    seen = []
    fit = loop.fit

    def spy(model_cfg, *a, road_supports=None, **kw):
        seen.append((model_cfg, road_supports))
        return fit(model_cfg, *a, road_supports=road_supports, **kw)

    monkeypatch.setattr(loop, "fit", spy)
    result = _run(tmp_path, flags)
    ((cfg, sup),) = seen
    assert cfg.graph_backend == backend
    assert isinstance(sup, constant)
    for k, v in knobs.items():
        assert getattr(cfg, k) == v
    assert result["epochs_run"] == 1


def test_cli_auto_road_impl_takes_the_block_coo_kernel():
    """--road_impl auto is the block-COO kernel (the faster path on the
    H100), and ell the node-ELL pack, from the same adjacency."""
    from megacrn_tpu_torch.cli import traintest

    built = {}
    for impl in ("auto", "ell"):
        args = traintest.build_parser().parse_args(
            ["--dataset", "SYNTH", "--num_nodes", "16", "--graph_backend",
             "road_sparse", "--road_impl", impl])
        cfg, _ = traintest.configs_from_args(args)
        built[impl] = traintest.build_road_supports(args, cfg)
    assert isinstance(built["auto"], spmm_coo.StackedRoadPack)
    assert built["auto"].impl == "kernel"
    assert isinstance(built["ell"], (StackedNodeELL, BucketedStackedNodeELL))


def test_cli_run_dir_artifact_contract_and_resume(tmp_path):
    """The run dir holds the checkpoint, the log, the epoch log, the scores,
    metrics.jsonl and the source snapshot; --resume continues the newest run
    dir to more epochs."""
    first = _run(tmp_path, [])
    run = _run_dir(tmp_path)
    files = os.listdir(run)
    for suffix in (".npz", "_logging.txt", "_epochlog.txt", "_scores.txt"):
        assert any(f.endswith(suffix) for f in files), suffix
    assert "metrics.jsonl" in files
    assert os.path.isdir(os.path.join(run, "src_snapshot",
                                      "megacrn_tpu_torch"))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert any("final_test" in r for r in records)
    (epoch,) = [r for r in records if "val" in r]
    assert epoch["steady_steps"] > 0 and epoch["sec_per_step"] > 0

    resumed = _run(tmp_path, ["--resume", "--epochs", "2"])
    assert _run_dir(tmp_path) == run  # the same run dir, continued
    assert resumed["epochs_run"] == 2
    assert resumed["best_val"] <= first["best_val"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert [json.loads(line).get("epoch") for line in f
                if '"val"' in line] == [1, 2]


def test_cli_without_device_cpu_refuses_to_train_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(BASE + ["--save_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
