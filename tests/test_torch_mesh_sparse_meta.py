"""``sparse_meta`` on a node-partitioned mesh: the port's sharded step
(each rank's rows of the learned edge pattern, flat, bucketed or 128x128
tiles, multiplied into the all-gathered x) held against the JAX package's
GSPMD step on the 8 virtual CPU devices of tests/conftest.py and against
the port's single-device step.

The port side runs once, on 4 gloo ranks spawned for the whole module
(``tests/torch_mesh_ranks.py:run_cases``, which imports no JAX), while the
parent computes the JAX side, as in tests/test_torch_mesh.py. Every case
takes its weights from the JAX package's init, its batch from a numpy seed
and the JAX step's teacher-forcing mask. Tolerances: one step at f32 rtol
1e-4 (atol 1e-5, or 1e-5 * max|g| for gradients) and f64 rtol 1e-9.
"""
import json
import os
import pickle
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from megacrn_tpu import config as jconfig
from megacrn_tpu.kernels import sparse_graph as jsg
from megacrn_tpu.kernels import sparse_graph_node as jsgn
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.parallel import api as japi
from megacrn_tpu.parallel.mesh import make_mesh as jmake_mesh
from megacrn_tpu.parallel.mesh import shard_batch as jshard_batch
from megacrn_tpu.parallel.mesh import shard_params as jshard_params
from megacrn_tpu.train.optim import make_optimizer as jmake_optimizer
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels.sparse_graph import (BLOCK,
                                                    build_block_pattern,
                                                    local_block_pattern)
from megacrn_tpu_torch.kernels.sparse_graph_node import (
    BucketedNodeELLPattern, build_node_pattern, build_node_pattern_bucketed,
    local_node_pattern)
from megacrn_tpu_torch.parallel import launch

import torch_mesh_ranks
from test_torch_mesh import (MEAN, MESH, RNG, SEEN, STD, _close,
                             _replicas_equal, _unflat, _use_truth, flat_of)

T, B = 2, 8
BOUNDARY_N = 260  # 130 rows a node rank: both ranks' rows cross a tile
CLI_ARGS = ["--dataset", "SYNTH", "--num_nodes", "16", "--rnn_units", "8",
            "--mem_num", "4", "--mem_dim", "8", "--seq_len", "2",
            "--horizon", "2", "--epochs", "1", "--batch_size", "8",
            "--synth_steps", "200", "--seed", "0", "--device", "cpu",
            "--graph_backend", "sparse_meta", "--mesh_data", "2",
            "--mesh_node", "2"]


def _pattern_adj(n, seed):
    """The CLI's pattern: the symmetrised road graph with self loops (its
    degrees spread, so the bucketed layout has buckets to make)."""
    adj = synthetic_road_adjacency(n, avg_degree=4, seed=seed)
    pat = ((adj != 0) | (adj.T != 0)).astype(np.float32)
    np.fill_diagonal(pat, 1.0)
    return pat


def _jax_pattern(case):
    adj = case["pattern_adj"]
    if case["road"] == "block_pattern":
        return jsg.build_block_pattern(adj)
    if case["road"] == "node_pattern":
        return jsgn.build_node_pattern(adj, max_buckets=1)
    return jsgn.build_node_pattern_bucketed(adj, case["max_buckets"])


def _case(name, road, seed, n=12, dtype="float32", units=8, mem=(4, 8)):
    kw = dict(num_nodes=n, rnn_units=units, mem_num=mem[0], mem_dim=mem[1],
              horizon=T, seq_len=T, graph_backend="sparse_meta",
              compute_dtype=dtype)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, n, 1).astype(np_dtype)
    y = (rs.rand(B, T, n, 1) * 60).astype(np_dtype)
    y[:2] = 0.0  # masked targets in one data shard
    yc = rs.randn(B, T, n, 1).astype(np_dtype)
    x64 = dtype == "float64"
    with jax.enable_x64(x64):
        cfg = jconfig.MegaCRNConfig(**kw)
        flat = flat_of(jmegacrn.init_params(
            jax.random.PRNGKey(seed), cfg,
            dtype=jnp.float64 if x64 else jnp.float32))
        use_truth = _use_truth(cfg)
    return dict(name=name, kind="megacrn_step", mesh=MESH, step="sharded",
                cfg=kw, protocol="METRLA", train={}, dtype=dtype, x=x, y=y,
                yc=yc, seen=SEEN, mean=MEAN, std=STD, road=road,
                max_buckets=2, pattern_adj=_pattern_adj(n, seed),
                flat=flat, use_truth=use_truth)


def _jax_step(case):
    """The JAX package's GSPMD step on the case: (loss, flat params)."""
    x64 = case["dtype"] == "float64"
    with jax.enable_x64(x64):
        jd = jnp.float64 if x64 else jnp.float32
        cfg = jconfig.MegaCRNConfig(**case["cfg"])
        tcfg = jconfig.train_config_for(case["protocol"])
        mesh = jmake_mesh(*case["mesh"])
        params = jshard_params(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jd), _unflat(case["flat"])), mesh)
        opt = jmake_optimizer(tcfg, steps_per_epoch=10)
        step = japi.make_sharded_train_step(cfg, tcfg, opt, mesh, MEAN, STD,
                                            donate=False,
                                            road_supports=_jax_pattern(case))
        batch = jshard_batch([jnp.asarray(case[k]) for k in ("x", "y", "yc")],
                             mesh)
        p, _, loss = step(params, opt.init(params), *batch,
                          jnp.asarray(SEEN, jnp.float32), RNG)
        return float(loss), flat_of(p)


def _jax_eval(case):
    cfg = jconfig.MegaCRNConfig(**case["cfg"])
    mesh = jmake_mesh(*case["mesh"])
    fwd = japi.make_sharded_eval_forward(cfg, mesh, _jax_pattern(case))
    x, yc = jshard_batch((jnp.asarray(case["x"]), jnp.asarray(case["yc"])),
                         mesh)
    return np.asarray(fwd(jshard_params(_unflat(case["flat"]), mesh), x,
                          yc).output)


STEP_CASES = {
    "node_flat": ("node_pattern", 1, "float32"),
    "node_flat_f64": ("node_pattern", 1, "float64"),
    "node_bucketed": ("bucketed_pattern", 2, "float32"),
    "node_bucketed_f64": ("bucketed_pattern", 2, "float64"),
    "block": ("block_pattern", 3, "float32"),
    "block_f64": ("block_pattern", 3, "float64"),
}
# Held against the port's single-device step only: the JAX GSPMD compiles
# of the node patterns' gathers take 8-15 s each on the CPU; the f32 cases
# hold the same code against JAX, and the f64 block case the double path.
NO_JAX = {"node_flat_f64", "node_bucketed_f64"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases by name, every rank's results, the JAX side by name)."""
    tmp = tmp_path_factory.mktemp("mesh_sparse_meta")
    cases = [_case(name, road, seed, dtype=dtype)
             for name, (road, seed, dtype) in STEP_CASES.items()]
    cases.append(_case("block_tile_boundary", "block_pattern", 4,
                       n=BOUNDARY_N, units=4, mem=(4, 4)))
    ev = _case("eval_bucketed", "bucketed_pattern", 5)
    ev.update(kind="sharded_eval")
    cases.append(ev)
    cases.append(dict(name="cli", kind="cli", mesh=MESH,
                      cli="megacrn_tpu_torch.cli.traintest",
                      argv=CLI_ARGS + ["--save_dir", str(tmp / "cli")]))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    errors = []

    def ranks():
        try:
            launch.spawn(torch_mesh_ranks.run_cases, 4,
                         args=(str(tmp / "cases.pkl"), str(tmp)),
                         coordinator=f"file://{tmp / 'rendezvous'}",
                         device="cpu")
        except BaseException as e:  # reported below
            errors.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    want = {}
    try:
        for case in cases:
            if case["kind"] == "megacrn_step" and case["name"] not in NO_JAX:
                want[case["name"]] = _jax_step(case)
            elif case["kind"] == "sharded_eval":
                want[case["name"]] = _jax_eval(case)
    finally:
        thread.join()
    assert not errors, f"a rank failed: {errors!r}"
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return tmp, {c["name"]: c for c in cases}, got, want


@pytest.mark.parametrize("name", list(STEP_CASES) + ["block_tile_boundary"])
def test_sparse_meta_mesh_step_matches_single_device_and_jax(runs, name):
    """Loss, summed gradients and updated weights of the node-partitioned
    step against the single-device step on the whole batch; loss and
    weights against the JAX GSPMD step (its ``"node_weights"`` and
    ``"tiles"`` row-sharded over the node axis)."""
    _, cases, got, want = runs
    rtol = 1e-9 if cases[name]["dtype"] == "float64" else 1e-4
    r0 = got[0][name]
    for r in range(4):
        assert got[r][name]["loss"] == r0["loss"]
    _replicas_equal(got, name)
    np.testing.assert_allclose(r0["loss"], r0["single_loss"],
                               rtol=min(rtol, 1e-5))
    _close(r0["grads"], r0["single_grads"], rtol, "grads vs single",
           grads=True)
    _close(r0["params"], r0["single_params"], rtol, "params vs single")
    if name not in NO_JAX:
        loss, params = want[name]
        np.testing.assert_allclose(r0["loss"], loss, rtol=rtol)
        _close(r0["params"], params, rtol, "params vs JAX GSPMD step")
    # x is gathered over the node axis (3 gathers an aggregation: x once,
    # then each support's second level) and every gather's backward sums.
    calls = r0["calls"]
    assert r0["staged"] == {}
    assert calls["all_gather"] > 0 and calls["all_reduce"] > calls[
        "all_gather"]


def test_boundary_case_ranks_straddle_a_tile():
    """Each rank of the boundary case holds 130 rows, which cross a 128-row
    tile boundary (rows 0-129 and 130-259): its pattern has two row-blocks
    of its own, not a slice of the global tiles."""
    pattern = build_block_pattern(_pattern_adj(BOUNDARY_N, 4))
    for index in (0, 1):
        local = local_block_pattern(pattern, index, 2)
        assert (local.lo, local.n_loc) == (130 * index, 130)
        assert local.mask.shape[0] == 2 and local.n == pattern.n


@pytest.mark.parametrize("impl", ["node", "bucketed", "block"])
def test_local_patterns_hold_exactly_the_rank_s_rows(impl):
    """Every rank's local pattern holds the edges of its rows of the
    adjacency and no other, and its transposed side (node patterns) lists
    the same edges by column."""
    adj = _pattern_adj(BOUNDARY_N, 6)
    build = {"node": lambda a: build_node_pattern(a, max_buckets=1),
             "bucketed": lambda a: build_node_pattern_bucketed(a, 3),
             "block": build_block_pattern}[impl]
    pattern = build(adj)
    for index in range(2):
        rows = slice(130 * index, 130 * (index + 1))
        if impl == "block":
            local = local_block_pattern(pattern, index, 2)
            dense = np.zeros((local.mask.shape[0] * BLOCK, local.n))
            mask = local.mask.numpy()
            for i, cs in enumerate(local.cols.numpy()):
                for r, j in enumerate(cs):
                    dense[i * BLOCK:(i + 1) * BLOCK,
                          j * BLOCK:(j + 1) * BLOCK] += mask[i, r]
            np.testing.assert_array_equal(dense[:130, :BOUNDARY_N],
                                          adj[rows])
            continue
        local = local_node_pattern(pattern, index, 2)
        assert local.lo == 130 * index and local.n_loc == 130
        p = local.pattern
        assert isinstance(p, BucketedNodeELLPattern) == (impl == "bucketed")
        dense = np.zeros((130, BOUNDARY_N))
        dense_t = np.zeros((BOUNDARY_N, 130))
        groups = (zip(p.nbr, p.mask, p.rows) if impl == "bucketed"
                  else [(p.nbr, p.mask, np.arange(130))])
        for nbr, mask, ids in groups:
            i, d = np.nonzero(mask.numpy())
            dense[np.asarray(ids)[i], nbr.numpy()[i, d]] = 1.0
        t_groups = (zip(p.t_nbr, p.t_mask, np.split(
            np.argsort(p.t_inv.numpy()),
            np.cumsum([len(t) for t in p.t_nbr])[:-1]))
            if impl == "bucketed" else
            [(p.t_nbr, p.t_mask, np.arange(BOUNDARY_N))])
        for nbr, mask, ids in t_groups:
            i, d = np.nonzero(mask.numpy())
            dense_t[np.asarray(ids)[i], nbr.numpy()[i, d]] = 1.0
        np.testing.assert_array_equal(dense, adj[rows])
        np.testing.assert_array_equal(dense_t, adj[rows].T)


def test_sparse_meta_eval_forward_matches_single_device_and_jax(runs):
    _, _, got, want = runs
    r0 = got[0]["eval_bucketed"]
    for r in range(4):
        np.testing.assert_array_equal(got[r]["eval_bucketed"]["output"],
                                      r0["output"])
    np.testing.assert_allclose(r0["output"], r0["single"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r0["output"], want["eval_bucketed"],
                               rtol=1e-4, atol=1e-5)


def test_cli_sparse_meta_on_a_node_mesh_trains_and_tests(runs):
    """One epoch of ``traintest --graph_backend sparse_meta --mesh_data 2
    --mesh_node 2`` inside the group: finite test metrics from rank 0's
    run dir, its x gathered over the node axis."""
    tmp, _, got, _ = runs
    (run,) = os.listdir(tmp / "cli")
    with open(tmp / "cli" / run / "metrics.jsonl") as f:
        (final,) = [r["final_test"] for r in map(json.loads, f)
                    if "final_test" in r]
    assert all(np.isfinite(v) for v in final.values())
    assert got[0]["cli"]["calls"]["all_gather"] > 0


def test_ranks_import_no_jax(runs):
    _, _, got, _ = runs
    assert not any(g["jax_imported"] for g in got)
