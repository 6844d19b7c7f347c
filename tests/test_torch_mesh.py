"""The port's mesh steps (megacrn_tpu_torch.parallel) held against the JAX
package's mesh steps on the 8 virtual CPU devices of tests/conftest.py and
against the single-device step.

The port side runs once, on 4 gloo ranks spawned for the whole module
(``tests/torch_mesh_ranks.py:run_cases``, which imports no JAX), while the
parent computes the JAX side. Every case takes its weights from the JAX
package's init (through the flat naming), its batch from a numpy seed, and
the JAX step's teacher-forcing mask (and Gumbel draws) pinned on the port.
Tolerances: one step at f32 rtol 1e-4 (atol 1e-5, or 1e-5 * max|g| for
gradients) and f64 1e-9, as the single-device port tests state them.
"""
import os
import pickle
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megacrn_tpu import config as jconfig
from megacrn_tpu.data.graph_prior import cosine_knn_graph
from megacrn_tpu.kernels import spmm as jspmm
from megacrn_tpu.kernels import spmm_ell_node as jell
from megacrn_tpu.kernels.spmm_coo import build_stacked_road_pack as jcoo
from megacrn_tpu.models import gts as jgts
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.models import megacrnx as jmegacrnx
from megacrn_tpu.parallel import api as japi
from megacrn_tpu.parallel.mesh import make_mesh as jmake_mesh
from megacrn_tpu.parallel.mesh import shard_batch as jshard_batch
from megacrn_tpu.parallel.mesh import shard_params as jshard_params
from megacrn_tpu.parallel.ring import make_ring_aggregate as jring_aggregate
from megacrn_tpu.train.megacrnx_loop import \
    MegaCRNxTrainConfig as JXTrainConfig
from megacrn_tpu.train.optim import clip_by_global_norm_torch
from megacrn_tpu.train.optim import make_optimizer as jmake_optimizer
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels import spmm as tspmm
from megacrn_tpu_torch.kernels.spmm_ell_node import (BucketedShardedNodeELL,
                                                     ShardedNodeELL,
                                                     local_node_ell,
                                                     shard_node_ell)
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.parallel import launch

import torch_mesh_ranks

N, B, T = 12, 8, 3
KW = dict(num_nodes=N, rnn_units=8, mem_num=4, mem_dim=8, horizon=T,
          seq_len=T)
MESH = (2, 2)
MEAN, STD = 40.0, 12.0
SEEN = 16000.0  # threshold ~0.40: the masks mix both kinds of step
RNG = jax.random.PRNGKey(7)


def flat_of(tree):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _batch(seed, dtype=np.float32, c_in=1):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, N, c_in).astype(dtype)
    y = (rs.rand(B, T, N, 1) * 60).astype(dtype)
    yc = rs.randn(B, T, N, 1).astype(dtype)
    return x, y, yc


def _supports(seed, avg_degree=4):
    adj = synthetic_road_adjacency(N, avg_degree=avg_degree, seed=seed)
    return [np.asarray(s, np.float32) for s in dual_random_walk_supports(adj)]


def _use_truth(cfg):
    """The teacher-forcing mask of a JAX mesh step at SEEN with RNG (the
    step folds the counter in, the forward splits one coin per step)."""
    rng = jax.random.fold_in(RNG, jnp.int32(int(SEEN)))
    keys = jax.random.split(rng, cfg.horizon)
    coins = jax.vmap(lambda k: jax.random.uniform(k))(keys)
    threshold = jmegacrn.compute_sampling_threshold(
        cfg.cl_decay_steps, jnp.asarray(SEEN, jnp.float32))
    return np.asarray(coins < threshold)


# --- the cases -------------------------------------------------------------
# name -> (case for the ranks, the JAX mesh step's (loss, params) or None)

def _megacrn_case(name, step, seed, *, backend="dense", protocol="METRLA",
                  train=None, road=None, dtype="float32", masked_rows=0,
                  max_buckets=4, supports_seed=1, avg_degree=4):
    kw = dict(KW, graph_backend=backend, compute_dtype=dtype)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    x, y, yc = _batch(seed, np_dtype)
    y[:masked_rows] = 0.0
    case = dict(name=name, kind="megacrn_step", mesh=MESH, step=step,
                cfg=kw, protocol=protocol, train=train or {}, dtype=dtype,
                x=x, y=y, yc=yc, seen=SEEN, mean=MEAN, std=STD, road=road,
                max_buckets=max_buckets)
    if road is not None:
        case["supports"] = _supports(supports_seed, avg_degree)
    return case


def _jax_megacrn(case):
    """The JAX package's mesh step of the case: (loss, flat params)."""
    x64 = case["dtype"] == "float64"
    with jax.enable_x64(x64):
        jd = jnp.float64 if x64 else jnp.float32
        cfg = jconfig.MegaCRNConfig(**case["cfg"])
        tcfg = jconfig.train_config_for(case["protocol"], **case["train"])
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jd), _unflat(case["flat"]))
        opt = jmake_optimizer(tcfg, steps_per_epoch=10)
        mesh = jmake_mesh(*case["mesh"])
        sups = case.get("supports")
        road, kind = None, case["road"]
        if kind == "coo":
            road = jcoo(sups, impl="xla")
        elif kind == "block_ell":
            road = jspmm.shard_road_packs(sups, mesh.shape["node"])
        elif kind == "node_ell":
            road = jell.shard_node_ell(sups, mesh.shape["node"],
                                       max_buckets=case["max_buckets"])
        args = (cfg, tcfg, opt, mesh, MEAN, STD)
        if case["step"] == "shardmap":
            step = japi.make_shardmap_train_step(*args, donate=False,
                                                 road_supports=road)
        elif case["step"] == "sharded":
            # GSPMD: weights placed by param_sharding (We1/We2 rows over
            # node), the all-gathers inserted from the constraints.
            params = jshard_params(params, mesh)
            step = japi.make_sharded_train_step(*args, donate=False)
        elif case["step"] == "ring":
            step = japi.make_ring_train_step(*args, donate=False)
        else:
            step = japi.make_road_node_train_step(
                cfg, tcfg, opt, mesh, road, MEAN, STD, donate=False)
        batch = [jnp.asarray(case[k]) for k in ("x", "y", "yc")]
        if case["step"] != "shardmap":
            batch = jshard_batch(batch, mesh)
        p, _, loss = step(params, opt.init(params), *batch,
                          jnp.asarray(SEEN, jnp.float32), RNG)
        return float(loss), flat_of(p)


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return _listify(tree)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_listify(node[str(i)]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def _cases():
    cases, jax_fns = [], {}

    def add(case, jax_fn=None, init_seed=0):
        x64 = case.get("dtype") == "float64"
        if case["kind"] in ("megacrn_step", "road_node_eval"):
            with jax.enable_x64(x64):
                jd = jnp.float64 if x64 else jnp.float32
                cfg = jconfig.MegaCRNConfig(**case["cfg"])
                case["flat"] = flat_of(jmegacrn.init_params(
                    jax.random.PRNGKey(init_seed), cfg, dtype=jd))
                # x64 draws its coins in double: the mask of that mode.
                case["use_truth"] = _use_truth(cfg)
            assert 0 < case["use_truth"].sum() < T
        cases.append(case)
        if jax_fn is not None:
            jax_fns[case["name"]] = jax_fn

    # Data parallel: zero targets fill data shard 0 (rows 0-3).
    add(_megacrn_case("dp_masked_uneven", "shardmap", 1, masked_rows=4),
        _jax_megacrn, 1)
    add(_megacrn_case("dp_masked_uneven_f64", "shardmap", 1, masked_rows=4,
                      dtype="float64"), _jax_megacrn, 1)
    add(_megacrn_case("dp_l1_normalized", "shardmap", 2, protocol="EXPYTKY",
                      train={"epsilon": 1e-3}), _jax_megacrn, 2)
    add(_megacrn_case("dp_coo", "shardmap", 3, backend="road_sparse",
                      road="coo"), _jax_megacrn, 3)
    add(_megacrn_case("dense_node", "sharded", 4, masked_rows=2),
        _jax_megacrn, 4)
    add(_megacrn_case("dense_node_f64", "sharded", 4, masked_rows=2,
                      dtype="float64"), _jax_megacrn, 4)
    add(_megacrn_case("ring", "ring", 5, backend="dense_ring",
                      masked_rows=2), _jax_megacrn, 5)
    add(_megacrn_case("ring_f64", "ring", 5, backend="dense_ring",
                      masked_rows=2, dtype="float64"), _jax_megacrn, 5)
    add(_megacrn_case("road_node_block_ell", "road_node", 6,
                      backend="road_sparse", road="block_ell"),
        _jax_megacrn, 6)
    add(_megacrn_case("road_node_ell_flat_f64", "road_node", 7,
                      backend="road_sparse", road="node_ell", max_buckets=1,
                      dtype="float64"), _jax_megacrn, 7)
    add(_megacrn_case("road_node_ell_bucketed", "road_node", 8,
                      backend="road_sparse", road="node_ell",
                      supports_seed=3, avg_degree=3), _jax_megacrn, 8)
    add(_megacrn_case("dense_node_bf16", "sharded", 9,
                      dtype="bfloat16"), None, 9)
    # The node-partitioned eval forward.
    ev = _megacrn_case("road_node_eval", None, 10, backend="road_sparse",
                       road="block_ell")
    ev.update(kind="road_node_eval")
    add(ev, _jax_road_eval, 10)
    # The ring aggregate against the dense product, on two meshes.
    rs = np.random.RandomState(11)
    for mesh in ((2, 2), (1, 4)):
        add(dict(name=f"ring_aggregate_{mesh[0]}x{mesh[1]}",
                 kind="ring_aggregate", mesh=mesh,
                 support=rs.randn(16, 16).astype(np.float32),
                 x=rs.randn(4, 16, 3).astype(np.float32)), _jax_ring)
    for noise in (False, True):
        add(_gts_case(noise), _jax_gts)
    for meta_type in (True, False):
        add(_megacrnx_case(meta_type), _jax_megacrnx)
    return cases, jax_fns


def _jax_road_eval(case):
    cfg = jconfig.MegaCRNConfig(**case["cfg"])
    mesh = jmake_mesh(*case["mesh"])
    fwd = japi.make_road_node_eval_forward(
        cfg, mesh, jspmm.shard_road_packs(case["supports"], case["mesh"][1]))
    x, yc = jshard_batch((jnp.asarray(case["x"]), jnp.asarray(case["yc"])),
                         mesh)
    return np.asarray(fwd(_unflat(case["flat"]), x, yc).output)


def _jax_ring(case):
    agg = jring_aggregate(jmake_mesh(*case["mesh"]))
    return np.asarray(agg(jnp.asarray(case["support"]),
                          jnp.asarray(case["x"])))


GTS_KW = dict(num_nodes=N, input_dim=2, output_dim=1, horizon=T, seq_len=T,
              rnn_units=8, max_diffusion_step=2, embedding_dim=7,
              train_series_len=40, knn_k=2)


def _gts_case(noise):
    cfg = jconfig.GTSConfig(**GTS_KW)
    params, bn = jgts.init_params(jax.random.PRNGKey(12), cfg)
    rs = np.random.RandomState(12)
    x = rs.randn(B, T, N, 2).astype(np.float32)
    y = rs.randn(B, T, N, 1).astype(np.float32)
    y[:3] = 0.0  # zero targets in data shard 0
    feas = rs.randn(40, N).astype(np.float32)
    k_gumbel, k_cl = jax.random.split(jax.random.PRNGKey(13))
    uniforms = np.asarray(jax.random.uniform(k_gumbel, (N * N, 2)))
    coins = np.asarray(jax.random.uniform(k_cl, (T,)))
    c = float(cfg.cl_decay_steps)
    use_truth = coins < c / (c + np.exp(np.float32(SEEN) / c))
    return dict(name=f"gts_noise_{'on' if noise else 'off'}",
                kind="gts_step", mesh=MESH, cfg=GTS_KW, flat=flat_of(params),
                bn=flat_of(bn), x=x, y=y, feas=feas,
                prior=cosine_knn_graph(feas, 2).astype(np.float32),
                uniforms=uniforms if noise else None, coins=coins,
                use_truth=use_truth, noise=noise, seen=SEEN, mean=1.5,
                std=2.0)


def _jax_gts(case, monkeypatch):
    cfg = jconfig.GTSConfig(**case["cfg"])
    draws = {(N * N, 2): case["uniforms"], (T,): case["coins"]}
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k:
                        jnp.asarray(draws[tuple(shape)], jnp.float32))
    opt = optax.chain(clip_by_global_norm_torch(5.0),
                      optax.adam(0.005, eps=1e-3))
    step = japi.make_gts_mesh_train_step(
        cfg, jconfig.TrainConfig(), opt, jmake_mesh(*case["mesh"]), 1.5, 2.0,
        case["feas"], case["prior"], donate=False,
        gumbel_noise=case["noise"])
    params, bn = _unflat(case["flat"]), _unflat(case["bn"])
    p, new_bn, _, loss = step(params, bn, opt.init(params), case["x"],
                              case["y"], jnp.float32(SEEN),
                              jax.random.PRNGKey(0))
    monkeypatch.undo()
    return float(loss), flat_of(p), flat_of(new_bn)


def _megacrnx_case(meta_type):
    kw = dict(num_nodes=N, input_dim=1, output_dim=1, horizon=T, seq_len=T,
              rnn_units=8, mem_num=4, mem_dim=8, meta_type=meta_type)
    params = jmegacrnx.init_params(jax.random.PRNGKey(14),
                                   jmegacrnx.MegaCRNxConfig(**kw))
    x, y, yc = _batch(14)
    y[:3] = 0.0  # below null_val: masked rows in data shard 0
    return dict(name="megacrnx" if meta_type else "megacrnx_no_meta",
                kind="megacrnx_step", mesh=MESH, cfg=kw,
                flat=flat_of(params), x=x, y=y, yc=yc, lr=1e-3,
                loss="MaskMAE", mean=1.5, std=2.0)


def _jax_megacrnx(case):
    """The JAX mesh step without ``meta_type``; with it the JAX
    single-device step (the JAX mesh step contracts the decoder's meta
    support over each shard's rows alone, the port over the whole batch)."""
    from megacrn_tpu.train.megacrnx_loop import make_megacrnx_train_step

    opt = optax.sgd(case["lr"])
    cfg = jmegacrnx.MegaCRNxConfig(**case["cfg"])
    tcfg = JXTrainConfig(lr=case["lr"])
    if cfg.meta_type:
        step = make_megacrnx_train_step(cfg, tcfg, opt, 1.5, 2.0,
                                        donate=False)
    else:
        step = japi.make_megacrnx_mesh_train_step(
            cfg, tcfg, opt, jmake_mesh(*case["mesh"]), 1.5, 2.0,
            donate=False)
    params = _unflat(case["flat"])
    p, _, vals = step(params, opt.init(params), case["x"], case["y"],
                      case["yc"])
    return np.asarray([float(v) for v in vals]), flat_of(p)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(cases by name, every rank's results, the JAX side by name)."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases, jax_fns = _cases()
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    errors = []

    def ranks():
        try:
            launch.spawn(torch_mesh_ranks.run_cases, 4,
                         args=(str(tmp / "cases.pkl"), str(tmp)),
                         coordinator=f"file://{tmp / 'rendezvous'}",
                         device="cpu")
        except BaseException as e:  # reported by the fixture below
            errors.append(e)

    thread = threading.Thread(target=ranks)
    thread.start()
    want = {}
    mp = pytest.MonkeyPatch()
    try:
        for case in cases:
            fn = jax_fns.get(case["name"])
            if fn is _jax_gts:
                want[case["name"]] = fn(case, mp)
            elif fn is not None:
                want[case["name"]] = fn(case)
    finally:
        mp.undo()
        thread.join()
    assert not errors, f"a rank failed: {errors!r}"
    got = []
    for r in range(4):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return {c["name"]: c for c in cases}, got, want


def _close(got, want, rtol, what, grads=False):
    assert set(got) == set(want), what
    for k, w in want.items():
        atol = (rtol / 10 if rtol < 1e-6 else 1e-5) * (
            np.abs(w).max() if grads else 1.0)
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _replicas_equal(got, name, key="params"):
    """Every rank ends the step with the same weights, bit for bit."""
    for r in range(1, 4):
        for k, v in got[0][name][key].items():
            np.testing.assert_array_equal(got[r][name][key][k], v,
                                          err_msg=f"rank {r} {k}")


MEGACRN_CASES = ["dp_masked_uneven", "dp_masked_uneven_f64",
                 "dp_l1_normalized", "dp_coo", "dense_node",
                 "dense_node_f64", "ring", "ring_f64", "road_node_block_ell",
                 "road_node_ell_flat_f64", "road_node_ell_bucketed"]


@pytest.mark.parametrize("name", MEGACRN_CASES)
def test_mesh_step_matches_single_device_and_jax(runs, name):
    """Loss, summed gradients and updated weights of the port's mesh step
    against the port's single-device step on the whole batch, and loss and
    weights against the JAX package's mesh step of the same kind
    (``shard_map`` data parallel, GSPMD on the node axis, the ring, the
    road-node ``shard_map``)."""
    cases, got, want = runs
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
    loss, params = want[name]
    np.testing.assert_allclose(r0["loss"], loss, rtol=rtol)
    _close(r0["params"], params, rtol, "params vs JAX mesh step")
    calls = r0["calls"]
    assert r0["staged"] == {}  # CPU tensors cross gloo as they are
    assert calls["all_reduce"] >= 1
    if cases[name]["step"] == "ring":
        assert calls["shift"] > 0
    elif cases[name]["step"] in ("road_node", "sharded"):
        assert calls["all_gather"] > 0


def test_masked_loss_case_has_a_fully_masked_shard(runs):
    """The uneven case really is uneven: data shard 0 holds no target, so a
    mean of per-shard masked means would differ from the global one."""
    cases, _, _ = runs
    y = cases["dp_masked_uneven"]["y"]
    assert (y[:4] == 0).all() and (y[4:] != 0).mean() > 0.9


def test_bucketed_case_takes_the_bucketed_pack(runs):
    cases, _, _ = runs
    flat = cases["road_node_ell_flat_f64"]
    bucketed = cases["road_node_ell_bucketed"]
    assert isinstance(shard_node_ell(flat["supports"], 2, max_buckets=1),
                      ShardedNodeELL)
    assert isinstance(shard_node_ell(bucketed["supports"], 2),
                      BucketedShardedNodeELL)


def test_bf16_on_a_node_mesh_trains_close_to_single_device(runs):
    """bf16 compute on the node-partitioned dense step: finite, the replicas
    equal, the loss near the single-device bf16 step's."""
    _, got, _ = runs
    r0 = got[0]["dense_node_bf16"]
    assert np.isfinite(r0["loss"])
    _replicas_equal(got, "dense_node_bf16")
    np.testing.assert_allclose(r0["loss"], r0["single_loss"], rtol=2e-2)


def test_road_node_eval_forward_matches_single_device_and_jax(runs):
    _, got, want = runs
    r0 = got[0]["road_node_eval"]
    for r in range(4):
        np.testing.assert_array_equal(got[r]["road_node_eval"]["output"],
                                      r0["output"])
    np.testing.assert_allclose(r0["output"], r0["single"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(r0["output"], want["road_node_eval"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
def test_ring_aggregate_matches_dense_and_its_gradients(runs, mesh):
    """Each rank's block of the ring product equals the dense product's (and
    the JAX ring's); the x gradients summed over ranks equal A^T (2y)."""
    cases, got, want = runs
    name = f"ring_aggregate_{mesh}"
    case = cases[name]
    d, n = case["mesh"]
    a, x = case["support"], case["x"]
    full = np.einsum("nm,bmc->bnc", a, x)
    gx = np.zeros_like(x)
    for r in range(4):
        res = got[r][name]
        di, ni = res["index"]
        bb, k = x.shape[0] // d, x.shape[1] // n
        blk = (slice(di * bb, (di + 1) * bb), slice(ni * k, (ni + 1) * k))
        np.testing.assert_allclose(res["y"], full[blk], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["y"], want[name][blk], rtol=1e-5,
                                   atol=1e-5)
        gx += res["gx"]
        assert res["calls"].get("shift", 0) == 2 * (n - 1)
    want_gx = np.einsum("nm,bnc->bmc", a, 2 * full)
    np.testing.assert_allclose(gx, want_gx, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("noise", ["off", "on"])
def test_gts_mesh_step_matches_single_device_and_jax(runs, noise):
    """GTS data parallel: the same loss, weights and BatchNorm state as the
    single-device step and the JAX mesh step, with the Gumbel noise off
    and on (every rank samples the same graph from the same draws)."""
    _, got, want = runs
    name = f"gts_noise_{noise}"
    r0 = got[0][name]
    _replicas_equal(got, name)
    _replicas_equal(got, name, "bn")
    np.testing.assert_allclose(r0["loss"], r0["single_loss"], rtol=1e-5)
    _close(r0["params"], r0["single_params"], 1e-4, "params vs single")
    _close(r0["bn"], r0["single_bn"], 1e-5, "bn vs single")
    loss, params, bn = want[name]
    np.testing.assert_allclose(r0["loss"], loss, rtol=1e-4)
    _close(r0["params"], params, 1e-4, "params vs JAX")
    _close(r0["bn"], bn, 1e-4, "bn vs JAX")


@pytest.mark.parametrize("name", ["megacrnx", "megacrnx_no_meta"])
def test_megacrnx_mesh_step_matches_jax(runs, name):
    """MegaCRNx data parallel (the MaskMAE mask count summed over the data
    axis; with ``meta_type`` the decoder's meta support contracted over the
    whole batch): the four loss terms and the SGD update against the
    single-device step, and against JAX (its mesh step without
    ``meta_type``, its single-device step with it)."""
    _, got, want = runs
    r0 = got[0][name]
    _replicas_equal(got, name)
    np.testing.assert_allclose(r0["vals"], r0["single_vals"], rtol=1e-5)
    _close(r0["params"], r0["single_params"], 1e-4, "params vs single")
    vals, params = want[name]
    np.testing.assert_allclose(r0["vals"], vals, rtol=1e-4)
    _close(r0["params"], params, 1e-4, "params vs JAX")
    assert r0["calls"]["all_reduce"] >= (2 if name == "megacrnx" else 1)


def test_ranks_import_no_jax(runs):
    _, got, _ = runs
    assert not any(g["jax_imported"] for g in got)


@pytest.mark.parametrize("n,shards", [(12, 2), (207, 3)])
def test_shard_road_packs_equal_jax(n, shards):
    """Every rank's rectangular row-block pack and its transpose: the tiles,
    column blocks and real-tile counts of the JAX package's
    ``shard_road_packs`` (n_loc 69 is no multiple of 128), with a nonzero
    list that holds the same matrix."""
    adj = synthetic_road_adjacency(n, avg_degree=8, seed=0)
    sups = [np.asarray(s, np.float32) for s in dual_random_walk_supports(adj)]
    want = jspmm.shard_road_packs(sups, shards)
    got = tspmm.shard_road_packs(sups, shards)
    assert (got.n_loc, got.n_full) == (want.n_loc, want.n_full)
    for s in range(2):
        for d in range(shards):
            a, a_t = tspmm.local_packs(got, d)[s]
            for side, pack in (("fwd", a), ("bwd", a_t)):
                for field, name in (("data", "data"), ("cols", "cols"),
                                    ("nnz", "nnz_blocks")):
                    np.testing.assert_array_equal(
                        getattr(pack, name).numpy(),
                        np.asarray(getattr(want, f"{side}_{field}")[s, d]))
            rows = slice(d * got.n_loc, (d + 1) * got.n_loc)
            for pack, dense in ((a, sups[s][rows]), (a_t, sups[s][rows].T)):
                m = np.zeros((pack.n, pack.col_dim_orig), np.float32)
                ptr = pack.nz_row_ptr.numpy()
                for r in range(pack.n):
                    lo, hi = ptr[r], ptr[r + 1]
                    m[r, pack.nz_cols.numpy()[lo:hi]] = (
                        pack.nz_vals.numpy()[lo:hi])
                np.testing.assert_array_equal(m[:pack.n_orig], dense)


@pytest.mark.parametrize("max_buckets", [1, 4])
def test_shard_node_ell_equals_jax(max_buckets):
    """The node-partitioned ELL packs, flat and envelope-bucketed, equal the
    JAX package's arrays; ``local_node_ell`` takes a rank's slice."""
    adj = synthetic_road_adjacency(207, avg_degree=8, seed=0)
    sups = [np.asarray(s, np.float32) for s in dual_random_walk_supports(adj)]
    want = jell.shard_node_ell(sups, 3, max_buckets=max_buckets)
    got = shard_node_ell(sups, 3, max_buckets=max_buckets)
    assert type(got).__name__ == type(want).__name__
    assert (got.n_loc, got.n_full) == (want.n_loc, want.n_full)
    if max_buckets == 1:
        np.testing.assert_array_equal(got.nbr.numpy(), np.asarray(want.nbr))
        np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
        local = local_node_ell(got, 2)
        np.testing.assert_array_equal(local.nbr.numpy(),
                                      np.asarray(want.nbr)[2])
        return
    for s in range(2):
        np.testing.assert_array_equal(got.inv[s].numpy(),
                                      np.asarray(want.inv[s]))
        assert len(got.nbr[s]) == len(want.nbr[s]) > 1
        for b in range(len(want.nbr[s])):
            np.testing.assert_array_equal(got.nbr[s][b].numpy(),
                                          np.asarray(want.nbr[s][b]))
            np.testing.assert_array_equal(got.w[s][b].numpy(),
                                          np.asarray(want.w[s][b]))
    local = local_node_ell(got, 1)
    np.testing.assert_array_equal(local.inv[0].numpy(),
                                  np.asarray(want.inv[0])[1])


def test_rcm_ordering_equals_jax():
    adj = synthetic_road_adjacency(64, avg_degree=4, seed=2)
    np.testing.assert_array_equal(tspmm.rcm_ordering(adj),
                                  jspmm.rcm_ordering(adj))
