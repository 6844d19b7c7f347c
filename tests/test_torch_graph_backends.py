"""The port's remaining single-device graph backends held against the JAX
package on the CPU: node-ELL road supports (flat and degree-bucketed), the
learned ``sparse_meta`` graph (node, bucketed node and 128x128-tile
patterns), dense ``stacked`` and ``remat``. The same numpy weights, batch,
graph and teacher-forcing mask go to both packages; one train step's loss
and gradients are compared, and the model's forward, serving and movers are
checked on each graph constant."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu import config as jconfig
from megacrn_tpu.kernels import sparse_graph as jsg
from megacrn_tpu.kernels import sparse_graph_node as jsgn
from megacrn_tpu.kernels import spmm_ell_node as jsen
from megacrn_tpu.kernels.spmm_coo import \
    build_stacked_road_pack as jbuild_pack
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.ops import graph as jgraph
from megacrn_tpu.train import steps as jsteps
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.interop import flat_from_state_dict, params_from_flat
from megacrn_tpu_torch.kernels import spmm_coo as tcoo
from megacrn_tpu_torch.kernels.sparse_graph import build_block_pattern
from megacrn_tpu_torch.kernels.sparse_graph_node import (
    BucketedNodeELLPattern, build_node_pattern)
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.kernels.spmm_ell_node import (BucketedStackedNodeELL,
                                                     StackedNodeELL,
                                                     build_stacked_node_ell)
from megacrn_tpu_torch.models import megacrn as tmegacrn
from megacrn_tpu_torch.ops import graph as tgraph
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.serve import Predictor
from megacrn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)
N = 24
MEAN, STD = 40.0, 12.0
# Threshold ~0.45 at cl_decay_steps 2000: the mask mixes both kinds of step.
BATCHES_SEEN = 15000.0

# kind -> (graph_backend, model overrides)
KINDS = {
    "node_ell_flat": ("road_sparse", {}),
    "node_ell_bucketed": ("road_sparse", {}),
    "sparse_meta_node": ("sparse_meta", {}),
    "sparse_meta_bucketed": ("sparse_meta", {}),
    "sparse_meta_block": ("sparse_meta", {}),
    "dense_stacked": ("dense", {"dense_impl": "stacked"}),
    "remat_coo": ("road_sparse", {"remat": True}),
    "remat_sparse_meta_block": ("sparse_meta", {"remat": True}),
}


def flat_of(tree):
    """A JAX params pytree in the flat ``a/0/b`` naming of its checkpoints."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _adj(n=N, seed=0):
    """A small road graph with an isolated node and a hub row, so the
    degree buckets differ."""
    adj = synthetic_road_adjacency(n, avg_degree=4, seed=seed)
    adj[3] = 0.0
    adj[:, 3] = 0.0
    adj[7, 8:18] = 1.0
    return adj


def _pattern_adj(adj):
    """The CLI's sparse_meta pattern: symmetrised, with self loops."""
    pat = ((adj != 0) | (adj.T != 0)).astype(np.float32)
    np.fill_diagonal(pat, 1.0)
    return pat


def constants(kind, adj):
    """(JAX graph constant, port graph constant) of one kind; both built by
    their own package from the same adjacency. The bucketed layouts take 2
    buckets (the builders' tests cover 4): each bucket is another unrolled
    gather chain for XLA to compile."""
    sups = list(dual_random_walk_supports(adj))
    pat = _pattern_adj(adj)
    if kind == "node_ell_flat":
        return (jsen.build_stacked_node_ell(sups, max_buckets=1),
                build_stacked_node_ell(sups, max_buckets=1))
    if kind == "node_ell_bucketed":
        return (jsen.build_stacked_node_ell(sups, 2, min_saving=0.0),
                build_stacked_node_ell(sups, 2, min_saving=0.0))
    if kind == "sparse_meta_node":
        return (jsgn.build_node_pattern(pat, max_buckets=1),
                build_node_pattern(pat, max_buckets=1))
    if kind == "sparse_meta_bucketed":
        return (jsgn.build_node_pattern(pat, 2, min_saving=0.0),
                build_node_pattern(pat, 2, min_saving=0.0))
    if kind in ("sparse_meta_block", "remat_sparse_meta_block"):
        return jsg.build_block_pattern(pat), build_block_pattern(pat)
    if kind == "remat_coo":
        return jbuild_pack(sups, impl="pallas"), build_stacked_road_pack(sups)
    return None, None


def _setup(kind, seed=0, batch=4, **over):
    backend, kw_over = KINDS[kind]
    kw = dict(num_nodes=N, rnn_units=8, mem_num=4, mem_dim=8, horizon=3,
              seq_len=3, graph_backend=backend)
    kw.update(kw_over)
    kw.update(over)
    params = jmegacrn.init_params(jax.random.PRNGKey(seed),
                                  jconfig.MegaCRNConfig(**kw))
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 3, N, 1).astype(np.float32)
    y = rs.randn(batch, 3, N, 1).astype(np.float32)
    y[rs.rand(*y.shape) < 0.02] = 0.0  # missing readings
    yc = rs.randn(batch, 3, N, 1).astype(np.float32)
    return kw, params, x, y, yc


def _jax_use_truth(cfg, rng, batches_seen):
    """The teacher-forcing mask exactly as megacrn_tpu/models/megacrn.py
    draws it inside its forward."""
    threshold = jmegacrn.compute_sampling_threshold(
        cfg.cl_decay_steps, jnp.asarray(batches_seen, jnp.float32))
    keys = jax.random.split(rng, cfg.horizon)
    coins = jax.vmap(lambda k: jax.random.uniform(k))(keys)
    return np.asarray(coins < threshold)


def _jax_step(params, kw, jsup, x, y, yc, rng, dtype=np.float32):
    jcfg = jconfig.MegaCRNConfig(**kw)
    jtrain = jconfig.train_config_for("METRLA")

    def jloss(p):
        out = jmegacrn.forward(p, jnp.asarray(x), jnp.asarray(yc), jcfg,
                               labels=jnp.asarray(y),
                               batches_seen=BATCHES_SEEN, rng=rng,
                               training=True, road_supports=jsup)
        return jsteps.composite_loss(out, jnp.asarray(y), jtrain, MEAN, STD)

    loss, grads = jax.jit(jax.value_and_grad(jloss))(params)
    return float(loss), flat_of(grads), _jax_use_truth(jcfg, rng,
                                                       BATCHES_SEEN)


def _port_step(params, kw, tsup, x, y, yc, use_truth, monkeypatch,
               dtype=torch.float32):
    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_flat(params, cfg, dtype=dtype))
    monkeypatch.setattr(tmegacrn, "sampling_mask",
                        lambda *a: torch.tensor(use_truth))
    loss = tsteps.make_loss_fn(model, tconfig.train_config_for("METRLA"),
                               MEAN, STD, road_supports=tsup)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yc),
        BATCHES_SEEN, torch.Generator())
    loss.backward()
    grads = flat_from_state_dict(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in model.named_parameters()}, cfg.num_layers)
    return loss.item(), grads


def _assert_grads(got, want, rtol, atol_rel):
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_rel * np.abs(w).max(),
                                   err_msg=k)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_train_step_loss_and_grads_match_jax(kind, monkeypatch):
    """One step's loss and gradients from the same weights, batch, graph
    and teacher-forcing mask, f32: only the summation order differs (rtol
    1e-4, atol 1e-5 * max|g| per array, as tests/test_torch_train.py)."""
    kw, params, x, y, yc = _setup(kind)
    jsup, tsup = constants(kind, _adj())
    want_loss, want_grads, use_truth = _jax_step(
        params, kw, jsup, x, y, yc, jax.random.PRNGKey(7))
    assert 0 < use_truth.sum() < len(use_truth)  # both kinds of step
    loss, grads = _port_step(flat_of(params), kw, tsup, x, y, yc, use_truth,
                             monkeypatch)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    _assert_grads(grads, want_grads, 1e-4, 1e-5)


@pytest.mark.parametrize("kind", sorted(set(KINDS) - {"remat_coo"}))
def test_float64_train_step_matches_jax(kind, monkeypatch):
    """The same step in double, loss and gradients to <= 1e-9. Each JAX path
    here stays in f64: its builders store the support and mask values in
    f32 and the forward casts them to f64, as the port's mover does, so both
    sides multiply the same f64 values. Not remat_coo: the JAX block-COO
    SpMM accumulates in f32 (its gradients differ by ~1e-8 relative), so
    remat is held in f64 on the block pattern. x64 is scoped to this
    test."""
    kw, _, x, y, yc = _setup(kind, compute_dtype="float64")
    x64, y64, yc64 = (a.astype(np.float64) for a in (x, y, yc))
    adj = _adj()
    with jax.enable_x64(True):
        jsup, tsup = constants(kind, adj)
        params = jmegacrn.init_params(jax.random.PRNGKey(3),
                                      jconfig.MegaCRNConfig(**kw),
                                      dtype=jnp.float64)
        want_loss, want_grads, use_truth = _jax_step(
            params, kw, jsup, x64, y64, yc64, jax.random.PRNGKey(7))
        params = flat_of(params)
    assert not jax.config.jax_enable_x64
    assert want_grads["proj/W"].dtype == np.float64
    loss, grads = _port_step(params, kw, tsup, x64, y64, yc64, use_truth,
                             monkeypatch, dtype=torch.float64)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-9)
    _assert_grads(grads, want_grads, 1e-9, 1e-9)


@pytest.mark.parametrize("kind", ["remat_coo", "remat_sparse_meta_block",
                                  "dense_stacked"])
def test_remat_gradients_equal_the_plain_step(kind, monkeypatch):
    """remat=True recomputes each cell step in the backward: on the CPU the
    recomputation repeats the same arithmetic, so loss and gradients equal
    the plain step's bit for bit."""
    kw, params, x, y, yc = _setup(kind)
    _, tsup = constants(kind, _adj())
    use_truth = np.array([True, False, True])
    out = []
    for remat in (False, True):
        out.append(_port_step(flat_of(params), dict(kw, remat=remat), tsup,
                              x, y, yc, use_truth, monkeypatch))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    for k in g0:
        np.testing.assert_array_equal(g1[k], g0[k], err_msg=k)


def test_remat_reruns_each_forward_spmm_in_the_backward(monkeypatch):
    """Under remat the block-COO wrapper runs 2F + B times a step: the F
    forward calls, their recomputation in the backward, and the B backward
    calls (F = 36, B = 34 for seq 3 + horizon 3 at cheb_k 3: the first
    encoder step's [x || h] stack needs no dx)."""
    calls = []
    wrapper = tcoo.spmm_coo

    def counted(a, x):
        calls.append(a.n)
        return wrapper(a, x)

    monkeypatch.setattr(tcoo, "spmm_coo", counted)
    kw, params, x, y, yc = _setup("remat_coo")
    _, tsup = constants("remat_coo", _adj())
    counts = []
    for remat in (False, True):
        calls.clear()
        cfg = tconfig.MegaCRNConfig(**dict(kw, remat=remat))
        model = tmegacrn.MegaCRN(cfg, device="cpu")
        loss = tsteps.make_loss_fn(model, tconfig.train_config_for("METRLA"),
                                   road_supports=tsup)(
            torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yc),
            BATCHES_SEEN, torch.Generator().manual_seed(0))
        fwd = len(calls)
        loss.backward()
        counts.append((fwd, len(calls) - fwd))
    lev = 2  # cheb_k - 1 SpMMs per aggregation, 2 aggregations a cell step
    f = 2 * lev * (3 + 3)
    assert counts == [(f, f - lev), (f, 2 * f - lev)]


@pytest.mark.parametrize("kind", ["sparse_meta_node", "sparse_meta_bucketed",
                                  "sparse_meta_block", "node_ell_bucketed"])
def test_bfloat16_forward_runs_on_every_pattern(kind):
    """A bf16 forward on each graph constant: finite, upcast to f32, and
    within bf16 rounding of the f32 forward (atol 5e-2 * max|y|), which the
    f32 tests hold against the JAX package."""
    kw, params, x, _, yc = _setup(kind)
    _, tsup = constants(kind, _adj())
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg = tconfig.MegaCRNConfig(**dict(kw, compute_dtype=dtype))
        model = tmegacrn.MegaCRN(cfg, device="cpu")
        model.load_state_dict(params_from_flat(flat_of(params), cfg))
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x), torch.from_numpy(yc),
                              road_supports=tsup).output)
    want, got = outs[0].numpy(), outs[1]
    assert got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert not np.array_equal(got.numpy(), want)  # bf16 did run
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=5e-2 * np.abs(want).max())


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_predictor_serves_every_backend(kind):
    """The Predictor moves and casts each graph constant through the one
    mover and serves the model's forward; a request of 5 windows in chunks
    of 2 equals the forward on the whole batch."""
    kw, params, x, _, yc = _setup(kind, batch=5)
    _, tsup = constants(kind, _adj())
    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat_of(params), cfg))
    raw = x * STD + MEAN
    pred = Predictor(model, cfg, MEAN, STD, max_batch=2, road_supports=tsup,
                     device="cpu")
    got = pred.predict(raw, yc)
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(yc),
                     road_supports=tsup).output.numpy() * STD + MEAN
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["node_ell_flat", "node_ell_bucketed",
                                  "sparse_meta_node", "sparse_meta_bucketed",
                                  "sparse_meta_block", "remat_coo"])
def test_one_mover_moves_indices_and_casts_values(kind):
    """``road_supports_to`` moves every graph constant: index arrays stay
    int64, values (weights, masks, tiles) take the dtype, and the
    transposed side moves only with ``transpose``."""
    _, tsup = constants(kind, _adj())
    for transpose in (False, True):
        moved = tmegacrn.road_supports_to(tsup, "cpu", torch.bfloat16,
                                          transpose)
        assert type(moved) is type(tsup)
        for name, a, b in _leaves(tsup, moved):
            side_t = name.startswith(("t_", "bwd_", "pack_t"))
            if a.dtype in (torch.int64, torch.int32):
                assert b.dtype == a.dtype, name
                assert torch.equal(a, b), name
            elif side_t and not transpose:
                assert b is a, name  # left where it was
            else:
                assert b.dtype == torch.bfloat16, name
                assert torch.equal(a.to(torch.bfloat16), b), name


def _leaves(a, b, prefix=""):
    """(field path, leaf of a, leaf of b) over two graph constants."""
    if isinstance(a, torch.Tensor):
        yield prefix, a, b
    elif hasattr(a, "_fields"):
        for f in a._fields:
            yield from _leaves(getattr(a, f), getattr(b, f),
                               f if not prefix else f"{prefix}.{f}")
    elif isinstance(a, tuple):
        for i, (u, v) in enumerate(zip(a, b)):
            yield from _leaves(u, v, f"{prefix}.{i}")


def test_node_ell_index_arrays_are_int64_once_built():
    _, pack = constants("node_ell_bucketed", _adj())
    assert isinstance(pack, BucketedStackedNodeELL)
    for t in pack.fwd_nbr + pack.bwd_nbr + (pack.fwd_inv, pack.bwd_inv):
        assert t.dtype == torch.int64
    _, flat = constants("node_ell_flat", _adj())
    assert isinstance(flat, StackedNodeELL)
    assert flat.pack.nbr.dtype == flat.pack_t.nbr.dtype == torch.int64
    _, pat = constants("sparse_meta_bucketed", _adj())
    assert isinstance(pat, BucketedNodeELLPattern)
    for t in pat.nbr + pat.rows + pat.t_nbr + pat.t_slot + (pat.inv,
                                                            pat.t_inv):
        assert t.dtype == torch.int64


@pytest.mark.parametrize("backend,const", [
    ("sparse_meta", None), ("sparse_meta", "coo"), ("road_sparse", "pattern"),
    ("road_sparse", "node_ell_one_support"), ("road_sparse", "object")])
def test_wrong_graph_constant_raises(backend, const):
    """A sparse_meta or node-ELL model given the wrong graph constant
    raises, as the JAX model does; nothing falls back."""
    adj = _adj()
    sups = list(dual_random_walk_supports(adj))
    cfg = tconfig.MegaCRNConfig(num_nodes=N, rnn_units=4, mem_num=2,
                                mem_dim=4, horizon=2, seq_len=2,
                                graph_backend=backend)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    sup = {None: None, "coo": build_stacked_road_pack(sups),
           "pattern": build_node_pattern(_pattern_adj(adj)),
           "node_ell_one_support": build_stacked_node_ell(sups[:1]),
           "object": [object()]}[const]
    x = torch.zeros(1, 2, N, 1)
    err = ValueError if const == "node_ell_one_support" else TypeError
    with pytest.raises(err, match="num_supports" if err is ValueError
                       else "road_supports|graph constant"):
        model(x, x, road_supports=sup)


def test_sparse_meta_node_equals_block():
    """Node-granular and tile-granular sparse_meta are the same function on
    the same pattern (as the JAX tests hold): equal model outputs."""
    kw, params, x, _, yc = _setup("sparse_meta_node")
    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat_of(params), cfg))
    outs = []
    for kind in ("sparse_meta_node", "sparse_meta_bucketed",
                 "sparse_meta_block"):
        _, tsup = constants(kind, _adj())
        with torch.no_grad():
            outs.append(model(torch.from_numpy(x), torch.from_numpy(yc),
                              road_supports=tsup).output)
    for o in outs[1:]:
        np.testing.assert_allclose(o.numpy(), outs[0].numpy(), rtol=1e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("cheb_k", [2, 3, 4])
def test_cheb_prestacked_matches_jax(cheb_k):
    """``cheb_support_stack`` and ``cheb_aggregate_prestacked`` against the
    JAX functions (f32, rtol 1e-5), and against the recursive
    ``cheb_aggregate`` (the same math)."""
    rs = np.random.RandomState(cheb_k)
    sups = rs.rand(2, 30, 30).astype(np.float32) / 30
    x = rs.randn(3, 30, 5).astype(np.float32)
    want_stack = np.asarray(jgraph.cheb_support_stack(jnp.asarray(sups),
                                                      cheb_k))
    got_stack = tgraph.cheb_support_stack(torch.from_numpy(sups), cheb_k)
    np.testing.assert_allclose(got_stack.numpy(), want_stack, rtol=1e-5,
                               atol=1e-7)
    want = np.asarray(jgraph.cheb_aggregate_prestacked(
        jnp.asarray(want_stack), 2, jnp.asarray(x), cheb_k))
    got = tgraph.cheb_aggregate_prestacked(got_stack, 2, torch.from_numpy(x),
                                           cheb_k)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    rec = tgraph.cheb_aggregate(torch.from_numpy(sups), torch.from_numpy(x),
                                cheb_k)
    np.testing.assert_allclose(got.numpy(), rec.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_dense_impl_must_be_known():
    cfg = tconfig.MegaCRNConfig(num_nodes=8, rnn_units=4, mem_num=2,
                                mem_dim=4, horizon=2, seq_len=2,
                                dense_impl="ring")
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    with pytest.raises(ValueError, match="dense_impl"):
        model(torch.zeros(1, 2, 8, 1), torch.zeros(1, 2, 8, 1))


def test_config_knobs_match_jax_defaults():
    for f in ("dense_impl", "remat"):
        assert (getattr(tconfig.MegaCRNConfig(), f)
                == getattr(jconfig.MegaCRNConfig(), f))
    assert {f.name for f in dataclasses.fields(tconfig.MegaCRNConfig)} <= {
        f.name for f in dataclasses.fields(jconfig.MegaCRNConfig)}
