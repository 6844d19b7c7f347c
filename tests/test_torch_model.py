"""The port's graph ops, cell, memory and MegaCRN forward
(megacrn_tpu_torch) held against the JAX package and the reference
goldens in tests/goldens/."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.config import MegaCRNConfig as JConfig
from megacrn_tpu.interop import params_from_flat as jparams_from_flat
from megacrn_tpu.kernels.spmm_coo import \
    build_stacked_road_pack as jbuild_pack
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.nn import cell as jcell
from megacrn_tpu.nn import memory as jmemory
from megacrn_tpu.ops import graph as jgraph
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.interop import flat_from_state_dict, params_from_flat
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.nn.cell import GCRNCell
from megacrn_tpu_torch.nn.memory import query_memory
from megacrn_tpu_torch.ops import graph as tgraph

torch.set_num_threads(1)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CONFIG_FIELDS = ("num_nodes", "input_dim", "output_dim", "horizon",
                 "seq_len", "rnn_units", "num_layers", "cheb_k", "ycov_dim",
                 "mem_num", "mem_dim")


def flat_of(tree):
    """A JAX params pytree in the flat ``a/0/b`` naming of its checkpoints."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def load_golden(name):
    blob = dict(np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")))
    kw = {k: int(v) for k, v in zip(CONFIG_FIELDS, blob["meta/config"])}
    return MegaCRNConfig(**kw), blob


def port_model(cfg, flat, dtype=torch.float32):
    model = MegaCRN(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(params_from_flat(flat, cfg, dtype=dtype))
    return model.eval()


def _meta(rs, n=16, m=5, d=8):
    return [rs.randn(*s).astype(np.float32) for s in ((m, d), (n, m), (n, m))]


def test_meta_graph_matches_jax():
    mem, we1, we2 = _meta(np.random.RandomState(0))
    want = jgraph.meta_graph(jnp.asarray(mem), jnp.asarray(we1),
                             jnp.asarray(we2))
    got = tgraph.meta_graph(*map(torch.from_numpy, (mem, we1, we2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("cheb_k", [2, 3, 4])
def test_cheb_aggregate_matches_jax(cheb_k):
    rs = np.random.RandomState(1)
    sup = np.array(jgraph.meta_graph(*map(jnp.asarray, _meta(rs))))
    x = rs.randn(3, 16, 4).astype(np.float32)
    want = jgraph.cheb_aggregate(jnp.asarray(sup), jnp.asarray(x), cheb_k)
    got = tgraph.cheb_aggregate(torch.from_numpy(sup), torch.from_numpy(x),
                                cheb_k)
    assert got.shape == (3, 16, 2 * cheb_k, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_cell_matches_jax():
    rs = np.random.RandomState(2)
    params = jcell.gcrn_cell_init(jax.random.PRNGKey(0), 2, 8, 3, 2)
    cell = GCRNCell(2, 8, 3, 2, torch.Generator().manual_seed(0))
    cell.load_state_dict({f"{sub}.{t}": torch.tensor(
        np.asarray(params[sub][j])) for sub in ("gate", "update")
        for t, j in (("weights", "W"), ("bias", "b"))})
    sup = np.array(jgraph.meta_graph(*map(jnp.asarray, _meta(rs))))
    x = rs.randn(3, 16, 2).astype(np.float32)
    h = rs.randn(3, 16, 8).astype(np.float32)
    want = jcell.gcrn_cell_apply(params, jnp.asarray(x), jnp.asarray(h),
                                 jnp.asarray(sup), 3)
    with torch.no_grad():
        got = cell(torch.from_numpy(x), torch.from_numpy(h),
                   torch.from_numpy(sup), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_query_memory_matches_jax():
    rs = np.random.RandomState(3)
    mem = {k: rs.randn(*s).astype(np.float32) for k, s in
           (("Memory", (5, 8)), ("Wq", (8, 8)), ("We1", (16, 5)),
            ("We2", (16, 5)))}
    h = rs.randn(3, 16, 8).astype(np.float32)
    want = jmemory.query_memory({k: jnp.asarray(v) for k, v in mem.items()},
                                jnp.asarray(h))
    got = query_memory({k: torch.from_numpy(v) for k, v in mem.items()},
                       torch.from_numpy(h))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


def test_query_memory_tie_goes_to_lower_slot_like_jax():
    # Slots 1 and 2 score exactly the same; the second place is slot 1.
    mem = {"Memory": np.array([[2.0, 0.0], [1.0, 0.0], [1.0, 5.0]],
                              np.float32),
           "Wq": np.eye(2, dtype=np.float32)}
    h = np.array([[[1.0, 0.0]]], np.float32)
    _, _, _, want = jmemory.query_memory(
        {k: jnp.asarray(v) for k, v in mem.items()}, jnp.asarray(h))
    _, _, _, neg = query_memory({k: torch.from_numpy(v)
                                 for k, v in mem.items()}, torch.from_numpy(h))
    np.testing.assert_array_equal(neg.numpy(), np.asarray(want))
    np.testing.assert_array_equal(neg.numpy()[0, 0], mem["Memory"][1])


@pytest.mark.parametrize("name", ["megacrn_small", "megacrn_2layer",
                                  "megacrn_metrla"])
def test_dense_forward_matches_reference_golden(name):
    cfg, blob = load_golden(name)
    with torch.no_grad():
        out = port_model(cfg, blob)(torch.from_numpy(blob["in/x"]),
                                    torch.from_numpy(blob["in/y_cov"]))
    for field in ("query", "h_att", "pos", "neg"):
        np.testing.assert_allclose(getattr(out, field).numpy(),
                                   blob[f"out/{field}"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.output.numpy(), blob["out/output"],
                               atol=5e-5, rtol=1e-4)


def _road_setup(n=40, seed=0):
    kw = dict(num_nodes=n, rnn_units=8, mem_num=4, mem_dim=8, horizon=3,
              seq_len=3, graph_backend="road_sparse")
    sups = list(tgraph.dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=4, seed=seed)))
    params = jmegacrn.init_params(jax.random.PRNGKey(seed), JConfig(**kw))
    rs = np.random.RandomState(seed)
    x = rs.randn(3, 3, n, 1).astype(np.float32)
    yc = rs.randn(3, 3, n, 1).astype(np.float32)
    return kw, sups, params, x, yc


def test_road_sparse_forward_matches_jax():
    kw, sups, params, x, yc = _road_setup()
    want = jmegacrn.forward(params, x, yc, JConfig(**kw),
                            road_supports=jbuild_pack(sups, impl="pallas"))
    cfg = MegaCRNConfig(**kw)
    with torch.no_grad():
        got = port_model(cfg, flat_of(params))(
            torch.from_numpy(x), torch.from_numpy(yc),
            road_supports=build_stacked_road_pack(sups))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("backend", ["dense", "road_sparse"])
def test_bfloat16_forward_matches_jax(backend):
    """compute_dtype="bfloat16": matmul inputs narrow, the memory read and
    the output come back in f32. The two packages round bf16 at different
    places, so outputs agree to about two bf16 ulps at their magnitude
    (< 1); pos/neg are left out because a bf16 rounding can swap two
    near-tied memory slots."""
    kw, sups, params, x, yc = _road_setup()
    kw = dict(kw, graph_backend=backend, compute_dtype="bfloat16")
    jsup = tsup = None
    if backend == "road_sparse":
        jsup = jbuild_pack(sups, impl="pallas")
        tsup = build_stacked_road_pack(sups)
    want = jmegacrn.forward(params, x, yc, JConfig(**kw), road_supports=jsup)
    with torch.no_grad():
        got = port_model(MegaCRNConfig(**kw), flat_of(params))(
            torch.from_numpy(x), torch.from_numpy(yc), road_supports=tsup)
    for field in ("output", "h_att", "query"):
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-2, rtol=2e-2)


def test_float64_dense_forward_matches_jax():
    """Both packages in double on the CPU agree to <= 1e-9; x64 is scoped
    to this test with ``jax.enable_x64``."""
    cfg, blob = load_golden("megacrn_small")
    kw = {k: getattr(cfg, k) for k in CONFIG_FIELDS}
    x64 = blob["in/x"].astype(np.float64)
    yc64 = blob["in/y_cov"].astype(np.float64)
    with jax.enable_x64(True):
        want = jmegacrn.forward(
            jparams_from_flat(blob, cfg.num_layers, dtype=jnp.float64),
            jnp.asarray(x64), jnp.asarray(yc64),
            JConfig(compute_dtype="float64", use_curriculum_learning=False,
                    **kw))
        want = [np.asarray(w) for w in want]
    assert not jax.config.jax_enable_x64
    assert want[0].dtype == np.float64
    cfg64 = MegaCRNConfig(compute_dtype="float64", **kw)
    with torch.no_grad():
        got = port_model(cfg64, blob, torch.float64)(
            torch.from_numpy(x64), torch.from_numpy(yc64))
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, atol=1e-9, rtol=1e-9)


def test_state_dict_names_round_trip_through_jax_naming():
    cfg, blob = load_golden("megacrn_2layer")
    model = port_model(cfg, blob)
    flat = flat_from_state_dict(model.state_dict(), cfg.num_layers)
    params_keys = {k for k in blob if "/" in k and not
                   k.startswith(("in/", "out/", "meta/"))}
    assert set(flat) == params_keys
    for k in flat:
        np.testing.assert_array_equal(flat[k], blob[k])
    # The reference's own module names, so its .pt state_dicts load as-is.
    assert "encoder.dcrnn_cells.1.update.weights" in model.state_dict()
    assert model.proj[0].weight.shape == (cfg.output_dim, cfg.decoder_dim)


@pytest.mark.parametrize("impl", ["node", "bucketed", "block"])
def test_sparse_meta_on_a_node_group_computes_the_rank_s_rows(monkeypatch,
                                                              impl):
    """``sparse_meta`` under a two-rank node group (the forward a
    node-partitioned step runs, which refused it before the port had it):
    each rank's forward on its rows of the pattern gives its rows of the
    single-device forward. One process plays both ranks: the graph, the
    node embeddings and the batch repeat across the two node halves, so
    the all-gather of a rank's block is that block twice."""
    from megacrn_tpu_torch.kernels.sparse_graph import (build_block_pattern,
                                                        local_block_pattern)
    from megacrn_tpu_torch.kernels.sparse_graph_node import (
        build_node_pattern, build_node_pattern_bucketed, local_node_pattern)
    from megacrn_tpu_torch.parallel import comm

    monkeypatch.setattr(comm, "all_gather", lambda t, group, dim: torch.cat(
        [t] * group.size, dim))
    n, half = 8, 4
    rs = np.random.RandomState(3)
    a, b = ((rs.rand(half, half) < 0.4).astype(np.float32) for _ in "ab")
    np.fill_diagonal(a, 1.0)
    a[1] = 1.0  # a hub row: degrees that bucket
    adj = np.block([[a, b], [b, a]])
    build = {"node": lambda m: build_node_pattern(m, max_buckets=1),
             "bucketed": lambda m: build_node_pattern_bucketed(m, 3),
             "block": build_block_pattern}[impl]
    pattern = build(adj)
    cfg = MegaCRNConfig(num_nodes=n, rnn_units=4, mem_num=2, mem_dim=4,
                        horizon=2, seq_len=2, graph_backend="sparse_meta",
                        compute_dtype="float64")
    model = MegaCRN(cfg, device="cpu", dtype=torch.float64)
    with torch.no_grad():
        for k in ("We1", "We2"):
            model.memory[k][half:] = model.memory[k][:half]
    x, yc = (torch.cat([t, t], 2) for t in torch.randn(
        2, 2, 2, half, 1, dtype=torch.float64,
        generator=torch.Generator().manual_seed(0)))
    want = model(x, yc, road_supports=pattern).output
    local = (local_block_pattern if impl == "block" else local_node_pattern)
    for index in (0, 1):
        rows = slice(index * half, (index + 1) * half)
        got = model(x[:, :, rows], yc[:, :, rows],
                    road_supports=local(pattern, index, 2),
                    node_group=comm.Group(None, (0, 1), index)).output
        torch.testing.assert_close(got, want[:, :, rows], rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="rank's rows of the pattern"):
        model(x[:, :, :half], yc[:, :, :half], road_supports=pattern,
              node_group=comm.Group(None, (0, 1), 0))


def test_dense_ring_outside_a_mesh_is_the_dense_path():
    """Outside a node-partitioned step ``dense_ring`` runs the dense
    backend's math, as in the JAX package."""
    kw = dict(num_nodes=8, rnn_units=4, mem_num=2, mem_dim=4, horizon=2,
              seq_len=2)
    dense = MegaCRN(MegaCRNConfig(**kw), device="cpu")
    ring = MegaCRN(MegaCRNConfig(**kw, graph_backend="dense_ring"),
                   device="cpu")
    ring.load_state_dict(dense.state_dict())
    x = torch.randn(2, 2, 8, 1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ring(x, x).output, dense(x, x).output,
                               rtol=0, atol=0)
