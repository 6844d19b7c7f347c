"""The port's node-level ELL SpMM (megacrn_tpu_torch/kernels/spmm_ell_node.py)
held against the JAX package on the CPU: the numpy builders give the JAX
arrays exactly (index arrays after the int32 -> int64 conversion), and the
products, their gradients and the Chebyshev aggregation match the JAX
functions (f32 rtol 1e-5: the unrolled slot order is the JAX order)."""
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.kernels import spmm_ell_node as jsen
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels import spmm_ell_node as tsen
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports

torch.set_num_threads(1)


def _hub_adj(n=40, seed=9, hub=None):
    """The degree profile of the JAX test
    ``test_node_ell_bucketed_handles_isolated_and_hub_rows``: random edges,
    an isolated node and a hub row of degree n-1 (or ``hub``)."""
    rng = np.random.RandomState(seed)
    adj = (rng.rand(n, n) < 0.08).astype(np.float32)
    adj[5] = 0.0
    adj[:, 5] = 0.0
    adj[7] = 1.0 if hub is None else 0.0
    if hub is not None:
        adj[7, rng.choice(n, hub, replace=False)] = 1.0
    adj[7, 7] = 0.0
    return adj


def _assert_same(j, t, path="pack"):
    """Every field of a JAX pack equals the port's: arrays exactly (indices
    compared after conversion to int64), ints equal."""
    if isinstance(j, tuple) and hasattr(j, "_fields"):
        assert type(j).__name__ == type(t).__name__, path
        for f in j._fields:
            _assert_same(getattr(j, f), getattr(t, f), f"{path}.{f}")
    elif isinstance(j, tuple):
        assert len(j) == len(t), path
        for i, (a, b) in enumerate(zip(j, t)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(j, int):
        assert j == t, path
    else:
        a = np.asarray(j)
        b = t.numpy()
        if a.dtype.kind == "i":
            assert b.dtype == np.int64, path
            a = a.astype(np.int64)
        else:
            assert b.dtype == a.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.mark.parametrize("graph,max_buckets,min_saving", [
    ("road", 1, 0.10), ("road", 4, 0.10), ("road", 4, 0.0), ("road", 2, 0.0),
    ("hub", 4, 0.0), ("hub", 1, 0.10), ("hub", 4, 0.10)])
def test_build_stacked_node_ell_equals_jax(graph, max_buckets, min_saving):
    adj = (synthetic_road_adjacency(50, avg_degree=6, seed=2)
           if graph == "road" else _hub_adj())
    sups = list(dual_random_walk_supports(adj))
    want = jsen.build_stacked_node_ell(sups, max_buckets, min_saving)
    got = tsen.build_stacked_node_ell(sups, max_buckets, min_saving)
    _assert_same(want, got)
    assert tsen.pack_nnz(got) == jsen.pack_nnz(want)


def test_isolated_and_hub_rows_aggregate_like_jax():
    """The JAX test's degenerate profile (an isolated node, a hub of degree
    n-1), bucketed: the port's aggregation equals the JAX one, and both the
    dense Chebyshev stack."""
    adj = _hub_adj()
    s1, s2 = dual_random_walk_supports(adj)
    packs = tsen.build_stacked_node_ell([s1, s2], max_buckets=4,
                                        min_saving=0.0)
    assert isinstance(packs, tsen.BucketedStackedNodeELL)
    jpacks = jsen.build_stacked_node_ell([s1, s2], max_buckets=4,
                                         min_saving=0.0)
    x = np.random.RandomState(4).randn(2, 40, 3).astype(np.float32)
    got = tsen.cheb_aggregate_node_ell(packs, torch.from_numpy(x), 3)
    want = jsen.cheb_aggregate_node_ell(jpacks, jnp.asarray(x), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    from megacrn_tpu_torch.ops.graph import cheb_aggregate

    dense = cheb_aggregate(torch.from_numpy(np.stack([s1, s2])),
                           torch.from_numpy(x), 3)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5,
                               rtol=2e-5)


def test_bucket_splits_equal_jax_and_are_optimal():
    """The DP case of ``test_bucket_splits_dp_is_optimal``: the port's cuts
    equal the JAX ones and reach the brute-force minimum."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        deg = np.sort(rng.randint(0, 12, size=rng.randint(3, 16)))
        max_buckets = rng.randint(1, 5)
        best, cuts = tsen._bucket_splits(deg, max_buckets)
        assert (best, [int(c) for c in cuts]) == tuple(
            (b if i == 0 else [int(c) for c in b])
            for i, b in enumerate(jsen._bucket_splits(deg, max_buckets)))
        ends = sorted(set(np.searchsorted(deg, np.unique(deg), "right")))
        brute = min(
            sum((e - s) * int(deg[e - 1])
                for s, e in zip([0] + list(c[:-1]), c))
            for k in range(1, max_buckets + 1)
            for c in itertools.combinations(ends, k)
            if c and c[-1] == len(deg))
        assert best == brute
        starts = [0] + cuts[:-1]
        assert best == sum((e - s) * int(deg[e - 1])
                           for s, e in zip(starts, cuts))


def _ell_case(seed, n_rows, n_cols, d, f):
    rs = np.random.RandomState(seed)
    nbr = rs.randint(0, n_cols, (n_rows, d)).astype(np.int32)
    w = rs.randn(n_rows, d).astype(np.float32)
    w[rs.rand(n_rows, d) < 0.3] = 0.0
    return nbr, w, rs.randn(n_cols, f).astype(np.float32)


@pytest.mark.parametrize("d", [1, 7, 32, 40])
def test_ell_apply_matches_jax(d):
    """Both forms (unrolled up to _UNROLL_MAX_D = 32, the einsum above)."""
    nbr, w, x = _ell_case(d, 30, 25, d, 11)
    want = jsen._ell_apply(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x))
    got = tsen._ell_apply(torch.from_numpy(nbr).long(), torch.from_numpy(w),
                          torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    einsum = tsen._ell_einsum(torch.from_numpy(nbr).long(),
                              torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(einsum.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert tsen._UNROLL_MAX_D == jsen._UNROLL_MAX_D


def _vjp_case(bucketed, seed=3):
    adj = synthetic_road_adjacency(36, avg_degree=6, seed=seed)
    adj[2, :30] = 1.0  # a hub row, so the buckets differ
    sups = list(dual_random_walk_supports(adj))
    mb = 4 if bucketed else 1
    return (jsen.build_stacked_node_ell(sups, mb, 0.0),
            tsen.build_stacked_node_ell(sups, mb, 0.0))


@pytest.mark.parametrize("bucketed", [False, True])
def test_spmm_node_ell_vjp_matches_jax(bucketed):
    """Forward and dx = A^T dy (through the transposed pack) against
    ``jax.vjp`` of the JAX custom VJP; the packs get no gradient."""
    jp, tp = _vjp_case(bucketed)
    rs = np.random.RandomState(1)
    x = rs.randn(72, 9).astype(np.float32)
    dy = rs.randn(72, 9).astype(np.float32)
    if bucketed:
        jf = lambda v: jsen.spmm_node_ell_bucketed(  # noqa: E731
            jp.fwd_nbr, jp.fwd_w, jp.fwd_inv, jp.bwd_nbr, jp.bwd_w,
            jp.bwd_inv, v)
        tf = lambda v: tsen.spmm_node_ell_bucketed(  # noqa: E731
            tp.fwd_nbr, tp.fwd_w, tp.fwd_inv, tp.bwd_nbr, tp.bwd_w,
            tp.bwd_inv, v)
    else:
        jf = lambda v: jsen.spmm_node_ell(  # noqa: E731
            jp.pack.nbr, jp.pack.w, jp.pack_t.nbr, jp.pack_t.w, v)
        tf = lambda v: tsen.spmm_node_ell(  # noqa: E731
            tp.pack.nbr, tp.pack.w, tp.pack_t.nbr, tp.pack_t.w, v)
    want_y, vjp = jax.vjp(jf, jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    y = tf(xt)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-6)
    packs = (tp.fwd_w + tp.bwd_w) if bucketed else (tp.pack.w, tp.pack_t.w)
    assert all(w.grad is None and not w.requires_grad for w in packs)


@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("cheb_k", [2, 3])
def test_cheb_aggregate_node_ell_and_its_grad_match_jax(bucketed, cheb_k):
    jp, tp = _vjp_case(bucketed, seed=5)
    rs = np.random.RandomState(2)
    x = rs.randn(3, 36, 4).astype(np.float32)
    g = rs.randn(3, 36, 2 * cheb_k, 4).astype(np.float32)
    want, vjp = jax.vjp(
        lambda v: jsen.cheb_aggregate_node_ell(jp, v, cheb_k), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    got = tsen.cheb_aggregate_node_ell(tp, xt, cheb_k)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)


def test_cheb_aggregate_node_ell_rejects_other_node_counts():
    _, tp = _vjp_case(False)
    with pytest.raises(ValueError, match="pack expects 36"):
        tsen.cheb_aggregate_node_ell(tp, torch.zeros(1, 35, 2), 3)


@pytest.mark.parametrize("bucketed", [False, True])
def test_pack_to_moves_indices_and_casts_weights(bucketed):
    _, tp = _vjp_case(bucketed)
    fwd = tp.to("cpu", torch.bfloat16)
    both = tp.to("cpu", torch.bfloat16, transpose=True)
    if bucketed:
        assert all(w.dtype == torch.bfloat16 for w in fwd.fwd_w)
        assert all(w.dtype == torch.float32 for w in fwd.bwd_w)
        assert all(w.dtype == torch.bfloat16 for w in both.bwd_w)
        assert all(a.dtype == torch.int64
                   for a in both.fwd_nbr + both.bwd_nbr
                   + (both.fwd_inv, both.bwd_inv))
    else:
        assert fwd.pack.w.dtype == torch.bfloat16
        assert fwd.pack_t.w.dtype == torch.float32
        assert both.pack_t.w.dtype == torch.bfloat16
        assert both.pack.nbr.dtype == both.pack_t.nbr.dtype == torch.int64
