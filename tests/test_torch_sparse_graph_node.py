"""The port's node-granular learned sparse graph ops
(megacrn_tpu_torch/kernels/sparse_graph_node.py) held against the JAX
package on the CPU: the pattern builders give the JAX arrays exactly (index
arrays after the int32 -> int64 conversion), and every op's forward and
gradients match ``jax.vjp`` of the JAX op at f32 (rtol 1e-5; 1e-4 where an
SDDMM's dot product sums its K terms in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.kernels import sparse_graph_node as jsgn
from megacrn_tpu_torch.kernels import sparse_graph_node as tsgn

torch.set_num_threads(1)
N, DIM = 36, 6


def _adj(n=N, seed=0, density=0.12):
    """Random edges with an empty row, an isolated node and a hub row."""
    rs = np.random.RandomState(seed)
    adj = (rs.rand(n, n) < density).astype(np.float32)
    adj[0] = 0.0  # empty row (in-edges remain)
    adj[4] = 0.0
    adj[:, 4] = 0.0  # isolated
    adj[9, :n - 4] = 1.0  # hub row
    return adj


def _assert_same(j, t, path="pattern"):
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
        a, b = np.asarray(j), t.numpy()
        if a.dtype.kind == "i":
            assert b.dtype == np.int64, path
            a = a.astype(np.int64)
        else:
            assert b.dtype == a.dtype, path
        np.testing.assert_array_equal(b, a, err_msg=path)


@pytest.mark.parametrize("max_buckets,min_saving,seed", [
    (1, 0.10, 0), (4, 0.10, 0), (4, 0.0, 0), (2, 0.0, 1), (4, 0.0, 2)])
def test_build_node_pattern_equals_jax(max_buckets, min_saving, seed):
    adj = _adj(seed=seed)
    _assert_same(jsgn.build_node_pattern(adj, max_buckets, min_saving),
                 tsgn.build_node_pattern(adj, max_buckets, min_saving))


@pytest.mark.parametrize("max_buckets", [2, 3, 4])
def test_build_node_pattern_bucketed_equals_jax(max_buckets):
    adj = _adj(seed=3)
    want = jsgn.build_node_pattern_bucketed(adj, max_buckets)
    got = tsgn.build_node_pattern_bucketed(adj, max_buckets)
    _assert_same(want, got)
    assert isinstance(got, tsgn.BucketedNodeELLPattern)


def _flat():
    adj = _adj()
    return (jsgn.build_node_pattern(adj, max_buckets=1),
            tsgn.build_node_pattern(adj, max_buckets=1))


def _bucketed():
    adj = _adj()
    return (jsgn.build_node_pattern_bucketed(adj, 4),
            tsgn.build_node_pattern_bucketed(adj, 4))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _vjp(jfn, tfn, args, cot, rtol=1e-5, atol=1e-6):
    """Forward and gradients of every argument: jax.vjp of ``jfn`` against
    torch autograd through ``tfn`` (outputs may be tuples of arrays)."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    want_grads = vjp(jax.tree_util.tree_map(jnp.asarray, cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*targs)
    flat_got = got if isinstance(got, tuple) else (got,)
    flat_want = want if isinstance(want, tuple) else (want,)
    flat_cot = cot if isinstance(cot, tuple) else (cot,)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=rtol, atol=atol)
    torch.autograd.backward(list(flat_got),
                            [torch.from_numpy(c) for c in flat_cot])
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"grad of arg {i}")


def test_sddmm_node_and_its_vjp_match_jax():
    jp, tp = _flat()
    rs = np.random.RandomState(1)
    e1, e2 = (rs.randn(N, DIM).astype(np.float32) for _ in range(2))
    cot = rs.randn(*tp.mask.shape).astype(np.float32)
    _vjp(lambda a, b: jsgn.sddmm_node(a, b, jp.nbr, jp.mask),
         lambda a, b: tsgn.sddmm_node(a, b, tp.nbr, tp.mask),
         (e1, e2), cot, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("wide", [False, True])
def test_slot_sddmm_both_forms_match_jax(wide):
    """The unrolled form (D <= 32) and the einsum form (D > 32)."""
    rs = np.random.RandomState(2)
    d = 40 if wide else 9
    nbr = rs.randint(0, 20, (15, d))
    a = rs.randn(15, 5).astype(np.float32)
    b = rs.randn(20, 5).astype(np.float32)
    want = jsgn._slot_sddmm(jnp.asarray(a), jnp.asarray(nbr.astype(np.int32)),
                            jnp.asarray(b))
    got = tsgn._slot_sddmm(_t(a), _t(nbr), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_node_row_softmax_matches_jax_and_empty_rows_give_zero(dtype):
    """Masked softmax per row and its vjp; the empty row gives exactly 0 and
    no NaN, in f32 and in bf16 (where exp(finfo.min - max) must underflow to
    0, not overflow)."""
    jp, tp = _flat()
    rs = np.random.RandomState(3)
    scores = rs.randn(*tp.mask.shape).astype(np.float32) * 3
    mask = tp.mask.numpy()
    assert mask[0].sum() == 0  # the empty row
    if dtype == "bfloat16":
        got = tsgn.node_row_softmax(_t(scores).to(torch.bfloat16),
                                    tp.mask.to(torch.bfloat16))
        want = jsgn.node_row_softmax(jnp.asarray(scores, jnp.bfloat16),
                                     jnp.asarray(mask, jnp.bfloat16))
        got = got.float().numpy()
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got[0], 0.0)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)
        return
    cot = rs.randn(*mask.shape).astype(np.float32)
    _vjp(lambda s: jsgn.node_row_softmax(s, jp.mask),
         lambda s: tsgn.node_row_softmax(s, tp.mask), (scores,), cot)
    got = tsgn.node_row_softmax(_t(scores), tp.mask).numpy()
    np.testing.assert_array_equal(got[0], 0.0)
    np.testing.assert_allclose(got[mask.sum(1) > 0].sum(1), 1.0, rtol=1e-6)


def test_spmm_node_vjp_matches_jax_in_w_and_x():
    """y = A_w x: forward, dw (the SDDMM on the pattern slots) and dx
    (through the transposed slot map)."""
    jp, tp = _flat()
    rs = np.random.RandomState(4)
    w = (rs.rand(*tp.mask.shape) * tp.mask.numpy()).astype(np.float32)
    x = rs.randn(N, 7).astype(np.float32)
    cot = rs.randn(N, 7).astype(np.float32)
    _vjp(lambda w_, x_: jsgn.spmm_node(jp.nbr, jp.mask, jp.t_nbr, jp.t_slot,
                                       jp.t_mask, w_, x_),
         lambda w_, x_: tsgn.spmm_node(tp.nbr, tp.mask, tp.t_nbr, tp.t_slot,
                                       tp.t_mask, w_, x_),
         (w, x), cot, rtol=1e-4, atol=1e-5)


def test_spmm_node_bucketed_vjp_matches_jax_in_w_and_x():
    jp, tp = _bucketed()
    rs = np.random.RandomState(5)
    ws = tuple((rs.rand(*m.shape) * m.numpy()).astype(np.float32)
               for m in tp.mask)
    x = rs.randn(N, 7).astype(np.float32)
    cot = rs.randn(N, 7).astype(np.float32)
    nb = len(ws)
    _vjp(lambda *a: jsgn.spmm_node_bucketed(
            jp.nbr, jp.mask, jp.rows, jp.inv, jp.t_nbr, jp.t_slot,
            jp.t_mask, jp.t_inv, a[:nb], a[nb]),
         lambda *a: tsgn.spmm_node_bucketed(
            tp.nbr, tp.mask, tp.rows, tp.inv, tp.t_nbr, tp.t_slot,
            tp.t_mask, tp.t_inv, a[:nb], a[nb]),
         ws + (x,), cot, rtol=1e-4, atol=1e-5)


def test_sddmm_and_softmax_bucketed_match_jax():
    jp, tp = _bucketed()
    rs = np.random.RandomState(6)
    e1, e2 = (rs.randn(N, DIM).astype(np.float32) for _ in range(2))
    cot = tuple(rs.randn(*m.shape).astype(np.float32) for m in tp.mask)

    def jf(a, b):
        return jsgn.node_row_softmax_bucketed(
            jsgn.sddmm_node_bucketed(a, b, jp), jp)

    def tf(a, b):
        return tsgn.node_row_softmax_bucketed(
            tsgn.sddmm_node_bucketed(a, b, tp), tp)

    _vjp(jf, tf, (e1, e2), cot, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["flat", "bucketed"])
def test_sparse_meta_graph_and_learned_aggregation_match_jax(layout):
    """The composition: learned supports from (Memory, We1, We2) and the
    Chebyshev stack over them, with gradients into the memory parameters
    and x."""
    jp, tp = _flat() if layout == "flat" else _bucketed()
    rs = np.random.RandomState(7)
    memory = rs.randn(4, DIM).astype(np.float32)
    we1, we2 = (rs.randn(N, 4).astype(np.float32) for _ in range(2))
    x = rs.randn(2, N, 3).astype(np.float32)
    cot = rs.randn(2, N, 6, 3).astype(np.float32)

    def jf(m, a, b, v):
        w = jsgn.sparse_meta_graph_node(m, a, b, jp)
        return jsgn.cheb_aggregate_learned_node(w, jp, v, 3)

    def tf(m, a, b, v):
        w = tsgn.sparse_meta_graph_node(m, a, b, tp)
        return tsgn.cheb_aggregate_learned_node(w, tp, v, 3)

    _vjp(jf, tf, (memory, we1, we2, x), cot, rtol=1e-4, atol=1e-5)


def test_pattern_to_moves_indices_and_casts_masks():
    _, tp = _bucketed()
    fwd = tp.to("cpu", torch.float64)
    both = tp.to("cpu", torch.float64, transpose=True)
    assert all(m.dtype == torch.float64 for m in fwd.mask)
    assert all(m.dtype == torch.float32 for m in fwd.t_mask)
    assert all(m.dtype == torch.float64 for m in both.t_mask)
    for t in both.nbr + both.rows + both.t_nbr + both.t_slot + (both.inv,
                                                                both.t_inv):
        assert t.dtype == torch.int64
