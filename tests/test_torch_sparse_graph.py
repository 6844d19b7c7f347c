"""The port's 128x128-tile learned sparse graph ops
(megacrn_tpu_torch/kernels/sparse_graph.py) held against the JAX package on
the CPU: ``build_block_pattern`` gives the JAX arrays exactly, and every
op's forward and gradients match ``jax.vjp`` of the JAX op at f32 (rtol
1e-5; 1e-4 where a tile product sums in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.kernels import sparse_graph as jsg
from megacrn_tpu_torch.kernels import sparse_graph as tsg

torch.set_num_threads(1)
N = 150  # two row-blocks, the second one partial


def _adj(n=N, seed=0):
    rs = np.random.RandomState(seed)
    adj = (rs.rand(n, n) < 0.03).astype(np.float32)
    adj[20] = 0.0  # an empty row
    adj[:, n - 10:] = 0.0  # the last columns hold one entry
    adj[5, n - 5] = 1.0
    return adj


@pytest.mark.parametrize("n,seed", [(150, 0), (100, 1), (256, 2), (130, 3)])
def test_build_block_pattern_equals_jax(n, seed):
    adj = _adj(n, seed)
    if n == 256:
        adj[128:, :128] = 0.0  # a row-block with fewer stored tiles
    want = jsg.build_block_pattern(adj)
    got = tsg.build_block_pattern(adj)
    assert (got.n, got.n_orig) == (want.n, want.n_orig)
    assert got.cols.dtype == torch.int64
    np.testing.assert_array_equal(got.cols.numpy(),
                                  np.asarray(want.cols).astype(np.int64))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))


def _patterns():
    adj = _adj()
    return jsg.build_block_pattern(adj), tsg.build_block_pattern(adj)


def _vjp(jfn, tfn, args, cot, rtol=1e-5, atol=1e-6):
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    want_grads = vjp(jnp.asarray(cot))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    got = tfn(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)
    got.backward(torch.from_numpy(cot))
    for i, (t, w) in enumerate(zip(targs, want_grads)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"grad of arg {i}")


def test_sddmm_blocks_and_its_vjp_match_jax():
    jp, tp = _patterns()
    rs = np.random.RandomState(1)
    e1, e2 = (rs.randn(N, 5).astype(np.float32) for _ in range(2))
    cot = rs.randn(*tp.mask.shape).astype(np.float32)
    _vjp(lambda a, b: jsg.sddmm_blocks(a, b, jp),
         lambda a, b: tsg.sddmm_blocks(a, b, tp), (e1, e2), cot, rtol=1e-4,
         atol=1e-5)


def test_spmm_blocks_vjp_matches_jax_in_tiles_and_x():
    jp, tp = _patterns()
    rs = np.random.RandomState(2)
    tiles = (rs.rand(*tp.mask.shape) * tp.mask.numpy()).astype(np.float32)
    x = rs.randn(N, 6).astype(np.float32)
    cot = rs.randn(N, 6).astype(np.float32)
    _vjp(lambda t, v: jsg.spmm_blocks(t, jp, v),
         lambda t, v: tsg.spmm_blocks(t, tp, v), (tiles, x), cot, rtol=1e-4,
         atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_block_row_softmax_matches_jax_and_empty_rows_give_zero(scale):
    jp, tp = _patterns()
    rs = np.random.RandomState(3)
    scores = (rs.randn(*tp.mask.shape) * 3).astype(np.float32)
    cot = rs.randn(*tp.mask.shape).astype(np.float32)
    _vjp(lambda s: jsg.block_row_softmax(s, jp, scale),
         lambda s: tsg.block_row_softmax(s, tp, scale), (scores,), cot)
    got = tsg.block_row_softmax(torch.from_numpy(scores), tp, scale)
    # Row 20 (row-block 0, row 20) has no edges: all its entries are 0.
    np.testing.assert_array_equal(got[0, :, 20].numpy(), 0.0)
    sums = got.sum(dim=(1, 3)).reshape(-1)[:N].numpy()
    has = _adj().sum(1) > 0
    np.testing.assert_allclose(sums[has], 1.0, rtol=1e-6)


def test_block_row_softmax_bfloat16_has_no_nan():
    _, tp = _patterns()
    rs = np.random.RandomState(4)
    scores = torch.from_numpy(rs.randn(*tp.mask.shape).astype(np.float32))
    got = tsg.block_row_softmax(scores.to(torch.bfloat16),
                                tp.to(dtype=torch.bfloat16))
    assert torch.isfinite(got.float()).all()
    assert (got[0, :, 20] == 0).all()


def test_sparse_meta_graph_and_learned_aggregation_match_jax():
    """The composition: learned tile supports from (Memory, We1, We2) and
    the Chebyshev stack over them, gradients into the memory parameters and
    x."""
    jp, tp = _patterns()
    rs = np.random.RandomState(5)
    memory = rs.randn(4, 5).astype(np.float32)
    we1, we2 = (rs.randn(N, 4).astype(np.float32) for _ in range(2))
    x = rs.randn(2, N, 3).astype(np.float32)
    cot = rs.randn(2, N, 6, 3).astype(np.float32)

    def jf(m, a, b, v):
        return jsg.cheb_aggregate_learned_sparse(
            jsg.sparse_meta_graph(m, a, b, jp), jp, v, 3)

    def tf(m, a, b, v):
        return tsg.cheb_aggregate_learned_sparse(
            tsg.sparse_meta_graph(m, a, b, tp), tp, v, 3)

    _vjp(jf, tf, (memory, we1, we2, x), cot, rtol=1e-4, atol=1e-5)


def test_pad_nodes_matches_jax():
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    np.testing.assert_array_equal(
        tsg._pad_nodes(torch.from_numpy(x), 7).numpy(),
        np.asarray(jsg._pad_nodes(jnp.asarray(x), 7)))
    assert tsg._pad_nodes(torch.from_numpy(x), 4).shape == (4, 3)


def test_pattern_to_moves_cols_and_casts_mask():
    _, tp = _patterns()
    moved = tp.to("cpu", torch.bfloat16, transpose=True)
    assert moved.cols.dtype == torch.int64 and torch.equal(moved.cols,
                                                           tp.cols)
    assert moved.mask.dtype == torch.bfloat16
    assert (moved.n, moved.n_orig) == (tp.n, tp.n_orig)
