"""The port's block-ELL SpMM (megacrn_tpu_torch/kernels/spmm.py), the
backward of both SpMM autograd Functions and ``cheb_aggregate_sparse``,
held against the JAX package (megacrn_tpu/kernels/spmm.py and spmm_coo.py,
Pallas kernels in interpret mode on the CPU, and their custom VJPs)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.kernels import spmm as jspmm
from megacrn_tpu.kernels import spmm_coo as jcoo
from megacrn_tpu.ops import graph as jgraph
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels import spmm as tspmm
from megacrn_tpu_torch.kernels import spmm_coo as tcoo
from megacrn_tpu_torch.ops import graph as tgraph

torch.set_num_threads(1)


def _sparse(rs, r, c, density=0.04):
    return ((rs.rand(r, c) < density) * rs.randn(r, c)).astype(np.float32)


def _case(name):
    """(a, x): a square pack, a rectangular one, one whose hub row-block
    makes the other row-blocks carry padding tiles, and one with an empty
    row-block."""
    rs = np.random.RandomState({"square": 1, "rectangular": 2, "hub": 3,
                                "empty_row_block": 0}[name])
    if name == "rectangular":
        return _sparse(rs, 96, 384), rs.randn(384, 7).astype(np.float32)
    if name == "hub":
        a = np.zeros((300, 300), np.float32)
        a[:128] = _sparse(rs, 128, 300, 0.05)  # 3 tiles; the others 1-2
        a[200:, 200:] = _sparse(rs, 100, 100, 0.05)
        return a, rs.randn(300, 19).astype(np.float32)
    a = _sparse(rs, 300, 300)
    if name == "empty_row_block":
        a[128:256] = 0.0
    return a, rs.randn(300, 6).astype(np.float32)


CASES = ["square", "rectangular", "hub", "empty_row_block"]


@pytest.mark.parametrize("name", CASES)
def test_pack_matches_jax(name):
    a, _ = _case(name)
    for build in ("to_block_ell", "transpose_block_ell"):
        want = getattr(jspmm, build)(a)
        got = getattr(tspmm, build)(a)
        for field in ("data", "cols", "nnz_blocks"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)))
        assert (got.n, got.n_orig, got.n_col, got.n_col_orig) == (
            want.n, want.n_orig, want.n_col, want.n_col_orig)
    pack = tspmm.to_block_ell(a)
    nnz = pack.nnz_blocks.numpy()
    if name == "hub":
        assert nnz.max() == pack.cols.shape[1] > nnz.min()  # padding tiles
    if name == "empty_row_block":
        assert nnz[1] == 0


@pytest.mark.parametrize("name", CASES)
def test_spmm_matches_jax(name):
    a, x = _case(name)
    want = np.asarray(jspmm.spmm(jspmm.to_block_ell(a),
                                 jspmm.transpose_block_ell(a),
                                 jnp.asarray(x)))
    pack = tspmm.to_block_ell(a)
    got = tspmm.spmm(pack, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), a @ x, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), tspmm.spmm_reference(pack, torch.from_numpy(x)))
    # The plain version on the CPU launches no kernel.
    assert tspmm.spmm.launches == 0


def _jax_dx(fn, x, g):
    """jax.grad of <fn(x), g> through the JAX custom VJP: A^T g."""
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v) * g))(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["block_ell", "block_coo"])
@pytest.mark.parametrize("name", ["square", "rectangular", "hub"])
def test_function_dx_matches_jax_grad(kind, name):
    """dx of the port's autograd Function (its plain path on the CPU, on
    the transposed pack) against jax.grad through the JAX custom VJP."""
    a, x = _case(name)
    rs = np.random.RandomState(9)
    g = rs.randn(a.shape[0], x.shape[1]).astype(np.float32)
    if kind == "block_ell":
        ja, ja_t = jspmm.to_block_ell(a), jspmm.transpose_block_ell(a)
        want = _jax_dx(lambda v: jspmm.spmm(ja, ja_t, v), x, g)
        fn, ta, ta_t = (tspmm.SpmmELLFunction, tspmm.to_block_ell(a),
                        tspmm.transpose_block_ell(a))
    else:
        ja, ja_t = jcoo.to_block_coo(a), jcoo.transpose_block_coo(a)
        want = _jax_dx(lambda v: jcoo.spmm_coo(ja, ja_t, v), x, g)
        fn, ta, ta_t = (tcoo.SpmmCOOFunction, tcoo.to_block_coo(a),
                        tcoo.transpose_block_coo(a))
    xt = torch.from_numpy(x).requires_grad_()
    y = fn.apply(xt, ta, ta_t)
    np.testing.assert_allclose(y.detach().numpy(), a @ x, atol=1e-5,
                               rtol=1e-5)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), a.T @ g, atol=1e-5,
                               rtol=1e-5)


def test_spmm_batched_matches_jax():
    n, b, c = 150, 4, 16
    a = np.asarray(synthetic_road_adjacency(n, avg_degree=4), np.float32)
    x = np.random.RandomState(5).randn(b, n, c).astype(np.float32)
    want = jspmm.spmm_batched(jspmm.to_block_ell(a),
                              jspmm.transpose_block_ell(a), jnp.asarray(x))
    got = tspmm.spmm_batched(tspmm.to_block_ell(a),
                             tspmm.transpose_block_ell(a),
                             torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_cheb_aggregate_sparse_matches_jax(impl):
    """Forward and dx of the block-ELL Chebyshev stack (support-major
    order) against megacrn_tpu/ops/graph.py:cheb_aggregate_sparse."""
    n = 150
    sups = tgraph.dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=5, seed=4))
    rs = np.random.RandomState(5)
    x = rs.randn(3, n, 6).astype(np.float32)
    g = rs.randn(3, n, 6, 6).astype(np.float32)
    jpacks = [(jspmm.to_block_ell(s), jspmm.transpose_block_ell(s))
              for s in sups]
    want = jgraph.cheb_aggregate_sparse(jpacks, jnp.asarray(x), 3)
    want_dx = jax.grad(lambda v: jnp.sum(
        jgraph.cheb_aggregate_sparse(jpacks, v, 3) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = tgraph.cheb_aggregate_sparse(
        tspmm.build_road_ell_pairs(sups, impl=impl), xt, 3)
    assert got.shape == (3, n, 6, 6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-4, rtol=1e-5)


def test_cheb_aggregate_sparse_stacked_dx_matches_jax():
    """dx of the stacked COO Chebyshev stack through SpmmCOOFunction
    against jax.grad through the JAX custom VJP."""
    n = 150
    sups = tgraph.dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=5, seed=4))
    rs = np.random.RandomState(6)
    x = rs.randn(3, n, 6).astype(np.float32)
    g = rs.randn(3, n, 6, 6).astype(np.float32)
    jpack = jcoo.build_stacked_road_pack(list(sups), impl="pallas")
    want_dx = jax.grad(lambda v: jnp.sum(
        jgraph.cheb_aggregate_sparse_stacked(jpack, v, 3) * g))(
            jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tgraph.cheb_aggregate_sparse_stacked(
        tcoo.build_stacked_road_pack(list(sups)), xt, 3).backward(
            torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               atol=1e-4, rtol=1e-5)


def test_stacked_pack_to_moves_pack_t_only_when_asked():
    sups = tgraph.dual_random_walk_supports(
        synthetic_road_adjacency(40, avg_degree=4, seed=0))
    pack = tcoo.build_stacked_road_pack(list(sups))
    served = pack.to("cpu", torch.bfloat16)
    assert served.pack.data.dtype == torch.bfloat16
    assert served.pack_t is pack.pack_t
    trained = pack.to("cpu", torch.bfloat16, transpose=True)
    assert trained.pack_t.data.dtype == torch.bfloat16
    assert trained.pack_t.rows is pack.pack_t.rows  # indices stay as built


def test_cuda_tensor_without_card_raises_not_falls_back():
    """A CUDA tensor goes to the kernel or raises: with no card (and no
    nvcc) the wrapper must not answer through the plain version."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a, x = _case("hub")
    pack = tspmm.to_block_ell(a)
    with FakeTensorMode():
        def cuda(t):  # same shape and dtype, no values, device "cuda"
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")

        pack_c = pack._replace(data=cuda(pack.data), cols=cuda(pack.cols),
                               nnz_blocks=cuda(pack.nnz_blocks))
        x_c = cuda(torch.from_numpy(x))
        assert x_c.device.type == "cuda"
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            tspmm.spmm(pack_c, x_c)
    assert tspmm.spmm.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "rows", "device"])
def test_spmm_rejects_what_it_does_not_take(bad):
    a, x = _case("hub")
    pack, xt = tspmm.to_block_ell(a), torch.from_numpy(x)
    if bad == "dtype":
        with pytest.raises(TypeError):
            tspmm.spmm(pack, xt.double())
    elif bad == "rows":
        with pytest.raises(ValueError):
            tspmm.spmm(pack, xt[:-1])
    else:
        with pytest.raises(ValueError):
            tspmm.spmm(pack, xt.to("meta"))
