"""The port's block-COO SpMM (megacrn_tpu_torch/kernels/spmm_coo.py) held
against the JAX package's (megacrn_tpu/kernels/spmm_coo.py, Pallas kernel in
interpret mode on the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megacrn_tpu.kernels import spmm_coo as jspmm
from megacrn_tpu.ops import graph as jgraph
from megacrn_tpu_torch.kernels import spmm_coo as tspmm
from megacrn_tpu_torch.ops import graph as tgraph

torch.set_num_threads(1)


def _sparse(rs, r, c, density=0.04):
    return ((rs.rand(r, c) < density) * rs.randn(r, c)).astype(np.float32)


def _case(name):
    """(a, x) of the three shapes the JAX package's tests cover."""
    rs = np.random.RandomState({"empty_row_block": 0, "rectangular": 2,
                                "f19": 8}[name])
    if name == "rectangular":
        return _sparse(rs, 96, 384), rs.randn(384, 7).astype(np.float32)
    a = _sparse(rs, 300, 300)
    if name == "empty_row_block":
        a[128:256] = 0.0  # the middle row-block has no tile
    return a, rs.randn(300, 19 if name == "f19" else 6).astype(np.float32)


CASES = ["empty_row_block", "rectangular", "f19"]


@pytest.mark.parametrize("name", CASES)
def test_pack_matches_jax(name):
    a, _ = _case(name)
    for build in ("to_block_coo", "transpose_block_coo"):
        want = getattr(jspmm, build)(a)
        got = getattr(tspmm, build)(a)
        np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        assert (got.n, got.n_orig, got.n_col, got.n_col_orig) == (
            want.n, want.n_orig, want.n_col, want.n_col_orig)
        # row_ptr is the CSR of the sorted rows.
        rp = got.row_ptr.numpy()
        assert rp[0] == 0 and rp[-1] == len(got.rows)
        for r in range(got.n // tspmm.BLOCK):
            assert (got.rows.numpy()[rp[r]:rp[r + 1]] == r).all()


def test_stacked_pack_matches_jax():
    from megacrn_tpu.data.synthetic import synthetic_road_adjacency as jadj
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency

    adj = synthetic_road_adjacency(300, avg_degree=5, seed=4)
    np.testing.assert_array_equal(adj, jadj(300, avg_degree=5, seed=4))
    sups = tgraph.dual_random_walk_supports(adj)
    for s_t, s_j in zip(sups, jgraph.dual_random_walk_supports(adj)):
        np.testing.assert_array_equal(s_t, s_j)
    want = jspmm.build_stacked_road_pack(list(sups), impl="pallas")
    got = tspmm.build_stacked_road_pack(list(sups))
    assert (got.num_supports, got.n_pad) == (want.num_supports, want.n_pad)
    for g, w in ((got.pack, want.pack), (got.pack_t, want.pack_t)):
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(w.rows))
        np.testing.assert_array_equal(g.cols.numpy(), np.asarray(w.cols))
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


@pytest.mark.parametrize("name", CASES)
def test_spmm_coo_matches_jax(name):
    a, x = _case(name)
    want = np.asarray(jspmm.spmm_coo(jspmm.to_block_coo(a),
                                     jspmm.transpose_block_coo(a),
                                     jnp.asarray(x)))
    pack = tspmm.to_block_coo(a)
    got = tspmm.spmm_coo(pack, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), tspmm.spmm_coo_reference(pack, torch.from_numpy(x)))
    # The plain version on the CPU launches no kernel.
    assert tspmm.spmm_coo.launches == 0


def test_cheb_aggregate_sparse_stacked_matches_jax():
    from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency

    n = 300
    sups = tgraph.dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=5, seed=4))
    x = np.random.RandomState(5).randn(4, n, 6).astype(np.float32)
    want = jgraph.cheb_aggregate_sparse_stacked(
        jspmm.build_stacked_road_pack(list(sups), impl="pallas"),
        jnp.asarray(x), 3)
    for impl in ("kernel", "reference"):
        got = tgraph.cheb_aggregate_sparse_stacked(
            tspmm.build_stacked_road_pack(list(sups), impl=impl),
            torch.from_numpy(x), 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


def test_cuda_tensor_without_card_raises_not_falls_back():
    """A CUDA tensor goes to the kernel or raises: with no card (and no
    nvcc) the wrapper must not answer through the plain version. Fake CUDA
    tensors let the dispatch run on a machine that has no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    a, x = _case("f19")
    pack = tspmm.to_block_coo(a)
    with FakeTensorMode():
        def cuda(t):  # same shape and dtype, no values, device "cuda"
            return torch.empty(t.shape, dtype=t.dtype, device="cuda")

        pack_c = pack._replace(rows=cuda(pack.rows), cols=cuda(pack.cols),
                               data=cuda(pack.data),
                               row_ptr=cuda(pack.row_ptr),
                               nz_row_ptr=cuda(pack.nz_row_ptr),
                               nz_cols=cuda(pack.nz_cols),
                               nz_vals=cuda(pack.nz_vals))
        x_c = cuda(torch.from_numpy(x))
        assert x_c.device.type == "cuda"
        with pytest.raises(RuntimeError, match="nvcc|CUDA"):
            tspmm.spmm_coo(pack_c, x_c)
    assert tspmm.spmm_coo.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "rows", "device"])
def test_spmm_coo_rejects_what_it_does_not_take(bad):
    a, x = _case("f19")
    pack, xt = tspmm.to_block_coo(a), torch.from_numpy(x)
    if bad == "dtype":
        with pytest.raises(TypeError):
            tspmm.spmm_coo(pack, xt.double())
    elif bad == "rows":
        with pytest.raises(ValueError):
            tspmm.spmm_coo(pack, xt[:-1])
    else:
        with pytest.raises(ValueError):
            tspmm.spmm_coo(pack, xt.to("meta"))
