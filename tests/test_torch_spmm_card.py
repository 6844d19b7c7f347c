"""The hand-written block-ELL kernel, and the backward of both SpMM
autograd Functions, against their plain versions on a CUDA card. Imports no
JAX, so it runs on the machine with the card:

    python -m pytest --noconftest tests/test_torch_spmm_card.py -q

With no card it skips (decided inside the test, never at import)."""
import numpy as np
import pytest
import torch

from megacrn_tpu_torch.kernels import spmm as tspmm
from megacrn_tpu_torch.kernels import spmm_coo as tcoo


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _sparse(rs, r, c, density=0.04):
    return ((rs.rand(r, c) < density) * rs.randn(r, c)).astype(np.float32)


def _case(rs, name):
    if name == "long_row":  # rows of over 100 nonzeros, in A and in A^T
        a = _sparse(rs, 300, 300)
        a[5, rs.choice(300, 120, replace=False)] = rs.randn(120)
        a[rs.choice(300, 110, replace=False), 7] = rs.randn(110)
        return a, 40
    if name == "rectangular":
        return _sparse(rs, 96, 384), 7
    if name == "hub":  # the other row-blocks carry padding tiles
        a = np.zeros((300, 300), np.float32)
        a[:128] = _sparse(rs, 128, 300, 0.05)
        a[200:, 200:] = _sparse(rs, 100, 100, 0.05)
        return a, 19
    a = _sparse(rs, 300, 300)
    a[128:256] = 0.0  # an empty row-block (nnz_blocks == 0)
    return a, 6


@pytest.mark.parametrize("name", ["empty_row_block", "rectangular", "hub",
                                  "long_row"])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_block_ell_kernel_matches_reference_on_card(name, dtype, rtol):
    """f32: only the summation order differs; bf16: the same bf16 inputs
    and f32 sums on both sides, so one bf16 ulp of output rounding."""
    _need_card()
    rs = np.random.RandomState(0)
    a, f = _case(rs, name)
    pack = tspmm.to_block_ell(a).to("cuda", dtype)
    x = torch.from_numpy(rs.randn(a.shape[1], f)).to("cuda", dtype)
    before = tspmm.spmm.launches
    got = tspmm.spmm(pack, x).float()
    assert tspmm.spmm.launches == before + 1
    want = tspmm.spmm_reference(pack, x).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())
    if name == "empty_row_block":
        assert (got[128:256] == 0).all()


@pytest.mark.parametrize("kind", ["block_ell", "block_coo"])
def test_function_backward_matches_plain_autograd_on_card(kind):
    """dx from the kernel's autograd Function (one launch on the transposed
    pack) against autograd through the plain version, f32."""
    _need_card()
    rs = np.random.RandomState(1)
    a, _ = _case(rs, "hub")
    f = 70
    if kind == "block_ell":
        fn = tspmm.SpmmELLFunction
        pack, pack_t = (tspmm.to_block_ell(a).to("cuda"),
                        tspmm.transpose_block_ell(a).to("cuda"))
        plain, counter = tspmm.spmm_reference, tspmm.spmm
    else:
        fn = tcoo.SpmmCOOFunction
        pack, pack_t = (tcoo.to_block_coo(a).to("cuda"),
                        tcoo.transpose_block_coo(a).to("cuda"))
        plain, counter = tcoo.spmm_coo_reference, tcoo.spmm_coo
    x = torch.from_numpy(rs.randn(300, f)).float().cuda()
    g = torch.from_numpy(rs.randn(300, f)).float().cuda()
    x1 = x.clone().requires_grad_()
    before = counter.launches
    fn.apply(x1, pack, pack_t).backward(g)
    assert counter.launches == before + 2  # forward, then backward
    x2 = x.clone().requires_grad_()
    plain(pack, x2).backward(g)
    torch.cuda.synchronize()
    torch.testing.assert_close(x1.grad, x2.grad, rtol=1e-5,
                               atol=1e-5 * x2.grad.abs().max().item())
