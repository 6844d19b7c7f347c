"""The hand-written block-COO kernel against its plain version on a CUDA
card. Imports no JAX, so it runs on the machine with the card:

    python -m pytest tests/test_torch_spmm_coo_card.py -q

With no card it skips (decided inside the test, never at import)."""
import numpy as np
import pytest
import torch

from megacrn_tpu_torch.kernels import spmm_coo as tspmm


def _sparse(rs, r, c, density=0.04):
    return ((rs.rand(r, c) < density) * rs.randn(r, c)).astype(np.float32)


@pytest.mark.parametrize("shape,f,empty", [((300, 300), 6, True),
                                           ((96, 384), 7, False),
                                           ((300, 300), 19, False)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 1e-2)])
def test_kernel_matches_reference_on_card(shape, f, empty, dtype, rtol):
    """f32: only the summation order differs; bf16: the same bf16 inputs
    and f32 sums on both sides, so one bf16 ulp of output rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(0)
    a = _sparse(rs, *shape)
    if empty:
        a[128:256] = 0.0
    pack = tspmm.to_block_coo(a).to("cuda", dtype)
    x = torch.from_numpy(rs.randn(shape[1], f)).to("cuda", dtype)
    before = tspmm.spmm_coo.launches
    got = tspmm.spmm_coo(pack, x).float()
    assert tspmm.spmm_coo.launches == before + 1
    want = tspmm.spmm_coo_reference(pack, x).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=rtol,
                               atol=1e-5 * want.abs().max().item())
    if empty:
        assert (got[128:256] == 0).all()
