"""The counts under portbench/counts/ against counts worked by hand at a
tiny shape."""
import numpy as np
import pytest

from portbench.counts import megacrn, spmm
from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

TINY = dict(num_nodes=3, input_dim=1, output_dim=1, horizon=1, seq_len=1,
            rnn_units=2, num_layers=1, cheb_k=3, ycov_dim=1, mem_num=2,
            mem_dim=2)


def test_forward_flops_sparse_by_hand():
    # B=1, N=3, nnz=4, S=2, K=3. Encoder (C=1+2=3, H=2): aggregations
    # (K-1)*2*nnz*B*(C+H) = 2*2*4*5 = 80; gate projection
    # 2*3*(2*3*3)*(2*2) = 432; candidate 2*3*18*2 = 216. Decoder (C=2+4=6,
    # H=4): 2*2*4*10 = 160; 2*3*36*8 = 1728; 2*3*36*4 = 864. Memory: query
    # 2*3*2*2 = 24, scores and value 2*(2*3*2*2) = 48. Projection 2*3*4*1.
    want = 80 + 432 + 216 + 160 + 1728 + 864 + 24 + 48 + 24
    assert megacrn.forward_flops(TINY, 1, nnz=4) == want
    assert megacrn.train_step_flops(TINY, 1, nnz=4) == 3 * want


def test_forward_flops_dense_by_hand():
    # The dense aggregations: S*(K-1)*2*N*N*B = 2*2*2*9 = 72 per channel,
    # times (C+H) = 5 and 10; the learned graph: 2*(2*3*2*2) for E_1, E_2
    # and 2*(2*3*3*2) for the two products.
    sparse = megacrn.forward_flops(TINY, 1, nnz=4)
    dense = megacrn.forward_flops(TINY, 1)
    assert dense - sparse == (72 - 16) * (5 + 10) + 48 + 72


def test_spmm_bound_by_hand():
    a = np.array([[0, 2, 0], [0, 0, 0], [1, 3, 0]], np.float32)
    c = spmm.SparseCounts.of(a)
    assert (c.nnz, c.x_rows, c.n_rows) == (3, 2, 3)
    f = 8
    nbytes = 3 * 8 + 4 * 4 + 2 * f * 4 + 3 * f * 4
    seconds, by = spmm.spmm_bound(c, f)
    assert by == "bytes"
    assert seconds == pytest.approx(max(nbytes / HBM_BYTES_PER_S,
                                        2 * 3 * f / PEAK_FLOPS["float32"]))


def test_train_step_launches_by_hand():
    m = dict(TINY, seq_len=2, horizon=2)
    launches = spmm.train_step_launches(m, 4)
    fwd = [f for side, f in launches if side == "fwd"]
    bwd = [f for side, f in launches if side == "bwd"]
    # 4 cell steps x 2 aggregations x 2 levels; the first encoder step's
    # [x || 0] has no backward.
    assert len(fwd) == 16 and len(bwd) == 14
    assert sorted(set(fwd)) == [4 * 2, 4 * 3, 4 * 4, 4 * 6]


def test_expytky_step_counts():
    from portbench.harness import data

    m = dict(num_nodes=1843, input_dim=1, output_dim=1, horizon=6,
             seq_len=6, rnn_units=32, num_layers=1, cheb_k=3, ycov_dim=1,
             mem_num=10, mem_dim=32)
    sup = data.dual_random_walk(data.road_adjacency(1843, 8, 0))
    big = spmm.stacked(sup)
    assert big.shape == (3840, 3840)
    assert spmm.SparseCounts.of(big).nnz == 29376
    launches = spmm.train_step_launches(m, 64)
    assert sum(s == "fwd" for s, _ in launches) == 48
    assert sum(s == "bwd" for s, _ in launches) == 46
