"""The nonzero list both SpMM kernels read (``nz_row_ptr``, ``nz_cols``,
``nz_vals``; megacrn_tpu_torch/kernels/row_spmm.py), on both pack kinds
(block-COO, block-ELL) and their transposes: it rebuilds the padded matrix
exactly, is a well-formed CSR, holds nothing of the padding, moves and
casts as the tiles do, and a plain gather over it (the function the CUDA
kernels compute) matches the JAX package's ``spmm`` and ``spmm_coo`` (Pallas
kernels in interpret mode on the CPU)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megacrn_tpu.kernels import spmm as jell
from megacrn_tpu.kernels import spmm_coo as jcoo
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels import spmm as tell
from megacrn_tpu_torch.kernels import spmm_coo as tcoo
from megacrn_tpu_torch.kernels.row_spmm import BLOCK
from megacrn_tpu_torch.ops import graph as tgraph

torch.set_num_threads(1)


def _sparse(rs, r, c, density=0.04):
    return ((rs.rand(r, c) < density) * rs.randn(r, c)).astype(np.float32)


def _stacked(n=150):
    """diag(A_1, A_2) of the dual random-walk supports of a synthetic road
    graph, each padded to a BLOCK multiple, as ``build_stacked_road_pack``
    lays it out; and the supports."""
    sups = [np.asarray(s, np.float32)
            for s in tgraph.dual_random_walk_supports(
                synthetic_road_adjacency(n, avg_degree=5, seed=4))]
    n_pad = -(-n // BLOCK) * BLOCK
    big = np.zeros((2 * n_pad, 2 * n_pad), np.float32)
    for i, s in enumerate(sups):
        big[i * n_pad:i * n_pad + n, i * n_pad:i * n_pad + n] = s
    return big, sups


def _case(name):
    """(a, f): the four cases of tests/test_torch_spmm.py (same seeds), a
    row and a column of over 100 nonzeros (so the pack and its transpose
    each have a row longer than three 32-entry chunks), and the stacked
    pack's matrix of a 150-node synthetic road graph."""
    if name == "stacked150":
        return _stacked()[0], 6
    rs = np.random.RandomState({"square": 1, "rectangular": 2, "hub": 3,
                                "empty_row_block": 0, "long_row": 4}[name])
    if name == "rectangular":
        return _sparse(rs, 96, 384), 7
    if name == "hub":
        a = np.zeros((300, 300), np.float32)
        a[:128] = _sparse(rs, 128, 300, 0.05)
        a[200:, 200:] = _sparse(rs, 100, 100, 0.05)
        return a, 19
    a = _sparse(rs, 300, 300)
    if name == "empty_row_block":
        a[128:256] = 0.0
    if name == "long_row":
        a[5, rs.choice(300, 120, replace=False)] = rs.randn(120)
        a[rs.choice(300, 110, replace=False), 7] = rs.randn(110)
        return a, 40
    return a, 6


CASES = ["square", "rectangular", "hub", "empty_row_block", "long_row",
         "stacked150"]
BUILDERS = {("block_coo", False): tcoo.to_block_coo,
            ("block_coo", True): tcoo.transpose_block_coo,
            ("block_ell", False): tell.to_block_ell,
            ("block_ell", True): tell.transpose_block_ell}
PACKS = pytest.mark.parametrize("kind,transposed", list(BUILDERS))


def _pack(name, kind, transposed):
    """(pack, the matrix it holds, f) of one case."""
    a, f = _case(name)
    return (BUILDERS[kind, transposed](a),
            np.ascontiguousarray(a.T) if transposed else a, f)


def _dense_of_nonzeros(pack):
    """The (n, col_dim) padded matrix the nonzero list holds."""
    rp = pack.nz_row_ptr.numpy()
    rows = np.repeat(np.arange(pack.n), np.diff(rp))
    d = np.zeros((pack.n, pack.col_dim), pack.nz_vals.numpy().dtype)
    d[rows, pack.nz_cols.numpy()] = pack.nz_vals.numpy()
    assert len(set(zip(rows, pack.nz_cols.numpy()))) == len(rows)  # no dup
    return d


@pytest.mark.parametrize("name", CASES)
@PACKS
def test_nonzeros_rebuild_padded_matrix(name, kind, transposed):
    pack, m, _ = _pack(name, kind, transposed)
    want = np.zeros((pack.n, pack.col_dim), np.float32)
    want[:m.shape[0], :m.shape[1]] = m
    np.testing.assert_array_equal(_dense_of_nonzeros(pack), want)


@pytest.mark.parametrize("name", CASES)
@PACKS
def test_nonzero_list_is_well_formed(name, kind, transposed):
    """int32 indices, columns in range and ascending within a row, a
    monotone row pointer from 0 to nnz, no entry in a padded row, only
    entries != 0, and for block-ELL only entries of real tiles."""
    pack, m, _ = _pack(name, kind, transposed)
    rp, cols = pack.nz_row_ptr.numpy(), pack.nz_cols.numpy()
    vals = pack.nz_vals.numpy()
    assert pack.nz_row_ptr.dtype == pack.nz_cols.dtype == torch.int32
    assert pack.nz_vals.dtype == pack.data.dtype == torch.float32
    assert rp.shape == (pack.n + 1,) and vals.shape == cols.shape
    assert rp[0] == 0 and rp[-1] == len(cols) == np.count_nonzero(m)
    assert (np.diff(rp) >= 0).all()
    assert cols.size == 0 or (cols.min() >= 0
                              and cols.max() < pack.col_dim_orig)
    assert (vals != 0).all()
    assert rp[pack.n_orig] == rp[-1]  # padded rows hold no entry
    rows = np.repeat(np.arange(pack.n), np.diff(rp))
    for r in range(pack.n):
        assert (np.diff(cols[rp[r]:rp[r + 1]]) > 0).all()
    if kind == "block_ell":
        nnz, tile_cols = pack.nnz_blocks.numpy(), pack.cols.numpy()
        for i, c in zip(rows // BLOCK, cols // BLOCK):
            assert c in tile_cols[i, :nnz[i]]  # never a padding tile
        if name == "hub" and not transposed:
            assert nnz.min() < tile_cols.shape[1]  # the case has padding
        if name == "empty_row_block" and not transposed:
            assert nnz[1] == 0 and rp[2 * BLOCK] == rp[BLOCK]
    if name == "long_row":
        assert np.diff(rp).max() >= 100


def _gather(pack, x):
    """y = A @ x over the nonzero list alone, plain torch: index_add_ of
    val * x[col] into each entry's row (the function the kernels
    compute)."""
    rows = torch.repeat_interleave(
        torch.arange(pack.n), torch.diff(pack.nz_row_ptr).long())
    y = torch.zeros((pack.n, x.shape[1]), dtype=torch.float32)
    y.index_add_(0, rows, pack.nz_vals[:, None] * x[pack.nz_cols.long()])
    return y[:pack.n_orig]


def _jax_spmm(kind, m, x):
    if kind == "block_ell":
        return jell.spmm(jell.to_block_ell(m), jell.transpose_block_ell(m),
                         jnp.asarray(x))
    return jcoo.spmm_coo(jcoo.to_block_coo(m), jcoo.transpose_block_coo(m),
                         jnp.asarray(x))


@pytest.mark.parametrize("name", CASES)
@PACKS
def test_gather_over_nonzeros_matches_jax(name, kind, transposed):
    pack, m, f = _pack(name, kind, transposed)
    x = np.random.RandomState(7).randn(m.shape[1], f).astype(np.float32)
    got = _gather(pack, torch.from_numpy(x)).numpy()
    want = np.asarray(_jax_spmm(kind, m, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, m @ x, rtol=1e-5, atol=1e-5)


def test_stacked_road_pack_carries_the_nonzeros_of_its_matrix():
    """``build_stacked_road_pack`` hands both packs their nonzero lists: the
    padded nodes of each support (rows 150..255 of each 256-row slice) hold
    no entry, and the gather over ``pack`` and ``pack_t`` matches the JAX
    stacked pack's ``spmm_coo``."""
    big, sups = _stacked()
    built = tcoo.build_stacked_road_pack(sups)
    jpack = jcoo.build_stacked_road_pack(sups, impl="pallas")
    x = np.random.RandomState(8).randn(big.shape[0], 6).astype(np.float32)
    for pack, m, (ja, ja_t) in ((built.pack, big, (jpack.pack, jpack.pack_t)),
                                (built.pack_t, big.T,
                                 (jpack.pack_t, jpack.pack))):
        ref = tcoo.to_block_coo(np.ascontiguousarray(m))
        for field in ("nz_row_ptr", "nz_cols", "nz_vals"):
            np.testing.assert_array_equal(getattr(pack, field).numpy(),
                                          getattr(ref, field).numpy())
        counts = np.diff(pack.nz_row_ptr.numpy())
        for s in range(built.num_supports):
            assert counts[s * built.n_pad + 150:(s + 1) * built.n_pad].sum() \
                == 0
        np.testing.assert_allclose(
            _gather(pack, torch.from_numpy(x)).numpy(),
            np.asarray(jcoo.spmm_coo(ja, ja_t, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["block_coo", "block_ell"])
def test_to_bfloat16_casts_only_nz_vals(kind):
    m, _ = _case("hub")
    pack = BUILDERS[kind, False](m)
    moved = pack.to("cpu", torch.bfloat16)
    assert moved.nz_vals.dtype == moved.data.dtype == torch.bfloat16
    assert moved.nz_row_ptr.dtype == moved.nz_cols.dtype == torch.int32
    assert moved.nz_row_ptr is pack.nz_row_ptr  # already there: not copied
    assert moved.nz_cols is pack.nz_cols
    torch.testing.assert_close(moved.nz_vals,
                               pack.nz_vals.to(torch.bfloat16), rtol=0,
                               atol=0)
    # The same values the plain version reads from the cast tiles.
    np.testing.assert_array_equal(
        _dense_of_nonzeros(moved._replace(nz_vals=moved.nz_vals.float())),
        _dense_of_nonzeros(pack._replace(
            nz_vals=pack.nz_vals.to(torch.bfloat16).float())))


@pytest.mark.parametrize("kind", ["block_coo", "block_ell"])
def test_launch_rejects_a_malformed_nonzero_list(kind):
    """The CUDA launch checks the nonzero list before it builds anything:
    a wrong index dtype, a wrong nz_vals dtype, a short row pointer, a
    missing list or an x of the wrong shape raise (checked here on the meta device, which the wrapper
    never sends to the plain version)."""
    from megacrn_tpu_torch.kernels import row_spmm

    m, f = _case("hub")
    pack = BUILDERS[kind, False](m).to("meta")
    x = torch.empty((m.shape[1], f), device="meta")
    name = "spmm_coo" if kind == "block_coo" else "spmm_ell"
    for bad, err in (({"nz_cols": pack.nz_cols.long()}, TypeError),
                     ({"nz_vals": pack.nz_vals.double()}, TypeError),
                     ({"nz_row_ptr": pack.nz_row_ptr[:-1]}, ValueError),
                     ({"nz_vals": None}, ValueError),
                     ({"nz_cols": torch.empty_like(pack.nz_cols,
                                                   device="cpu")},
                      ValueError)):
        with pytest.raises(err):
            row_spmm.launch(name, pack._replace(**bad), x)
    for bad_x in (x[:-1], x[:, 0], x[None]):
        with pytest.raises(ValueError, match="the pack expects"):
            row_spmm.launch(name, pack, bad_x)
