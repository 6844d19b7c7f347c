"""``Predictor``'s CUDA graphs on a CUDA card, held against eager forwards
of the predictor's own model on the same uploaded chunks. Imports no JAX,
so it runs on the machine with the card:

    python -m pytest --noconftest tests/test_torch_serve_graph_card.py -q

With no card it skips (decided inside the test, never at import)."""
import numpy as np
import pytest
import torch

from megacrn_tpu_torch import serve
from megacrn_tpu_torch.config import MegaCRNConfig
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.kernels.spmm_coo import (build_stacked_road_pack,
                                                spmm_coo)
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.train import telemetry as tele

N = 300
MEAN, STD = 45.0, 15.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tele.clear()


def _predictor(backend="road_sparse", impl="kernel"):
    """A Predictor at the EXPY-TKY widths on a 300-node road graph."""
    cfg = MegaCRNConfig(num_nodes=N, rnn_units=32, mem_num=10, mem_dim=32,
                        horizon=6, seq_len=6, graph_backend=backend)
    pack = None
    if backend == "road_sparse":
        pack = build_stacked_road_pack(list(dual_random_walk_supports(
            synthetic_road_adjacency(N, avg_degree=8, seed=1))), impl=impl)
    model = MegaCRN(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
    return serve.Predictor(model, cfg, MEAN, STD, 64, road_supports=pack,
                           device="cuda")


def _request(b, seed):
    """Raw speeds in [0, 70] with ~2% missing readings, and covariates."""
    rs = np.random.RandomState(seed)
    x = (rs.rand(b, 6, N, 1) * 70).astype(np.float32)
    x[rs.rand(*x.shape) < 0.02] = 0.0
    return x, rs.rand(b, 6, N, 1).astype(np.float32)


def _eager(pred, x, y_cov):
    """The predictor's own model, eagerly, on the chunk as uploaded."""
    with torch.inference_mode():
        xt, yt = serve._upload(pred.device, pred.mean, pred.std, x, y_cov)
        out = pred.model(xt[..., :pred.cfg.input_dim], yt,
                         road_supports=pred.road_supports)
        return serve._copy_back(out.output, pred.std, pred.mean)


def _spans(name):
    return [s for s in tele.spans() if s.name == name]


def test_road_graphs_replay_the_eager_forward_bit_for_bit():
    """Chunk sizes 1, 48 and 64, three requests each: the first runs
    eagerly and captures, the next two replay; every forecast equals the
    eager forward's, and each replay counts the launches the capture
    counted, which are the eager forward's."""
    _card()
    pred = _predictor()
    graphed = []
    for b in (1, 48, 64):
        for seed in range(3):
            x, y_cov = _request(b, 100 * b + seed)
            before = spmm_coo.launches
            got = pred.predict(x, y_cov)
            launched = spmm_coo.launches - before
            want = _eager(pred, x, y_cov)
            eager_launches = spmm_coo.launches - before - launched
            assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
            assert launched == eager_launches > 0
            if seed:
                assert launched == pred._graphs[b].launches
            graphed.append(_spans("serve.forward")[-1].counts["graphed"])
    assert graphed == [0, 1, 1] * 3
    assert sorted(pred._graphs) == [1, 48, 64]
    assert [s.counts for s in _spans("serve.capture")] == [
        {"windows": 1}, {"windows": 48}, {"windows": 64}]
    # A request of 112 windows: a 64-window and a 48-window replay.
    x, y_cov = _request(112, 7)
    got = pred.predict(x, y_cov)
    want = np.concatenate([_eager(pred, x[:64], y_cov[:64]),
                           _eager(pred, x[64:], y_cov[64:])])
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    assert len(_spans("serve.capture")) == 3


def test_stream_replays_each_push_s_own_window():
    """12 pushes with covariates: every forecast is the eager forecast of
    that push's own window and covariates, so the static inputs are
    refreshed on every replay."""
    _card()
    pred = _predictor()
    rs = np.random.RandomState(3)
    cov = rs.rand(40, 6, N, 1).astype(np.float32)
    stream = serve.StreamingForecaster(pred, cov_fn=lambda t: cov[t])
    obs = (rs.rand(12, N) * 70).astype(np.float32)
    forecasts = 0
    for t in range(12):
        got = stream.push(obs[t])
        if t < 5:  # seq_len 6: 5 warming pushes
            assert got is None
            continue
        x = obs[t - 5:t + 1][None, :, :, None]
        want = _eager(pred, x, cov[t + 1][None])[0]
        assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
        forecasts += 1
    assert forecasts == 7
    assert [s.counts["graphed"] for s in _spans("serve.forward")] == [
        0] + [1] * 6
    assert len(_spans("serve.capture")) == 1


@pytest.mark.parametrize("backend,impl", [("dense", None),
                                          ("road_sparse", "reference")])
def test_other_backends_stay_eager(backend, impl):
    """The dense backend (whose forward records spans) and the pack's
    plain impl capture nothing and run every chunk eagerly."""
    _card()
    pred = _predictor(backend, impl)
    for seed in range(2):
        x, y_cov = _request(2, seed)
        got = pred.predict(x, y_cov)
        np.testing.assert_allclose(got, _eager(pred, x, y_cov), rtol=1e-5,
                                   atol=1e-5 * STD)
    assert pred._graphs is None and not _spans("serve.capture")
    assert [s.counts["graphed"] for s in _spans("serve.forward")] == [0, 0]
