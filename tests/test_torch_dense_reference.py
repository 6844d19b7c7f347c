"""The port's MegaCRN on its learned dense graph (``graph_backend="dense"``,
``dense_impl`` ``recursive`` and ``stacked``) held to the benchmark's plain
reference, ``portbench/reference/megacrn.py``, which builds the meta-graph
and the Chebyshev polynomial matrices itself where the port applies the
recursion to the features. The EXPY-TKY protocol of the benchmark's
``megacrn-expytky-dense`` configuration (xavier-uniform weights, L1 on the
normalized scale, no clip, ``lamb1`` 0, the ``weekday_time`` covariate's
decoder input) at a CI size; both sides get the same weights, batches and
scheduled-sampling coins. Also the spans that the dense forward records.

Tolerances, relative to the largest element of the reference's tensor:
- float32, 1e-4: the two sides sum the same products in another order
  (the port's ``A @ (A @ x)`` against the reference's ``(A @ A) @ x``,
  other matmul shapes), which moves a result by some hundreds of float32
  roundings (1.2e-7 each) and no more;
- float64, 1e-9: the same reorderings at 2.2e-16 a rounding; a float32
  product anywhere on either side would miss it by orders of magnitude.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.train import telemetry as tele
from megacrn_tpu_torch.train.optim import make_optimizer
from megacrn_tpu_torch.train.steps import make_train_step
from portbench.harness import data, weights
from portbench.reference import megacrn as ref

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
RTOL = {torch.float32: 1e-4, torch.float64: 1e-9}
DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64"}
IMPLS = ("recursive", "stacked")
BATCH = 4


def _config(impl, dtype=torch.float32, name="megacrn-expytky-dense"):
    config = json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                        .read_text())
    config["model"].update(num_nodes=37, rnn_units=8, mem_num=4, mem_dim=8,
                           seq_len=3, horizon=3, dense_impl=impl,
                           compute_dtype=DTYPE_NAMES[dtype])
    config["train"]["batch_size"] = BATCH
    return config


def _setup(impl, dtype, seed=5):
    config = _config(impl, dtype)
    m = config["model"]
    init = {k: v.to(dtype) for k, v in weights.make(config, seed,
                                                    CPU).items()}
    rs = np.random.RandomState(seed)
    n = m["num_nodes"]
    x = rs.randn(BATCH, m["seq_len"], n, 1)
    y = rs.randn(BATCH, m["horizon"], n, 1)
    y[rs.rand(*y.shape) < 0.05] = 0.0
    cov = data.time_covariate(m["seq_len"] + m["horizon"], n,
                              config["data"]["interval_minutes"],
                              config["data"]["covariate"],
                              config["data"]["start_weekday"])
    yc = np.broadcast_to(cov[m["seq_len"]:, :, None],
                         (BATCH, m["horizon"], n, 1))
    x, y, yc = (torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
                for a in (x, y, yc))
    model = MegaCRN(MegaCRNConfig(**m), device=CPU, dtype=dtype)
    model.load_state_dict(init, strict=True)
    return config, m, init, model, x, y, yc


def _close(got, want, dtype):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= RTOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches_reference(impl, dtype):
    config, m, init, model, x, y, yc = _setup(impl, dtype)
    with torch.no_grad():
        got = model(x, yc)
        want = ref.forward(init, m, x, yc)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == dtype, name
        _close(g, w, dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("impl", IMPLS)
def test_three_train_steps_match_reference(impl, dtype):
    """Losses of 3 steps, the first step's gradient of every leaf (the
    meta-graph's ``We1``, ``We2`` and ``Memory`` among them, through both
    N x N softmaxes), and the parameters after the 3 steps."""
    config, m, init, model, x, y, yc = _setup(impl, dtype)
    train = config["train"]
    tcfg = TrainConfig(**train)
    opt = make_optimizer(model.parameters(), tcfg)
    step = make_train_step(model, tcfg, opt,
                           torch.Generator().manual_seed(9), 40.0, 12.0)
    batches = [(x + 0.5 * i, y, yc) for i in range(3)]
    losses, grad = [], None
    for i, b in enumerate(batches):
        losses.append(float(step(*b, i)))
        if grad is None:
            grad = {k: p.grad.clone() for k, p in model.named_parameters()}
    want = ref.train_steps(init, m, train, batches,
                           torch.Generator().manual_seed(9), None, 40.0,
                           12.0)
    np.testing.assert_allclose(losses, want["losses"], rtol=RTOL[dtype])
    assert set(grad) == set(want["grad"])
    for k in ("memory.We1", "memory.We2", "memory.Memory"):
        assert float(want["grad"][k].abs().max()) > 0, k
    for k, g in grad.items():
        _close(g, want["grad"][k], dtype)
    for k, p in model.named_parameters():
        _close(p.detach(), want["params"][k], dtype)


def _graph_spans():
    return [s for s in tele.spans() if s.name.startswith("graph.")]


@pytest.mark.parametrize("impl", IMPLS)
def test_dense_forward_records_meta_and_aggregate_spans(impl):
    """One ``graph.meta`` a forward and one ``graph.aggregate`` an
    aggregation (two a cell step), with the shapes of their products."""
    config, m, init, model, x, y, yc = _setup(impl, torch.float32)
    tele.clear()
    with torch.no_grad():
        model(x, yc)
    spans = _graph_spans()
    tele.clear()
    meta = [s for s in spans if s.name == "graph.meta"]
    agg = [s for s in spans if s.name == "graph.aggregate"]
    assert len(meta) + len(agg) == len(spans)
    n = m["num_nodes"]
    assert [s.counts for s in meta] == [{"nodes": n, "supports": 2,
                                         "dim": m["mem_dim"]}]
    steps = m["seq_len"] + m["horizon"]
    assert len(agg) == 2 * steps * m["num_layers"]
    h, dec = m["rnn_units"], m["rnn_units"] + m["mem_dim"]
    widths = ([BATCH * (m["input_dim"] + h), BATCH * h] * m["seq_len"]
              + [BATCH * (m["output_dim"] + m["ycov_dim"] + dec),
                 BATCH * dec] * m["horizon"])
    assert [s.counts for s in agg] == [
        {"nodes": n, "width": w, "supports": 2, "order": m["cheb_k"]}
        for w in widths]
    assert all(s.start_ns >= meta[0].end_ns for s in agg)


def test_road_forward_records_no_graph_span():
    config = _config("recursive", name="megacrn-expytky-road")
    m = config["model"]
    g = config["graph"]
    supports = data.dual_random_walk(data.road_adjacency(
        m["num_nodes"], g["avg_degree"], g["seed"]))
    pack = build_stacked_road_pack(list(supports), impl="reference")
    model = MegaCRN(MegaCRNConfig(**m), device=CPU)
    model.load_state_dict(weights.make(config, 5, CPU), strict=True)
    x = torch.randn(BATCH, m["seq_len"], m["num_nodes"], 1)
    yc = torch.rand(BATCH, m["horizon"], m["num_nodes"], 1)
    tele.clear()
    with torch.no_grad():
        model(x, yc, road_supports=pack)
    spans = _graph_spans()
    tele.clear()
    assert spans == []
