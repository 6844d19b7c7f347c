"""The benchmark's plain reference held to the program, megacrn_tpu_torch,
at a tiny size on the CPU: the forward on both graphs, three train steps
(composite loss, gradient, Adam, the clip), and the served forecasts. Both
sides get the same weights, batches and coins; float32, so the tolerances
are a few hundred float32 roundings of the outputs' scale."""
import numpy as np
import pytest
import torch

from conftest import tiny_config_file
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.config import MegaCRNConfig, TrainConfig
from megacrn_tpu_torch.serve import Predictor
from megacrn_tpu_torch.train.optim import make_optimizer
from megacrn_tpu_torch.train.steps import make_train_step
from portbench.harness import data, weights
from portbench.reference import megacrn as ref

CPU = torch.device("cpu")
# The road configuration of the cells, and the paper's METR-LA model on its
# learned dense graph (no cell yet: PERF.md, Open questions).
CONFIGS = ("megacrn-expytky-road", "megacrn-metrla-dense")


def _setup(name, seed=5, batch=8):
    config = tiny_config_file(name)
    m = config["model"]
    init = weights.make(config, seed, CPU)
    sup = data.graph_supports(config)
    pack = None if sup is None else build_stacked_road_pack(list(sup))
    sup_t = None if sup is None else torch.from_numpy(sup)
    rs = np.random.RandomState(seed)
    n = m["num_nodes"]
    x = torch.from_numpy(rs.randn(batch, m["seq_len"], n, 1)
                         .astype(np.float32))
    y = rs.randn(batch, m["horizon"], n, 1).astype(np.float32)
    y[rs.rand(*y.shape) < 0.05] = 0.0
    yc = torch.from_numpy(rs.rand(batch, m["horizon"], n, 1)
                          .astype(np.float32))
    return config, m, init, pack, sup_t, x, torch.from_numpy(y), yc


def _close(a, b, rtol=1e-4):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rtol * scale, (
        float((a - b).abs().max()), scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_program(name):
    config, m, init, pack, sup_t, x, y, yc = _setup(name)
    model = MegaCRN(MegaCRNConfig(**m), device=CPU)
    model.load_state_dict(init)
    with torch.no_grad():
        got = model(x, yc, road_supports=pack)
        want = ref.forward(init, m, x, yc, sup_t)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", CONFIGS)
def test_three_train_steps_match_program(name):
    config, m, init, pack, sup_t, x, y, yc = _setup(name)
    train = config["train"]
    model = MegaCRN(MegaCRNConfig(**m), device=CPU)
    model.load_state_dict(init)
    tcfg = TrainConfig(**train)
    opt = make_optimizer(model.parameters(), tcfg)
    step = make_train_step(model, tcfg, opt,
                           torch.Generator().manual_seed(9), 40.0, 12.0,
                           road_supports=pack)
    batches = [(x + i, y, yc) for i in range(3)]
    losses = [float(step(*b, i)) for i, b in enumerate(batches)]
    want = ref.train_steps(init, m, train, batches,
                           torch.Generator().manual_seed(9), sup_t, 40.0,
                           12.0)
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    for k, p in model.named_parameters():
        _close(p.detach() - init[k], want["params"][k] - init[k], 1e-3)


def test_served_forecasts_match_program():
    config, m, init, pack, sup_t, x, y, yc = _setup("megacrn-expytky-road")
    raw = 40.0 + 12.0 * x
    raw[0, 0, :3] = 0.0  # missing readings
    model = MegaCRN(MegaCRNConfig(**m), device=CPU)
    model.load_state_dict(init)
    got = Predictor(model, MegaCRNConfig(**m), 40.0, 12.0, max_batch=3,
                    road_supports=pack, device=CPU).predict(raw.numpy(),
                                                            yc.numpy())
    want = ref.predict(init, m, raw, yc, 40.0, 12.0, sup_t, block=5)
    _close(torch.from_numpy(got), want)


def test_clip_scales_the_gradient_as_torch_does():
    config, m, init, pack, sup_t, x, y, yc = _setup("megacrn-metrla-dense")
    train = dict(config["train"], max_grad_norm=1e-3)
    out = ref.train_steps(init, m, train, [(x, y, yc)],
                          torch.Generator().manual_seed(1), None, 40.0, 12.0)
    total = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in out["grad"].values()
         if g is not None]))
    assert abs(float(total) - 1e-3) < 1e-8
