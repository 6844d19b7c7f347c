"""The port's training slice (megacrn_tpu_torch: scheduled sampling, the
composite loss, one train step, Adam + clip + MultiStepLR, eval metrics)
held against the JAX package on the CPU: the same numpy weights, batch and
teacher-forcing mask go to both sides."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megacrn_tpu import config as jconfig
from megacrn_tpu.kernels import spmm as jspmm
from megacrn_tpu.kernels.spmm_coo import \
    build_stacked_road_pack as jbuild_pack
from megacrn_tpu.models import megacrn as jmegacrn
from megacrn_tpu.train import optim as joptim
from megacrn_tpu.train import steps as jsteps
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch.data.synthetic import synthetic_road_adjacency
from megacrn_tpu_torch.interop import flat_from_state_dict, params_from_flat
from megacrn_tpu_torch.kernels.spmm import build_road_ell_pairs
from megacrn_tpu_torch.kernels.spmm_coo import build_stacked_road_pack
from megacrn_tpu_torch.models import megacrn as tmegacrn
from megacrn_tpu_torch.ops.graph import dual_random_walk_supports
from megacrn_tpu_torch.train import optim as toptim
from megacrn_tpu_torch.train import steps as tsteps

torch.set_num_threads(1)
N = 150  # two row-blocks per support
MEAN, STD = 40.0, 12.0
# Threshold ~0.45 at cl_decay_steps 2000: the mask mixes both kinds of step.
BATCHES_SEEN = 15000.0


def flat_of(tree):
    """A JAX params pytree in the flat ``a/0/b`` naming of its checkpoints."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _setup(seed=0, n=N, batch=4):
    kw = dict(num_nodes=n, rnn_units=8, mem_num=4, mem_dim=8, horizon=3,
              seq_len=3, graph_backend="road_sparse")
    sups = list(dual_random_walk_supports(
        synthetic_road_adjacency(n, avg_degree=8, seed=seed)))
    params = jmegacrn.init_params(jax.random.PRNGKey(seed),
                                  jconfig.MegaCRNConfig(**kw))
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 3, n, 1).astype(np.float32)
    y = rs.randn(batch, 3, n, 1).astype(np.float32)
    y[rs.rand(*y.shape) < 0.02] = 0.0  # missing readings
    yc = rs.randn(batch, 3, n, 1).astype(np.float32)
    return kw, sups, params, x, y, yc


def _jax_use_truth(cfg, rng, batches_seen):
    """The teacher-forcing mask exactly as megacrn_tpu/models/megacrn.py
    draws it inside its forward."""
    threshold = jmegacrn.compute_sampling_threshold(
        cfg.cl_decay_steps, jnp.asarray(batches_seen, jnp.float32))
    keys = jax.random.split(rng, cfg.horizon)
    coins = jax.vmap(lambda k: jax.random.uniform(k))(keys)
    return np.asarray(coins < threshold)


def _constants(kind, sups):
    """(JAX graph constant, port graph constant) of one kind."""
    if kind == "dense":
        return None, None
    if kind == "stacked_coo":
        return (jbuild_pack(sups, impl="pallas"),
                build_stacked_road_pack(sups))
    return ([(jspmm.to_block_ell(s), jspmm.transpose_block_ell(s))
             for s in sups], build_road_ell_pairs(sups))


@pytest.mark.parametrize("kind,dataset", [("stacked_coo", "METRLA"),
                                          ("block_ell", "EXPYTKY"),
                                          ("dense", "METRLA")])
def test_train_step_loss_and_grads_match_jax(kind, dataset, monkeypatch):
    """One step's loss and gradients from the same weights, batch and
    teacher-forcing mask, f32: only the summation order differs (rtol 1e-4,
    atol 1e-5 * max|g| per array)."""
    kw, sups, params, x, y, yc = _setup()
    if kind == "dense":
        kw = dict(kw, graph_backend="dense")
    jcfg = jconfig.MegaCRNConfig(**kw)
    jtrain = jconfig.train_config_for(dataset)
    jsup, tsup = _constants(kind, sups)
    rng = jax.random.PRNGKey(7)
    use_truth = _jax_use_truth(jcfg, rng, BATCHES_SEEN)
    assert 0 < use_truth.sum() < len(use_truth)  # both kinds of step

    def jloss(p):
        out = jmegacrn.forward(p, jnp.asarray(x), jnp.asarray(yc), jcfg,
                               labels=jnp.asarray(y),
                               batches_seen=BATCHES_SEEN, rng=rng,
                               training=True, road_supports=jsup)
        return jsteps.composite_loss(out, jnp.asarray(y), jtrain, MEAN, STD)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want_grads = flat_of(want_grads)

    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat_of(params), cfg))
    seen = []

    def mask(threshold, horizon, generator):
        seen.append(threshold)
        return torch.tensor(use_truth)

    monkeypatch.setattr(tmegacrn, "sampling_mask", mask)
    loss_fn = tsteps.make_loss_fn(model, tconfig.train_config_for(dataset),
                                  MEAN, STD, road_supports=tsup)
    loss = loss_fn(torch.from_numpy(x), torch.from_numpy(y),
                   torch.from_numpy(yc), BATCHES_SEEN, torch.Generator())
    loss.backward()
    want_threshold = float(jmegacrn.compute_sampling_threshold(
        2000, jnp.float32(BATCHES_SEEN)))
    np.testing.assert_allclose(seen, [want_threshold], rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    # road_sparse bypasses the meta-graph: We1/We2 get no gradient there
    # (zeros on the JAX side).
    got = flat_from_state_dict(
        {k: torch.zeros_like(p) if p.grad is None else p.grad
         for k, p in model.named_parameters()}, cfg.num_layers)
    assert set(got) == set(want_grads)
    for k, g in got.items():
        w = want_grads[k]
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_float64_dense_train_step_matches_jax(monkeypatch):
    """The same step in double on the dense branch: loss and gradients to
    <= 1e-9 (the sparse JAX paths accumulate in f32, so only dense can be
    held this close). x64 is scoped to this test with ``jax.enable_x64``."""
    kw, _, _, x, y, yc = _setup(n=40)
    kw = dict(kw, graph_backend="dense", compute_dtype="float64")
    x64, y64, yc64 = (a.astype(np.float64) for a in (x, y, yc))
    with jax.enable_x64(True):
        jcfg = jconfig.MegaCRNConfig(**kw)
        params = jmegacrn.init_params(jax.random.PRNGKey(3), jcfg,
                                      dtype=jnp.float64)
        rng = jax.random.PRNGKey(7)
        use_truth = _jax_use_truth(jcfg, rng, BATCHES_SEEN)
        jtrain = jconfig.train_config_for("METRLA")

        def jloss(p):
            out = jmegacrn.forward(p, jnp.asarray(x64), jnp.asarray(yc64),
                                   jcfg, labels=jnp.asarray(y64),
                                   batches_seen=BATCHES_SEEN, rng=rng,
                                   training=True)
            return jsteps.composite_loss(out, jnp.asarray(y64), jtrain, MEAN,
                                         STD)

        want_loss, want_grads = jax.value_and_grad(jloss)(params)
        want_loss, want_grads = float(want_loss), flat_of(want_grads)
    assert not jax.config.jax_enable_x64
    assert want_grads["proj/W"].dtype == np.float64
    assert 0 < use_truth.sum() < len(use_truth)

    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu", dtype=torch.float64)
    model.load_state_dict(params_from_flat(flat_of(params), cfg,
                                           dtype=torch.float64))
    monkeypatch.setattr(tmegacrn, "sampling_mask",
                        lambda *a: torch.tensor(use_truth))
    loss = tsteps.make_loss_fn(model, tconfig.train_config_for("METRLA"),
                               MEAN, STD)(
        torch.from_numpy(x64), torch.from_numpy(y64),
        torch.from_numpy(yc64), BATCHES_SEEN, torch.Generator())
    loss.backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-9)
    got = flat_from_state_dict({k: p.grad for k, p in
                                model.named_parameters()}, cfg.num_layers)
    for k, g in got.items():
        w = want_grads[k]
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)


def test_block_ell_forward_matches_jax():
    kw, sups, params, x, _, yc = _setup(seed=1)
    jsup, tsup = _constants("block_ell", sups)
    want = jmegacrn.forward(params, x, yc, jconfig.MegaCRNConfig(**kw),
                            road_supports=jsup)
    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat_of(params), cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(yc),
                    road_supports=tsup)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("bad", ["count", "kind"])
def test_road_supports_that_do_not_fit_raise(bad):
    kw, sups, *_ = _setup(n=20)
    pairs = build_road_ell_pairs(sups)
    model = tmegacrn.MegaCRN(tconfig.MegaCRNConfig(**kw), device="cpu")
    x = torch.zeros(1, 3, 20, 1)
    if bad == "count":
        with pytest.raises(ValueError, match="num_supports"):
            model(x, x, road_supports=pairs[:1])
    else:
        with pytest.raises(TypeError, match="not a road_sparse graph "
                                            "constant"):
            model(x, x, road_supports=[object()])


def test_curriculum_forward_needs_labels_and_generator():
    kw, sups, *_ = _setup(n=20)
    model = tmegacrn.MegaCRN(tconfig.MegaCRNConfig(**kw), device="cpu")
    x = torch.zeros(1, 3, 20, 1)
    with pytest.raises(ValueError, match="labels and generator"):
        model(x, x, road_supports=build_stacked_road_pack(sups),
              training=True)


@pytest.mark.parametrize("batches_seen", [0.0, 1500.0, 15000.0])
def test_sampling_threshold_matches_jax(batches_seen):
    want = float(jmegacrn.compute_sampling_threshold(
        2000, jnp.float32(batches_seen)))
    got = tmegacrn.compute_sampling_threshold(2000, batches_seen)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_teacher_forcing_rate_matches_threshold():
    """Distributional parity, as tests/test_model.py holds the JAX draws:
    the port's coins feed the label at the threshold's rate (~3 sigma at
    n = 2000), and the same generator seed gives the same mask."""
    thr = tmegacrn.compute_sampling_threshold(2000, 1500.0)
    mask = tmegacrn.sampling_mask(thr, 2000,
                                  torch.Generator().manual_seed(0))
    assert mask.dtype == torch.bool and mask.shape == (2000,)
    assert abs(mask.float().mean().item() - thr) < 0.03
    again = tmegacrn.sampling_mask(thr, 2000,
                                   torch.Generator().manual_seed(0))
    assert torch.equal(mask, again)


def test_curriculum_off_or_eval_is_deterministic():
    """``training=False`` (and ``use_curriculum_learning=False``) draw no
    coins and feed back the model's own output."""
    kw, sups, params, x, y, yc = _setup(n=40)
    cfg = tconfig.MegaCRNConfig(**kw)
    model = tmegacrn.MegaCRN(cfg, device="cpu")
    args = (torch.from_numpy(x), torch.from_numpy(yc))
    sup = build_stacked_road_pack(sups)
    with torch.no_grad():
        base = model(*args, road_supports=sup).output
        off = tmegacrn.MegaCRN(dataclasses.replace(
            cfg, use_curriculum_learning=False), device="cpu")
        off.load_state_dict(model.state_dict())
        got = off(*args, road_supports=sup, labels=torch.from_numpy(y),
                  batches_seen=0, generator=torch.Generator(),
                  training=True).output
    torch.testing.assert_close(got, base, rtol=0, atol=0)


def _grads_like(params, rs, scale):
    return {k: (scale * rs.randn(*np.shape(v))).astype(np.float32)
            for k, v in flat_of(params).items()}


@pytest.mark.parametrize("dataset,scale", [("METRLA", 10.0),
                                           ("METRLA", 0.01),
                                           ("EXPYTKY", 10.0)])
def test_adam_and_clip_match_jax_optimizer(dataset, scale):
    """Two optimizer steps from the same weights and gradients: torch's
    Adam(eps) after clip_grad_norm_ against the JAX chain (its
    torch-semantics clip, +1e-6; EXPY-TKY does not clip and uses eps 1e-8).
    scale 10 clips, 0.01 does not."""
    kw, _, params, *_ = _setup(n=20)
    cfg = tconfig.MegaCRNConfig(**kw)
    jcfg = jconfig.train_config_for(dataset)
    rs = np.random.RandomState(3)
    grads = [_grads_like(params, rs, scale) for _ in range(2)]

    opt = joptim.make_optimizer(jcfg, steps_per_epoch=10)
    state = opt.init(params)
    jp = params
    treedef = jax.tree_util.tree_structure(params)
    keys = list(flat_of(params))
    for g in grads:
        gt = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(g[k])
                                                    for k in keys])
        upd, state = opt.update(gt, state, jp)
        jp = optax.apply_updates(jp, upd)
    want = flat_of(jp)

    model = tmegacrn.MegaCRN(cfg, device="cpu")
    model.load_state_dict(params_from_flat(flat_of(params), cfg))
    tcfg = tconfig.train_config_for(dataset)
    topt = toptim.make_optimizer(model.parameters(), tcfg)
    for g in grads:
        sd = params_from_flat(g, cfg)
        for name, p in model.named_parameters():
            p.grad = sd[name].clone()
        toptim.clip_gradients(model.parameters(), tcfg)
        topt.step()
    got = flat_from_state_dict(model.state_dict(), cfg.num_layers)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_multistep_lr_boundaries_match_jax_schedule():
    """MultiStepLR stepped per epoch gives the JAX schedule's learning rate
    at every optimizer step (steps_per_epoch 3, milestones 2 and 4)."""
    cfg = tconfig.TrainConfig(lr=0.01, lr_milestones=(2, 4),
                              lr_decay_ratio=0.1)
    sched = joptim.lr_schedule(jconfig.TrainConfig(
        lr=0.01, lr_milestones=(2, 4), lr_decay_ratio=0.1), 3)
    w = torch.nn.Parameter(torch.zeros(1))
    opt = toptim.make_optimizer([w], cfg)
    lr_sched = toptim.make_lr_scheduler(opt, cfg)
    for epoch in range(6):
        for i in range(3):
            np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                       float(sched(3 * epoch + i)),
                                       rtol=1e-6)
        opt.step()
        lr_sched.step()


@pytest.mark.parametrize("dataset", ["METRLA", "EXPYTKY", "PEMSBAY",
                                     "EXPYTKY_ALL"])
def test_train_config_presets_match_jax(dataset):
    """Every preset's TrainConfig, DatasetConfig and model config equal the
    JAX package's (the model config on the fields the port has)."""
    got = dataclasses.asdict(tconfig.train_config_for(dataset))
    want = dataclasses.asdict(jconfig.train_config_for(dataset))
    assert got == want
    assert (dataclasses.asdict(tconfig.DATASETS[dataset])
            == dataclasses.asdict(jconfig.DATASETS[dataset]))
    got = dataclasses.asdict(tconfig.model_config_for(dataset))
    want = dataclasses.asdict(jconfig.model_config_for(dataset))
    assert got == {k: want[k] for k in got}
    m = tconfig.MegaCRNConfig()
    assert (m.cl_decay_steps, m.use_curriculum_learning) == (2000, True)


def test_eval_metrics_and_summary_match_jax():
    """eval_metrics on the same forward output, horizon 3 (so only step
    3), and summarize_eval over two batches."""
    rs = np.random.RandomState(4)
    kw = dict(horizon=3, n=12)
    outs = []
    for _ in range(2):
        arrs = [rs.randn(2, kw["horizon"], kw["n"], 1).astype(np.float32)]
        arrs += [rs.randn(2, kw["n"], 8).astype(np.float32)
                 for _ in range(4)]
        y = rs.randn(2, kw["horizon"], kw["n"], 1).astype(np.float32)
        y[rs.rand(*y.shape) < 0.1] = (0.0 - MEAN) / STD  # missing -> 0 raw
        outs.append((arrs, y))
    jtrain = jconfig.train_config_for("METRLA")
    ttrain = tconfig.train_config_for("METRLA")
    want, got = [], []
    for arrs, y in outs:
        want.append(jsteps.eval_metrics(
            jmegacrn.MegaCRNOutput(*map(jnp.asarray, arrs)), jnp.asarray(y),
            jtrain, MEAN, STD, (3,)))
        got.append(tsteps.eval_metrics(
            tmegacrn.MegaCRNOutput(*map(torch.from_numpy, arrs)),
            torch.from_numpy(y), ttrain, MEAN, STD, (3,)))
        assert set(got[-1]) == set(want[-1])
        for k in want[-1]:
            np.testing.assert_allclose(float(got[-1][k]), float(want[-1][k]),
                                       rtol=1e-5, err_msg=k)
    s_got = tsteps.summarize_eval(got, 3)
    s_want = jsteps.summarize_eval(want, 3)
    assert set(s_got) == set(s_want)
    for k in s_want:
        np.testing.assert_allclose(s_got[k], s_want[k], rtol=1e-5)


def test_train_step_runs_the_optimizer_and_lowers_the_loss():
    """make_train_step: forward, backward, clip, Adam; the same batch's
    loss falls over a few steps, on both graph constants."""
    kw, sups, params, x, y, yc = _setup(n=40)
    cfg = tconfig.MegaCRNConfig(**kw)
    tcfg = tconfig.train_config_for("METRLA", lr=0.01)
    for sup in (build_stacked_road_pack(sups), build_road_ell_pairs(sups)):
        model = tmegacrn.MegaCRN(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        step = tsteps.make_train_step(
            model, tcfg, toptim.make_optimizer(model.parameters(), tcfg),
            torch.Generator().manual_seed(0), MEAN, STD, road_supports=sup)
        batch = [torch.from_numpy(a) for a in (x, y, yc)]
        losses = [step(*batch, float(i)).item() for i in range(5)]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0]
