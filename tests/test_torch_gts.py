"""The port's GTS (megacrn_tpu_torch.models.gts, nn/dcgru.py, nn/norm.py,
data/graph_prior.py and the train step of train/gts_loop.py) held against
the committed reference golden and the JAX package on the CPU: the same
numpy weights, BatchNorm state, batch, Gumbel uniforms and coins go to
both sides."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megacrn_tpu import config as jconfig
from megacrn_tpu.data.graph_prior import cosine_knn_graph as jknn
from megacrn_tpu.models import gts as jgts
from megacrn_tpu.nn import dcgru as jdcgru
from megacrn_tpu.nn import norm as jnorm
from megacrn_tpu.ops.losses import masked_mae_loss
from megacrn_tpu.ops.scaling import inverse_transform
from megacrn_tpu.train import gts_loop as jloop
from megacrn_tpu.train.optim import clip_by_global_norm_torch
from megacrn_tpu_torch import config as tconfig
from megacrn_tpu_torch.data.graph_prior import cosine_knn_graph
from megacrn_tpu_torch.interop import (flat_from_gts_state_dict,
                                       gts_params_from_flat)
from megacrn_tpu_torch.models import gts as tgts
from megacrn_tpu_torch.nn import dcgru, norm
from megacrn_tpu_torch.train import gts_loop as tloop

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "gts_small.npz")
MEAN, STD = 40.0, 12.0


def flat_of(tree):
    """A JAX pytree in the flat ``a/0/b`` naming of its checkpoints."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def unflat(flat):
    """The JAX params or BatchNorm-state pytree of a flat mapping."""
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    for mod in ("encoder", "decoder"):
        if mod in tree:
            tree[mod] = [tree[mod][str(i)] for i in range(len(tree[mod]))]
    return tree


def test_gts_matches_reference_golden():
    """gts_small.npz, Gumbel noise off and curriculum off, with
    tests/test_gts.py's tolerances (adj_prob atol 2e-5 rtol 1e-4, output
    atol 5e-5 rtol 1e-4)."""
    blob = dict(np.load(GOLDEN))
    (n, cin, cout, horizon, seq_len, units, layers, k, tlen) = (
        int(v) for v in blob["meta/config"])
    cfg = tconfig.GTSConfig(
        num_nodes=n, input_dim=cin, output_dim=cout, horizon=horizon,
        seq_len=seq_len, rnn_units=units, num_layers=layers,
        max_diffusion_step=k, train_series_len=tlen,
        use_curriculum_learning=False)
    model = tgts.GTS(cfg, device="cpu")
    model.load_state_dict(gts_params_from_flat(blob, blob, cfg))
    b = 2
    x = blob["in/x"].reshape(seq_len, b, n, cin).transpose(1, 0, 2, 3)
    with torch.no_grad():
        out = model(torch.from_numpy(np.ascontiguousarray(x)),
                    torch.from_numpy(blob["in/node_feas"]),
                    gumbel_noise=False)
    np.testing.assert_allclose(out.adj_prob.numpy(), blob["out/adj_prob"],
                               atol=2e-5, rtol=1e-4)
    want = blob["out/output"].reshape(horizon, b, n, cout).transpose(
        1, 0, 2, 3)
    np.testing.assert_allclose(out.output.numpy(), want, atol=5e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("shape", [(6, 5), (4, 3, 7)])
def test_bn_apply_matches_jax_train_and_eval(shape):
    """Train mode twice (the running stats after 2 updates: unbiased
    variance, momentum 0.1), then eval mode on the running stats."""
    rs = np.random.RandomState(1)
    c = shape[1]
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    _, js = jnorm.bn_init(c)
    bn = norm.bn_init(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    for training, seed in ((True, 2), (True, 3), (False, 4)):
        x = (np.random.RandomState(seed).randn(*shape) * 3 + 1).astype(
            np.float32)
        want, js = jnorm.bn_apply(jp, js, jnp.asarray(x), training)
        got = norm.bn_apply(bn, torch.from_numpy(x), training)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(js["mean"]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(js["var"]), rtol=1e-6)
    assert int(bn.num_batches_tracked) == 2


def test_random_walk_support_and_diffusion_stack_match_jax():
    """Including a row whose degree is 0 (1/0 -> 0) and the
    input-major, matrix-minor stack order."""
    rs = np.random.RandomState(0)
    adj = (rs.rand(7, 7) < 0.4).astype(np.float32)
    adj[3] = 0.0
    adj[3, 3] = -1.0  # A + I has an empty row 3
    got = dcgru.random_walk_support(torch.from_numpy(adj))
    want = jdcgru.random_walk_support(jnp.asarray(adj))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert np.all(got.numpy()[:, 3] == 0.0)
    x = rs.randn(2, 7, 3).astype(np.float32)
    for k in (0, 1, 3):
        s = got.numpy()
        stack = dcgru.diffusion_stack(got, torch.from_numpy(x), k)
        assert stack.shape == (2, 7, 3, k + 1)
        np.testing.assert_allclose(
            stack.numpy(), np.asarray(jdcgru.diffusion_stack(
                jnp.asarray(s), jnp.asarray(x), k)), rtol=1e-5, atol=1e-6)


def test_dcgru_cell_with_the_support_built_once_matches_jax():
    """The port builds the support once per forward and hands it to every
    cell step; the JAX cell rebuilds it from the adjacency each step. The
    same numbers, forward and gradient."""
    rs = np.random.RandomState(2)
    adj = (rs.rand(6, 6) < 0.5).astype(np.float32)
    p = jdcgru.dcgru_cell_init(jax.random.PRNGKey(0), 2, 5, 2)
    x = rs.randn(3, 4, 6, 2).astype(np.float32)

    def jrun(a):
        h = jnp.zeros((3, 6, 5))
        for t in range(4):
            h = jdcgru.dcgru_cell_apply(p, jnp.asarray(x[:, t]), h, a, 2)
        return h

    want = jrun(jnp.asarray(adj))
    want_g = jax.grad(lambda a: jrun(a).sum())(jnp.asarray(adj))
    cell = dcgru.DCGRUCell(2, 5, 2, torch.Generator())
    with torch.no_grad():
        for shape, sub in ((cell._gate, "gate"), (cell._cand, "candidate")):
            getattr(cell, f"gconv_weight_{shape}").copy_(
                torch.tensor(np.asarray(p[sub]["W"])))
            getattr(cell, f"gconv_biases_{shape[1]}").copy_(
                torch.tensor(np.asarray(p[sub]["b"])))
    a = torch.from_numpy(adj).requires_grad_()
    support = dcgru.random_walk_support(a)
    h = torch.zeros(3, 6, 5)
    for t in range(4):
        h = cell(torch.from_numpy(x[:, t]), h, support=support)
    h.sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)
    h2 = torch.zeros(3, 6, 5)
    with torch.no_grad():
        for t in range(4):
            h2 = cell(torch.from_numpy(x[:, t]), h2, adj=a)
    np.testing.assert_allclose(h2.numpy(), h.detach().numpy(), rtol=0,
                               atol=0)


def test_cosine_knn_graph_equals_jax():
    series = np.random.RandomState(3).randn(50, 12).astype(np.float32)
    got = cosine_knn_graph(series, 4)
    np.testing.assert_array_equal(got, jknn(series, 4))
    assert got.dtype == np.float32 and got.sum() == 12 * 4
    assert np.trace(got) == 0


def _small(**over):
    kw = dict(num_nodes=6, input_dim=2, output_dim=1, horizon=3, seq_len=4,
              rnn_units=5, max_diffusion_step=2, embedding_dim=7,
              train_series_len=40, knn_k=2)
    kw.update(over)
    return kw


def _weights(kw, seed=0, dtype=jnp.float32):
    params, bn = jgts.init_params(jax.random.PRNGKey(seed),
                                  jconfig.GTSConfig(**kw), dtype=dtype)
    # Running stats away from the init values, so eval mode reads them.
    rs = np.random.RandomState(seed)
    bn = {k: {"mean": jnp.asarray(rs.randn(*v["mean"].shape) * 0.1, dtype),
              "var": jnp.asarray(rs.uniform(0.5, 2, v["var"].shape), dtype)}
          for k, v in bn.items()}
    return params, bn


def _port(kw, params, bn, dtype=torch.float32):
    cfg = tconfig.GTSConfig(**kw)
    model = tgts.GTS(cfg, device="cpu", dtype=dtype)
    model.load_state_dict(gts_params_from_flat(flat_of(params), flat_of(bn),
                                               cfg, dtype=dtype))
    return model


def test_pairwise_logits_order_matches_jax():
    """Pair p = i * N + j carries [sender_j || receiver_i]."""
    kw = _small()
    params, bn = _weights(kw)
    model = _port(kw, params, bn)
    emb = np.random.RandomState(4).randn(6, 7).astype(np.float32)
    got = model.pairwise_logits(torch.from_numpy(emb)).detach().numpy()
    np.testing.assert_allclose(
        got, np.asarray(jgts.pairwise_logits(params, jnp.asarray(emb))),
        rtol=1e-5, atol=1e-6)
    i, j = 4, 1
    one = model.fc_cat(torch.relu(model.fc_out(torch.from_numpy(
        np.concatenate([emb[j], emb[i]])[None]))))
    np.testing.assert_allclose(got[i * 6 + j], one.detach().numpy()[0],
                               rtol=1e-6)


def test_gumbel_softmax_hard_with_the_same_uniforms():
    """The uniforms drawn by jax.random.uniform and passed to the port:
    equal hard samples (one-hot, first maximum), and the straight-through
    gradient equals the soft sample's (and JAX's)."""
    logits = np.random.RandomState(5).randn(40, 2).astype(np.float32)
    key = jax.random.PRNGKey(9)
    u = np.array(jax.random.uniform(key, logits.shape))
    want = jgts.gumbel_softmax_hard(jnp.asarray(logits), 0.5, key)
    lt = torch.from_numpy(logits).requires_grad_()
    got = tgts.gumbel_softmax_hard(lt, 0.5, torch.from_numpy(u))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert set(np.unique(got.detach().numpy())) <= {0.0, 1.0}
    w = np.random.RandomState(6).randn(40, 2).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    ls = torch.from_numpy(logits).requires_grad_()
    noisy = ls + (-torch.log(-torch.log(torch.from_numpy(u) + 1e-20)
                             + 1e-20))
    (torch.softmax(noisy / 0.5, -1) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), ls.grad.numpy(), rtol=1e-6)
    jg = jax.grad(lambda l: (jgts.gumbel_softmax_hard(l, 0.5, key)
                             * w).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    tie = torch.tensor([[1.0, 1.0]])
    assert tgts.gumbel_softmax_hard(tie, 0.5).tolist() == [[1.0, 0.0]]


class _F64Numpy:
    """jax.numpy with ``float32`` read as ``float64``: the JAX GTS module's
    explicit f32 casts (around BatchNorm and the output) widened, so its
    float64 mode runs in double throughout, as the port's does."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


BATCHES_SEEN = 15000.0  # threshold ~0.45: the coins mix both kinds of step


def _case(kw):
    """f32 weights, BatchNorm state, batch, training series, kNN prior and
    the two draws of a training forward (the Gumbel uniforms, the coins)
    from one JAX key."""
    params, bn = _weights(kw, seed=1)
    rs = np.random.RandomState(7)
    x = rs.randn(3, kw["seq_len"], kw["num_nodes"], 2).astype(np.float32)
    y = rs.randn(3, kw["horizon"], kw["num_nodes"], 1).astype(np.float32)
    y[rs.rand(*y.shape) < 0.1] = 0.0
    feas = rs.randn(kw["train_series_len"], kw["num_nodes"]).astype(
        np.float32)
    k_gumbel, k_cl = jax.random.split(jax.random.PRNGKey(11))
    uniforms = np.asarray(jax.random.uniform(
        k_gumbel, (kw["num_nodes"] ** 2, 2)))
    coins = np.asarray(jax.random.uniform(k_cl, (kw["horizon"],)))
    c = 2000.0
    use_truth = coins < c / (c + np.exp(np.float32(BATCHES_SEEN) / c))
    assert 0 < use_truth.sum() < len(use_truth)
    return dict(params=params, bn=bn, x=x, y=y, feas=feas,
                prior=cosine_knn_graph(feas, kw["knn_k"]),
                draws={uniforms.shape: uniforms, coins.shape: coins},
                use_truth=use_truth)


def _jax_step(kw, case, dtype, monkeypatch):
    """(loss, grads, new BatchNorm state, params after the clip and Adam)
    of one JAX train step (the loss of make_gts_train_step) with the
    curriculum and the noise on, its two draws pinned to the case's."""
    jd = jnp.dtype(dtype)
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jd), t)
    params, bn = cast(case["params"]), cast(case["bn"])
    jcfg = jconfig.GTSConfig(**kw)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(
                            case["draws"][tuple(shape)], jd))
    x, y = (jnp.asarray(case[k], jd) for k in ("x", "y"))
    prior = jnp.asarray(case["prior"]).reshape(-1)

    def jloss(p):
        out = jgts.forward(p, bn, x, jnp.asarray(case["feas"]), jcfg,
                           labels=y, batches_seen=BATCHES_SEEN,
                           rng=jax.random.PRNGKey(0), training=True)
        pred = masked_mae_loss(inverse_transform(out.output, STD, MEAN),
                               inverse_transform(y, STD, MEAN))
        return pred + jloop.bce(out.adj_prob.reshape(-1), prior), out.bn_state

    (loss, new_bn), grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    monkeypatch.undo()
    opt = optax.chain(clip_by_global_norm_torch(5.0),
                      optax.adam(0.005, eps=1e-3))
    updates, _ = opt.update(grads, opt.init(params), params)
    return (float(loss), flat_of(grads), flat_of(new_bn),
            flat_of(optax.apply_updates(params, updates)))


def _port_step(kw, case, dtype, monkeypatch):
    """The same of the port: the loss and new BatchNorm state of its
    make_gts_train_step, the gradients (before the clip) of its
    make_gts_loss_fn on a second copy of the weights, the case's draws
    handed in through gumbel_uniforms and sampling_mask."""
    td = torch.float64 if dtype == np.float64 else torch.float32
    monkeypatch.setattr(tgts, "gumbel_uniforms", lambda shape, g, dt: (
        torch.tensor(case["draws"][tuple(shape)], dtype=dt)))
    monkeypatch.setattr(tgts, "sampling_mask",
                        lambda *a: torch.from_numpy(case["use_truth"]))
    feas, prior = (torch.from_numpy(case[k]) for k in ("feas", "prior"))
    x, y = (torch.tensor(case[k], dtype=td) for k in ("x", "y"))
    model = _port(kw, case["params"], case["bn"], dtype=td)
    opt = torch.optim.Adam(model.parameters(), lr=0.005, eps=1e-3)
    loss = tloop.make_gts_train_step(
        model, tconfig.TrainConfig(lr=0.005, epsilon=1e-3,
                                   max_grad_norm=5.0),
        opt, torch.Generator(), MEAN, STD, feas, prior)(x, y, BATCHES_SEEN)
    twin = _port(kw, case["params"], case["bn"], dtype=td)
    tloop.make_gts_loss_fn(twin, MEAN, STD, feas, prior)(
        x, y, BATCHES_SEEN, torch.Generator()).backward()
    monkeypatch.undo()
    grads, _ = flat_from_gts_state_dict(
        dict(twin.named_buffers(),
             **{k: p.grad for k, p in twin.named_parameters()}), twin.cfg)
    new_params, bn = flat_from_gts_state_dict(model.state_dict(), model.cfg)
    return loss.item(), grads, bn, new_params


def _jax_f64(kw, case, monkeypatch):
    """The JAX step in double (its f32 casts widened by ``_F64Numpy``); x64
    scoped to the call."""
    with monkeypatch.context() as m:
        m.setattr(jgts, "jnp", _F64Numpy())
        with jax.enable_x64(True):
            out = _jax_step(dict(kw, compute_dtype="float64"), case,
                            np.float64, monkeypatch)
    assert not jax.config.jax_enable_x64
    return out


def test_train_step_matches_jax_f32(monkeypatch):
    """Loss, every gradient and the new BatchNorm running stats, f32, with
    the curriculum and the Gumbel noise on and the JAX draws pinned:
    gradients rtol 1e-4, atol 1e-5 * max|g| per array (only the summation
    order differs)."""
    kw = _small()
    case = _case(kw)
    w_loss, w_grads, w_bn, _ = _jax_step(kw, case, np.float32, monkeypatch)
    g_loss, g_grads, g_bn, _ = _port_step(kw, case, np.float32, monkeypatch)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    assert set(g_grads) == set(w_grads)
    for k, w in w_grads.items():
        np.testing.assert_allclose(g_grads[k], w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    for k, w in w_bn.items():
        np.testing.assert_allclose(g_bn[k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_train_step_matches_jax_f64(monkeypatch):
    """The same step in double: loss, every gradient, the new BatchNorm
    state and the weights after the clip and Adam(eps 1e-3), within
    1e-9."""
    kw = _small(compute_dtype="float64")
    case = _case(kw)
    want = _jax_f64(kw, case, monkeypatch)
    got = _port_step(kw, case, np.float64, monkeypatch)
    assert want[1]["fc/W"].dtype == np.float64
    for w_part, g_part in zip(want[1:], got[1:]):
        assert set(w_part) == set(g_part)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    for w_part, g_part in zip(want[1:], got[1:]):
        for k, w in w_part.items():
            np.testing.assert_allclose(g_part[k], w, rtol=1e-9,
                                       atol=1e-9 * np.abs(w).max(),
                                       err_msg=k)


def test_forward_raises_without_a_generator_for_its_draws():
    kw = _small()
    model = _port(kw, *_weights(kw))
    x = torch.zeros(1, 4, 6, 2)
    feas = torch.zeros(40, 6)
    with pytest.raises(ValueError, match="generator"):
        model(x, feas)
    with pytest.raises(ValueError, match="generator"):
        model(x, feas, labels=torch.zeros(1, 3, 6, 1), training=True,
              gumbel_noise=False)
