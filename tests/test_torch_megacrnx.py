"""The port's MegaCRNx (megacrn_tpu_torch.models.megacrnx, the train step
of train/megacrnx_loop.py) held against the committed reference goldens and
the JAX package on the CPU: the same numpy weights and batch go to both
sides through the flat naming (interop)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from megacrn_tpu.models import megacrnx as jx
from megacrn_tpu.train import megacrnx_loop as jloop
from megacrn_tpu_torch.interop import (flat_from_megacrnx_state_dict,
                                       megacrnx_params_from_flat)
from megacrn_tpu_torch.models import megacrnx as tx
from megacrn_tpu_torch.train import megacrnx_loop as tloop

torch.set_num_threads(1)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
MEAN, STD = 40.0, 12.0


def flat_of(tree):
    """A JAX params pytree in the flat ``a/0/b`` naming of its checkpoints."""
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        flat[key] = np.asarray(leaf)
    return flat


def _golden(name):
    blob = dict(np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")))
    (n, cin, cout, horizon, seq_len, units, layers, cheb_k, ycov,
     mem_num, mem_dim, embed) = (int(v) for v in blob["meta/config"])
    memory_type, meta_type, step = blob["meta/flags"]
    cfg = tx.MegaCRNxConfig(
        num_nodes=n, input_dim=cin, output_dim=cout, horizon=horizon,
        seq_len=seq_len, rnn_units=units, num_layers=layers, cheb_k=cheb_k,
        ycov_dim=ycov, mem_num=mem_num, mem_dim=mem_dim, embed_dim=embed,
        memory_type=bool(memory_type), meta_type=bool(meta_type),
        decoder_type="stepwise" if step else "sequence")
    return cfg, blob


@pytest.mark.parametrize("name", ["megacrnx_mem_meta_step",
                                  "megacrnx_mem_nometa_seq",
                                  "megacrnx_mem_nometa_step"])
def test_megacrnx_matches_reference_goldens(name):
    """tests/test_megacrnx.py's tolerances: query atol 2e-5 rtol 1e-4,
    output atol 5e-5 rtol 1e-4."""
    cfg, blob = _golden(name)
    model = tx.MegaCRNx(cfg, device="cpu")
    model.load_state_dict(megacrnx_params_from_flat(blob, cfg))
    with torch.no_grad():
        out = model(torch.from_numpy(blob["in/x"]),
                    torch.from_numpy(blob["in/y_cov"]))
    np.testing.assert_allclose(out.query.numpy(), blob["out/query"],
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.output.numpy(), blob["out/output"],
                               atol=5e-5, rtol=1e-4)


KW = dict(num_nodes=12, input_dim=1, output_dim=1, horizon=3, seq_len=4,
          rnn_units=8, mem_num=4, mem_dim=8, embed_dim=5)
COMBOS = [(True, True), (True, False), (False, False)]


def _setup(seed=0, batch=4, dtype=np.float32, **over):
    kw = dict(KW, **over)
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, kw["seq_len"], kw["num_nodes"], 1).astype(dtype)
    y = rs.uniform(0, 70, (batch, kw["horizon"], kw["num_nodes"], 1))
    y[rs.rand(*y.shape) < 0.05] = 0.0  # below null_val: masked
    yc = rs.uniform(0, 1, (batch, kw["horizon"], kw["num_nodes"], 1))
    return kw, x, y.astype(dtype), yc.astype(dtype)


@pytest.mark.parametrize("decoder", ["sequence", "stepwise"])
@pytest.mark.parametrize("memory,meta", COMBOS)
def test_forward_matches_jax_every_flag_and_dtype(memory, meta, decoder):
    """Random JAX weights carried through interop: f32 within atol 1e-5
    rtol 1e-4 of the JAX forward; bf16 (f32 output) within the JAX bf16
    test's band (atol 0.05, rtol 0.1) of both JAX's f32 and its bf16."""
    kw, x, _, yc = _setup(memory_type=memory, meta_type=meta,
                          decoder_type=decoder)
    params = jx.init_params(jax.random.PRNGKey(1), jx.MegaCRNxConfig(**kw))
    flat = flat_of(params)
    outs = {}
    for dt in ("float32", "bfloat16"):
        jcfg = jx.MegaCRNxConfig(**kw, compute_dtype=dt)
        cfg = tx.MegaCRNxConfig(**kw, compute_dtype=dt)
        model = tx.MegaCRNx(cfg, device="cpu")
        model.load_state_dict(megacrnx_params_from_flat(flat, cfg))
        with torch.no_grad():
            got = model(torch.from_numpy(x), torch.from_numpy(yc))
        want = jx.forward(params, x, yc, jcfg)
        assert got.output.dtype == torch.float32
        assert (got.query is None) == (not memory)
        outs[dt] = (got, want)
    got, want = outs["float32"]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-4)
    got16, want16 = outs["bfloat16"]
    for ref in (want.output, want16.output):
        np.testing.assert_allclose(got16.output.numpy(), np.asarray(ref),
                                   atol=0.05, rtol=0.1)


def test_meta_without_memory_rejected():
    kw, x, _, yc = _setup(memory_type=False, meta_type=True)
    model = tx.MegaCRNx(tx.MegaCRNxConfig(**kw), device="cpu")
    with pytest.raises(ValueError, match="meta graph must derive from "
                                         "memory"):
        model(torch.from_numpy(x), torch.from_numpy(yc))


def test_batch_summed_support_is_one_shared_support():
    """3-D embeddings give ONE support, softmax over dim 1 of the
    batch-summed outer product (MegaCRNx.py:21): equal to the per-sample
    einsum summed, and to the JAX function; not the per-sample supports."""
    emb = np.random.RandomState(3).randn(3, 7, 5).astype(np.float32)
    got = tx.support_from_embeddings(torch.from_numpy(emb)).numpy()
    summed = sum(e @ e.T for e in emb)
    logits = np.maximum(summed, 0)
    want = np.exp(logits - logits.max(1, keepdims=True))
    want /= want.sum(1, keepdims=True)
    assert got.shape == (7, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        got, np.asarray(jx.support_from_embeddings(jnp.asarray(emb))),
        rtol=1e-5, atol=1e-7)
    per_sample = tx.support_from_embeddings(torch.from_numpy(emb[0])).numpy()
    assert not np.allclose(got, per_sample, atol=1e-3)


def _step_both(kw, x, y, yc, dtype, lr=1e-3, adam=False):
    """One train step of each package from the same weights and batch:
    ((jax losses, grads, new params), (port losses, grads, new params));
    the JAX weights after Adam only with ``adam`` (else None)."""
    jcfg = jx.MegaCRNxConfig(**kw)
    jtrain = jloop.MegaCRNxTrainConfig(lr=lr)
    params = jx.init_params(jax.random.PRNGKey(2), jcfg,
                            dtype=jnp.dtype(dtype))

    def jloss(p):
        out = jx.forward(p, jnp.asarray(x), jnp.asarray(yc), jcfg)
        l1, l2, l3 = jloop._component_losses(out, jnp.asarray(y), "MaskMAE",
                                             MEAN, STD)
        return l1 + jtrain.lamb * l2 + jtrain.lamb1 * l3, (l1, l2, l3)

    (total, parts), grads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    new_params = None
    if adam:
        opt = optax.adam(lr)
        step = jloop.make_megacrnx_train_step(jcfg, jtrain, opt, MEAN, STD,
                                              donate=False)
        new_params = flat_of(step(params, opt.init(params), jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(yc))[0])
    want = ([float(total)] + [float(v) for v in parts], flat_of(grads),
            new_params)

    cfg = tx.MegaCRNxConfig(**kw)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    model = tx.MegaCRNx(cfg, device="cpu", dtype=tdtype)
    model.load_state_dict(megacrnx_params_from_flat(flat_of(params), cfg,
                                                    dtype=tdtype))
    opt_t = torch.optim.Adam(model.parameters(), lr=lr)
    vals = tloop.make_megacrnx_train_step(
        model, tloop.MegaCRNxTrainConfig(lr=lr), opt_t, MEAN, STD)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yc))
    got_grads = flat_from_megacrnx_state_dict(
        {k: p.grad for k, p in model.named_parameters()}, cfg.num_layers)
    got_params = flat_from_megacrnx_state_dict(model.state_dict(),
                                               cfg.num_layers)
    return want, (vals.tolist(), got_grads, got_params)


def _jax_f64_grads(kw, x, y, yc):
    """The f64 gradients of the JAX loss at _step_both's f32 weights: the
    truth that both packages' f32 gradients approximate."""
    with jax.enable_x64(True):
        jcfg = jx.MegaCRNxConfig(**dict(kw, compute_dtype="float64"))
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            jx.init_params(jax.random.PRNGKey(2), jx.MegaCRNxConfig(**kw)))

        def jloss(p):
            out = jx.forward(p, jnp.asarray(x, jnp.float64),
                             jnp.asarray(yc, jnp.float64), jcfg)
            l1, l2, l3 = jloop._component_losses(
                out, jnp.asarray(y, jnp.float64), "MaskMAE", MEAN, STD)
            return l1 + 0.01 * l2 + 0.01 * l3

        return flat_of(jax.jit(jax.grad(jloss))(params))


@pytest.mark.parametrize("decoder", ["sequence", "stepwise"])
def test_train_step_matches_jax_value_and_grad_f32(decoder):
    """Loss1-3, the total and every gradient, f32: rtol 1e-4, atol
    1e-5 * max|g| per array (only the summation order differs).

    An array whose f32 gradient is ill-conditioned (a sum of cancelling
    terms: here memory/FC_E, whose max|g| is ~1e-3 of the others') can miss
    that tolerance in JAX's own f32 result, measured against the f64
    gradient at the same weights. Such an array is held against the f64
    gradient instead: the port's error there must not exceed twice JAX's
    own."""
    kw, x, y, yc = _setup(seed=4, decoder_type=decoder)
    (w_loss, w_grads, _), (g_loss, g_grads, _) = _step_both(
        kw, x, y, yc, np.float32)
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-5)
    assert set(g_grads) == set(w_grads)
    truth = _jax_f64_grads(kw, x, y, yc)
    for k, w in w_grads.items():
        atol = 1e-5 * np.abs(w).max()
        jax_err = np.abs(w - truth[k])
        if (jax_err <= atol + 1e-4 * np.abs(truth[k])).all():
            np.testing.assert_allclose(g_grads[k], w, rtol=1e-4, atol=atol,
                                       err_msg=k)
        else:
            port_err = np.abs(g_grads[k] - truth[k]).max()
            assert port_err <= 2 * jax_err.max(), (k, port_err,
                                                   jax_err.max())


def test_train_step_matches_jax_f64():
    """The same step in double (``compute_dtype="float64"`` on both sides):
    the losses, every gradient and the weights after Adam within 1e-9. x64
    is scoped to this test."""
    kw, x, y, yc = _setup(seed=5, dtype=np.float64,
                          compute_dtype="float64")
    with jax.enable_x64(True):
        want, got = _step_both(kw, x, y, yc, np.float64, adam=True)
    assert not jax.config.jax_enable_x64
    (w_loss, w_grads, w_params), (g_loss, g_grads, g_params) = want, got
    assert w_grads["proj/W"].dtype == np.float64
    np.testing.assert_allclose(g_loss, w_loss, rtol=1e-9)
    for k, w in w_grads.items():
        np.testing.assert_allclose(g_grads[k], w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)
    for k, w in w_params.items():
        np.testing.assert_allclose(g_params[k], w, rtol=1e-9, atol=1e-12,
                                   err_msg=k)


def test_memory_off_has_no_memory_losses():
    """memory_type=False: loss2 = loss3 = 0, as in the JAX harness."""
    kw, x, y, yc = _setup(memory_type=False, meta_type=False)
    model = tx.MegaCRNx(tx.MegaCRNxConfig(**kw), device="cpu")
    total, (l1, l2, l3) = tloop.make_megacrnx_loss_fn(
        model, tloop.MegaCRNxTrainConfig(), MEAN, STD)(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(yc))
    assert l2.item() == l3.item() == 0.0 and total.item() == l1.item()
    assert dataclasses.asdict(tloop.MegaCRNxTrainConfig()) == \
        dataclasses.asdict(jloop.MegaCRNxTrainConfig())
