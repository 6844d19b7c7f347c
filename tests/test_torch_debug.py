"""The port's debug mode (megacrn_tpu_torch.train.debug) held against the
JAX package's (megacrn_tpu/train/debug.py, ``checkify`` float checks): the
cases of tests/test_telemetry_debug.py, and the same functions raising or
passing in both packages, forward and backward; then a port train step
wrapped in ``checkified``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from megacrn_tpu.train import debug as jdebug
from megacrn_tpu_torch.config import MegaCRNConfig, train_config_for
from megacrn_tpu_torch.models.megacrn import MegaCRN
from megacrn_tpu_torch.train import debug as tdebug
from megacrn_tpu_torch.train.optim import make_optimizer
from megacrn_tpu_torch.train.steps import make_train_step


def test_checkified_raises_on_nan():
    """tests/test_telemetry_debug.py's case on the port."""
    safe = tdebug.checkified(torch.log)
    assert np.isfinite(float(safe(torch.tensor(2.0))))
    with pytest.raises(FloatingPointError, match="nan generated by op: "
                                                 "aten.log"):
        safe(torch.tensor(-1.0))


def test_finite_tree_reports_offender():
    tree = {"a": torch.ones(3), "b": {"c": torch.tensor([1.0, np.nan])}}
    assert tdebug.finite_tree(tree) == (False, ["b/c"])
    jtree = {"a": jnp.ones(3), "b": {"c": jnp.asarray([1.0, np.nan])}}
    assert jdebug.finite_tree(jtree) == (False, ["b/c"])
    assert tdebug.finite_tree({"x": [np.ones(2), np.array([np.inf])]}) == (
        False, ["x/1"])
    assert tdebug.finite_tree({"a": torch.zeros(2)}) == (True, [])


def test_grad_global_norm_is_the_clip_s_norm():
    """5 for (3, 4) as in JAX; on a model's gradients the norm that
    ``clip_grad_norm_`` returns, bit for bit, and JAX's to f32 rounding."""
    assert float(tdebug.grad_global_norm({"w": torch.tensor([3.0, 4.0])})) \
        == pytest.approx(5.0, rel=1e-6)
    rs = np.random.RandomState(0)
    grads = {"a": rs.randn(7, 3).astype(np.float32),
             "b": {"c": rs.randn(11).astype(np.float32)}}
    params = [torch.nn.Parameter(torch.zeros(g.shape))
              for g in (grads["a"], grads["b"]["c"])]
    for p, g in zip(params, (grads["a"], grads["b"]["c"])):
        p.grad = torch.from_numpy(g.copy())
    got = tdebug.grad_global_norm(
        {"a": params[0].grad, "b": {"c": params[1].grad}})
    assert torch.equal(got, torch.nn.utils.clip_grad_norm_(params, 1e9))
    np.testing.assert_allclose(float(got), float(jdebug.grad_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads))), rtol=1e-6)


def _grad_of(f):
    def g(x):
        x = x.clone().requires_grad_(True)
        f(x).backward()
        return x.grad
    return g


CASES = {
    # name: (port fn, JAX fn, x, raises)
    "masked_nan": (lambda x: torch.where(x > 0, torch.log(x), 0.0),
                   lambda x: jnp.where(x > 0, jnp.log(x), 0.0), -1.0, True),
    "float_one_over_zero": (lambda x: 1.0 / x, lambda x: 1.0 / x, 0.0,
                            True),
    "log_of_zero": (torch.log, jnp.log, 0.0, False),
    "overflow_to_inf": (lambda x: torch.exp(x + 1000.0),
                        lambda x: jnp.exp(x + 1000.0), 0.0, False),
    "inf_minus_inf": (lambda x: torch.exp(x + 1e3) - torch.exp(x + 1e3),
                      lambda x: jnp.exp(x + 1e3) - jnp.exp(x + 1e3), 0.0,
                      True),
    "finite": (lambda x: torch.sqrt(x) * 2, lambda x: jnp.sqrt(x) * 2, 4.0,
               False),
    # The backward of a where-masked sqrt at 0 divides by zero.
    "masked_backward": (_grad_of(lambda x: torch.where(x > 0, torch.sqrt(x),
                                                       0.0)),
                        jax.grad(lambda x: jnp.where(x > 0, jnp.sqrt(x),
                                                     0.0)), 0.0, True),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_raises_and_passes_where_jax_does(name):
    port_fn, jax_fn, x, raises = CASES[name]
    try:
        jdebug.checkified(jax_fn)(jnp.asarray(x, jnp.float32))
        jax_raised = False
    except Exception:  # checkify's JaxRuntimeError
        jax_raised = True
    assert jax_raised == raises
    safe = tdebug.checkified(port_fn)
    if raises:
        with pytest.raises(FloatingPointError):
            safe(torch.tensor(x))
    else:
        safe(torch.tensor(x))


def test_checkified_train_step_passes_finite_and_raises_on_nan():
    """A port train step under ``checkified``: the finite batch trains (the
    same loss as unwrapped); a NaN in x raises at the op that made it, and
    the optimizer step never runs, so the weights are untouched."""
    cfg = MegaCRNConfig(num_nodes=6, rnn_units=4, mem_num=3, mem_dim=4,
                        horizon=2, seq_len=2)
    tcfg = train_config_for("METRLA")
    rs = np.random.RandomState(0)
    x, y, yc = (torch.from_numpy(a.astype(np.float32)) for a in (
        rs.randn(4, 2, 6, 1), rs.rand(4, 2, 6, 1) * 60, rs.randn(4, 2, 6, 1)))

    def step_of():
        model = MegaCRN(cfg, device="cpu")
        return model, make_train_step(model, tcfg, make_optimizer(
            model.parameters(), tcfg), torch.Generator().manual_seed(0))

    model, step = step_of()
    _, plain = step_of()
    loss = tdebug.checkified(step)(x, y, yc, 0)
    assert loss.item() == plain(x, y, yc, 0).item()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="nan generated by op"):
        tdebug.checkified(step)(x, y, yc, 1)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
