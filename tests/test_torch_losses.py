"""The port's losses (megacrn_tpu_torch/ops/losses.py) held against the JAX
package's (megacrn_tpu/ops/losses.py) and the torch-reference goldens in
tests/goldens/losses.npz."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from megacrn_tpu.ops import losses as jlosses
from megacrn_tpu_torch.ops import losses as tlosses

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "losses.npz")

# (loss, golden key, extra args)
PRED_LOSSES = [
    ("masked_mae_loss", "out/masked_mae_loss", ()),
    ("masked_mape_loss", "out/masked_mape_loss", ()),
    ("masked_mse_loss", "out/masked_mse_loss", ()),
    ("masked_rmse_loss", "out/masked_rmse_loss", ()),
    ("masked_mae", "out/masked_mae_nullval", (1e-3,)),
    ("masked_mape", "out/masked_mape_nullval", (1e-3,)),
    ("masked_mse", "out/masked_mse_nullval", (1e-3,)),
    ("masked_rmse", None, (1e-3,)),
]


def _blob():
    return dict(np.load(GOLDEN))


@pytest.mark.parametrize("name,key,args", PRED_LOSSES)
def test_masked_losses_match_golden_and_jax(name, key, args):
    b = _blob()
    pred, true = b["in/pred"], b["in/true"]
    got = getattr(tlosses, name)(torch.from_numpy(pred),
                                 torch.from_numpy(true), *args).item()
    want = float(getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(true),
                                        *args))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if key is not None:
        np.testing.assert_allclose(got, b[key], rtol=1e-6)


@pytest.mark.parametrize("name", ["masked_mae_loss", "masked_mape_loss",
                                  "masked_mse_loss", "masked_rmse_loss"])
def test_all_zero_targets_give_zero_like_jax(name):
    """The DCRNN mask is not NaN-fixed: an all-zero target makes the mask
    NaN, the loss NaN, and the NaN fix of the loss then gives 0."""
    true = torch.zeros(2, 3)
    got = getattr(tlosses, name)(torch.ones(2, 3), true).item()
    want = float(getattr(jlosses, name)(jnp.ones((2, 3)), jnp.zeros((2, 3))))
    assert got == want == 0.0


def test_mask_excludes_zero_targets():
    true = torch.tensor([[1.0, 0.0, 2.0, 3.0]])
    a = tlosses.masked_mae_loss(torch.tensor([[1.5, 99.0, 2.5, 3.5]]), true)
    b = tlosses.masked_mae_loss(torch.tensor([[1.5, -7.0, 2.5, 3.5]]), true)
    assert a.item() == b.item()
    np.testing.assert_allclose(a.item(), 0.5, rtol=1e-6)


@pytest.mark.parametrize("name,null_val", [("masked_mae_sums", None),
                                           ("masked_mae_null_sums", 1e-3),
                                           ("masked_mae_null_sums",
                                            float("nan"))])
def test_sums_decompositions_match_jax(name, null_val):
    b = _blob()
    pred, true = b["in/pred"].copy(), b["in/true"].copy()
    if null_val != null_val:
        true[0, 0] = np.nan
    args = () if null_val is None else (null_val,)
    got = getattr(tlosses, name)(torch.from_numpy(pred),
                                 torch.from_numpy(true), *args)
    want = getattr(jlosses, name)(jnp.asarray(pred), jnp.asarray(true), *args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-6)
    if name == "masked_mae_sums":
        np.testing.assert_allclose(
            (got[0] / got[1]).item(),
            tlosses.masked_mae_loss(torch.from_numpy(pred),
                                    torch.from_numpy(true)).item(),
            rtol=1e-6)


def test_triplet_and_mse_match_golden_and_jax():
    b = _blob()
    a, p, n = (torch.from_numpy(b[k]) for k in ("in/anchor", "in/posv",
                                                "in/negv"))
    trip = tlosses.triplet_margin_loss(a, p, n).item()
    np.testing.assert_allclose(trip, b["out/triplet"], rtol=1e-6)
    np.testing.assert_allclose(trip, float(jlosses.triplet_margin_loss(
        b["in/anchor"], b["in/posv"], b["in/negv"])), rtol=1e-6)
    # torch's own module, which the JAX package imitates.
    np.testing.assert_allclose(
        trip, torch.nn.TripletMarginLoss(margin=1.0)(a, p, n).item(),
        rtol=1e-6)
    np.testing.assert_allclose(tlosses.mse(a, p).item(), b["out/mse_plain"],
                               rtol=1e-6)


def test_aux_losses_match_jax_and_detach_pos_neg():
    b = _blob()
    a = torch.from_numpy(b["in/anchor"]).requires_grad_()
    p = torch.from_numpy(b["in/posv"]).requires_grad_()
    n = torch.from_numpy(b["in/negv"]).requires_grad_()
    got = tlosses.megacrn_aux_losses(a, p, n, lamb=0.01, lamb1=0.02)
    want = jlosses.megacrn_aux_losses(b["in/anchor"], b["in/posv"],
                                      b["in/negv"], lamb=0.01, lamb1=0.02)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    got.backward()
    assert a.grad is not None and p.grad is None and n.grad is None
