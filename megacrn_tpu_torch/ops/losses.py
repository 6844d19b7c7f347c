"""Masked losses with the reference torch semantics (counterpart of
``megacrn_tpu/ops/losses.py``).

Two families:

* DCRNN-style ``*_loss`` (``model/utils.py:126-160``): mask = (y != 0),
  normalised by its mean **without** NaN-fixing the mask (an all-zero target
  yields NaN mask -> loss NaN -> zeroed -> 0), NaN-in-loss zeroed, then mean.
* ``null_val`` variants (``model/utils.py:81-123``): mask = (y > null_val)
  (or ~isnan for NaN null), mask itself NaN-fixed after normalisation.

Plus the auxiliary memory losses of the training objective
(``model/traintest_MegaCRN.py:121-125``): the triplet margin loss (margin
1.0, p=2, eps=1e-6 added to the difference as in
``torch.nn.functional.pairwise_distance``) and plain MSE. The ``*_sums``
decompositions give a masked mean as (numerator, denominator) so that
shards can add both before dividing once.
"""
from __future__ import annotations

import torch


def _nan_fix(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(t), torch.zeros_like(t), t)


def _dcrnn_mask(y_true: torch.Tensor) -> torch.Tensor:
    mask = (y_true != 0).to(torch.float32)
    # Deliberately no NaN fix here: parity with model/utils.py:127-128.
    return mask / mask.mean()


def masked_mae_loss(y_pred: torch.Tensor, y_true: torch.Tensor):
    """model/utils.py:126-133."""
    loss = (y_pred - y_true).abs() * _dcrnn_mask(y_true)
    return _nan_fix(loss).mean()


def masked_mae_sums(y_pred: torch.Tensor, y_true: torch.Tensor):
    """``(sum(nanfix(|err| * mask)), sum(mask))`` with the binary (y != 0)
    mask: ``masked_mae_loss == num / den`` whenever ``den > 0``, else 0."""
    mask = (y_true != 0).to(torch.float32)
    num = _nan_fix((y_pred - y_true).abs() * mask).sum()
    return num, mask.sum()


def masked_mape_loss(y_pred: torch.Tensor, y_true: torch.Tensor):
    """model/utils.py:135-142. The reference divides by zero (inf * 0 mask
    -> NaN -> 0); here the divisor is guarded so a zero target never makes
    an inf. It is masked to 0 either way, so the value is the same."""
    mask = _dcrnn_mask(y_true)
    safe = torch.where(y_true != 0, y_true, torch.ones_like(y_true))
    loss = ((y_true - y_pred) / safe).abs() * mask
    return _nan_fix(loss).mean()


def masked_mse_loss(y_pred: torch.Tensor, y_true: torch.Tensor):
    """model/utils.py:153-160."""
    loss = (y_true - y_pred).square() * _dcrnn_mask(y_true)
    return _nan_fix(loss).mean()


def masked_rmse_loss(y_pred: torch.Tensor, y_true: torch.Tensor):
    """model/utils.py:144-151 (sqrt of the masked-MSE mean)."""
    return masked_mse_loss(y_pred, y_true).sqrt()


def _null_binary_mask(labels: torch.Tensor, null_val: float):
    if null_val != null_val:  # NaN sentinel
        mask = ~torch.isnan(labels)
    else:
        mask = labels > null_val
    return mask.to(torch.float32)


def _null_mask(labels: torch.Tensor, null_val: float) -> torch.Tensor:
    mask = _null_binary_mask(labels, null_val)
    return _nan_fix(mask / mask.mean())  # model/utils.py:88 fixes the mask


def masked_mae(preds, labels, null_val: float = 1e-3):
    """model/utils.py:98-109."""
    loss = (preds - labels).abs() * _null_mask(labels, null_val)
    return _nan_fix(loss).mean()


def masked_mae_null_sums(preds, labels, null_val: float = 1e-3):
    """``masked_mae`` as ``(sum(nanfix(|err| * mask)), sum(mask))`` with the
    binary ``labels > null_val`` mask, like ``masked_mae_sums``."""
    mask = _null_binary_mask(labels, null_val)
    num = _nan_fix((preds - labels).abs() * mask).sum()
    return num, mask.sum()


def masked_mse(preds, labels, null_val: float = 1e-3):
    """model/utils.py:81-92."""
    loss = (preds - labels).square() * _null_mask(labels, null_val)
    return _nan_fix(loss).mean()


def masked_rmse(preds, labels, null_val: float = 1e-3):
    """model/utils.py:94-95."""
    return masked_mse(preds, labels, null_val).sqrt()


def masked_mape(preds, labels, null_val: float = 1e-3):
    """model/utils.py:112-123."""
    loss = ((preds - labels).abs() / labels) * _null_mask(labels, null_val)
    return _nan_fix(loss).mean()


def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 1.0,
                        eps: float = 1e-6) -> torch.Tensor:
    """``torch.nn.TripletMarginLoss`` (p=2, swap=False, mean reduction):
    ``d(a, b) = ||a - b + eps||_2`` over the last dim, then
    ``mean(relu(d_ap - d_an + margin))``."""
    d_ap = torch.linalg.vector_norm(anchor - positive + eps, dim=-1)
    d_an = torch.linalg.vector_norm(anchor - negative + eps, dim=-1)
    return torch.relu(d_ap - d_an + margin).mean()


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``nn.MSELoss``: the "compact" loss (model/traintest_MegaCRN.py:124)."""
    return (a - b).square().mean()


def megacrn_aux_losses(query, pos, neg, lamb: float, lamb1: float):
    """``lamb * separate + lamb1 * compact`` on the memory read, with pos and
    neg detached as the harness does (model/traintest_MegaCRN.py:123-124)."""
    pos, neg = pos.detach(), neg.detach()
    separate = triplet_margin_loss(query, pos, neg, margin=1.0)
    compact = mse(query, pos)
    return lamb * separate + lamb1 * compact
