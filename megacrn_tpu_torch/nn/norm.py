"""BatchNorm1d with running statistics, torch semantics (counterpart of
``megacrn_tpu/nn/norm.py``).

The GTS graph learner normalises its extractor with three BatchNorms
(``model/GTS.py:354-356``). The JAX package threads their running stats
through ``bn_apply`` as an explicit state; here they are the buffers of an
``nn.BatchNorm1d`` (``running_mean``, ``running_var``, under the
reference's names), which ``bn_apply`` updates in place when training:
eps 1e-5, momentum 0.1 (running = 0.9 * running + 0.1 * batch), the batch's
biased variance to normalise and its unbiased variance for the running
update; the running stats in eval. ``training`` is an argument, as in the
JAX function, not the module's mode.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def bn_init(num_features: int, dtype=torch.float32) -> nn.BatchNorm1d:
    """Scale 1, bias 0, running mean 0, running var 1."""
    return nn.BatchNorm1d(num_features, eps=1e-5, momentum=0.1, dtype=dtype)


def bn_apply(bn: nn.BatchNorm1d, x: torch.Tensor,
             training: bool) -> torch.Tensor:
    """x: (B, C) or (B, C, L), normalised per channel C. With ``training``
    the batch statistics normalise and the running stats (and the batch
    counter) update in place."""
    if training:
        bn.num_batches_tracked.add_(1)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, training, bn.momentum, bn.eps)
