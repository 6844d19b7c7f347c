"""The reference optimizer protocol in torch (counterpart of
``megacrn_tpu/train/optim.py``).

Adam(lr, eps) + MultiStepLR(milestones, gamma) stepped per epoch +
``clip_grad_norm_(max_grad_norm)`` before each step
(``model/traintest_MegaCRN.py:104-105,129-130``). The eps is 1e-3 for
METR-LA and torch's default 1e-8 for EXPY-TKY (``config.train_config_for``).
Torch's own ``clip_grad_norm_`` is the semantics the JAX package imitates:
``min(max_norm / (norm + 1e-6), 1)``, applied unconditionally.
"""
from __future__ import annotations

from typing import Iterable

import torch

from megacrn_tpu_torch.config import TrainConfig


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=cfg.lr, eps=cfg.epsilon)


def make_lr_scheduler(optimizer: torch.optim.Optimizer, cfg: TrainConfig
                      ) -> torch.optim.lr_scheduler.MultiStepLR:
    """MultiStepLR over epochs: call its ``step()`` once per epoch."""
    return torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=list(cfg.lr_milestones),
        gamma=cfg.lr_decay_ratio)


def clip_gradients(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> None:
    """``clip_grad_norm_(max_grad_norm)`` when the protocol clips."""
    if cfg.max_grad_norm is not None:
        torch.nn.utils.clip_grad_norm_(params, cfg.max_grad_norm)
