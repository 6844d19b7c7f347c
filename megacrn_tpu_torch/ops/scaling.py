"""Inverse standardisation with the reference's zero snap (counterpart of
``megacrn_tpu/ops/scaling.py``).

The reference marks missing readings with ``y == 0`` and relies on the round
trip ``((0 - mean)/std) * std + mean`` landing on exactly ``0.0`` under
separately rounded f32 multiply and add. A fused multiply-add rounds once
and leaves a tiny nonzero residual, so the missing-data mask stops matching.
``inverse_transform`` snaps any result within half an ulp of ``mean`` from
zero to exactly zero, whatever the backend fuses. Denormalise through it,
never with a bare ``y * std + mean``.
"""
from __future__ import annotations

import torch


def inverse_transform(x: torch.Tensor, std, mean) -> torch.Tensor:
    """``x * std + mean`` with the reference's two-rounding zero snapping.

    ``std``/``mean`` may be Python scalars or tensors.
    """
    y = x * std + mean
    m32 = torch.as_tensor(mean, dtype=torch.float32, device=x.device).abs()
    # Half-ulp(mean): the window where fl32(x*std) == -mean, which collapses
    # to exact 0.0 under separately rounded mul/add.
    tol = 0.5 * (torch.nextafter(m32, torch.full_like(m32, float("inf")))
                 - m32)
    return torch.where(y.abs() <= tol, torch.zeros_like(y), y)
