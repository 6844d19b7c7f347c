"""Parameter initializers with torch-parity distributions (counterpart of
``megacrn_tpu/nn/init.py``), drawn from an explicit ``torch.Generator``.

* ``xavier_normal`` on 2-D weights: N(0, gain^2 * 2/(fan_in+fan_out)).
* torch ``nn.Linear`` default for the projection head: U(-1/sqrt(fan_in),
  1/sqrt(fan_in)) for weight and bias.
* ``xavier_uniform`` for the EXPY-TKY harness's second init pass
  (``model_EXPYTKY/traintest_MegaCRN.py:27-35``):
  U(-b, b) with b = gain * sqrt(6/(fan_in+fan_out)).

Shapes follow the JAX package, ``(fan_in, fan_out)``. The draws happen on
the CPU generator, so a seed gives the same weights whatever device the
model then moves to.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def xavier_normal(shape, generator: torch.Generator, dtype=torch.float32,
                  gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    std = gain * math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(shape, generator=generator, dtype=dtype)


def xavier_uniform(shape, generator: torch.Generator, dtype=torch.float32,
                   gain: float = 1.0) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[1]
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return _uniform(shape, -bound, bound, generator, dtype)


def torch_linear_weight(shape, generator: torch.Generator,
                        dtype=torch.float32) -> torch.Tensor:
    """shape = (fan_in, fan_out), input-major like the JAX package."""
    bound = 1.0 / math.sqrt(shape[0])
    return _uniform(shape, -bound, bound, generator, dtype)


def torch_linear_bias(fan_in: int, shape, generator: torch.Generator,
                      dtype=torch.float32) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return _uniform(shape, -bound, bound, generator, dtype)


def torch_linear(dim_in: int, dim_out: int, generator: torch.Generator,
                 dtype=torch.float32) -> nn.Linear:
    """An ``nn.Linear`` with torch's default init drawn from ``generator``
    (weight first, then bias; the weight drawn input-major, as the JAX
    package draws it, and stored transposed)."""
    lin = nn.utils.skip_init(nn.Linear, dim_in, dim_out, dtype=dtype)
    with torch.no_grad():
        lin.weight.copy_(torch_linear_weight((dim_in, dim_out), generator,
                                             dtype).T)
        lin.bias.copy_(torch_linear_bias(dim_in, (dim_out,), generator,
                                         dtype))
    return lin


def _uniform(shape, lo, hi, generator, dtype):
    return torch.empty(shape, dtype=dtype).uniform_(lo, hi,
                                                    generator=generator)
