"""Seeded initial weights, made on the device in two draws.

The distributions are the configuration's protocol (``config["init"]``):
- ``xavier_normal``: the published model's own initialisation
  (model/MegaCRN.py: xavier-normal graph-convolution and memory weights,
  zero graph-convolution biases, ``nn.Linear``'s uniform projection);
- ``xavier_uniform``: the EXPY-TKY harness's second pass
  (model_EXPYTKY/traintest_MegaCRN.py:27-35), xavier-uniform on every
  matrix and U(0, 1) on every vector.

Both the program and the reference are handed these same tensors.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.megacrn import param_shapes


def _fan_bound(shape) -> float:
    return math.sqrt(6.0 / (shape[0] + shape[1]))


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(config["model"])
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(total, generator=g, device=device)
    nrm = torch.randn(total, generator=g, device=device)
    init = config["init"]
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u, z = uni[off:off + n].view(shape), nrm[off:off + n].view(shape)
        off += n
        if init == "xavier_uniform":
            w = (2 * u - 1) * _fan_bound(shape) if len(shape) > 1 else u
        elif init == "xavier_normal":
            if name.startswith("proj.0."):
                bound = 1.0 / math.sqrt(shapes["proj.0.weight"][1])
                w = (2 * u - 1) * bound
            elif len(shape) > 1:
                w = z * math.sqrt(2.0 / (shape[0] + shape[1]))
            else:
                w = torch.zeros_like(u)
        else:
            raise ValueError(f"unknown init {init!r}")
        out[name] = w.contiguous()
    return out
