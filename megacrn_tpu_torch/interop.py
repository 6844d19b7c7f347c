"""Weights across packages (counterpart of ``megacrn_tpu/interop.py``).

The port's module names are the reference's, so a reference ``.pt``
state_dict loads into ``models.megacrn.MegaCRN`` with ``load_state_dict``
and no conversion. The JAX package names the same weights with flat paths
(``memory/Memory``, ``encoder/{i}/gate/W``, ``proj/W`` stored input-major,
...): its ``.npz`` checkpoints and ``tests/goldens/*.npz`` hold them. The
two functions here convert between the two namings.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

_MEMORY = ("Memory", "Wq", "We1", "We2")
_CELLS = ("encoder", "decoder")
_SUBS = ("gate", "update")


def params_from_flat(flat: Mapping[str, np.ndarray], cfg,
                     dtype=torch.float32) -> "OrderedDict[str, torch.Tensor]":
    """The port's (and the reference's) state_dict from the JAX package's
    flat naming. ``cfg`` gives ``num_layers``."""

    def arr(k):
        return torch.as_tensor(np.array(flat[k], copy=True), dtype=dtype)

    sd = OrderedDict()
    for k in _MEMORY:
        sd[f"memory.{k}"] = arr(f"memory/{k}")
    for mod in _CELLS:
        for i in range(cfg.num_layers):
            for sub in _SUBS:
                sd[f"{mod}.dcrnn_cells.{i}.{sub}.weights"] = arr(
                    f"{mod}/{i}/{sub}/W")
                sd[f"{mod}.dcrnn_cells.{i}.{sub}.bias"] = arr(
                    f"{mod}/{i}/{sub}/b")
    sd["proj.0.weight"] = arr("proj/W").T.contiguous()
    sd["proj.0.bias"] = arr("proj/b")
    return sd


def flat_from_state_dict(sd: Mapping[str, torch.Tensor],
                         num_layers: int) -> Dict[str, np.ndarray]:
    """The JAX package's flat naming from a port or reference state_dict
    (what ``train.checkpoint.save_checkpoint`` writes)."""

    def npy(k):
        return np.array(sd[k].detach().cpu().numpy(), copy=True)

    flat = {f"memory/{k}": npy(f"memory.{k}") for k in _MEMORY}
    for mod in _CELLS:
        for i in range(num_layers):
            for sub in _SUBS:
                flat[f"{mod}/{i}/{sub}/W"] = npy(
                    f"{mod}.dcrnn_cells.{i}.{sub}.weights")
                flat[f"{mod}/{i}/{sub}/b"] = npy(
                    f"{mod}.dcrnn_cells.{i}.{sub}.bias")
    flat["proj/W"] = np.ascontiguousarray(npy("proj.0.weight").T)
    flat["proj/b"] = npy("proj.0.bias")
    return flat
