"""Weights across packages (counterpart of ``megacrn_tpu/interop.py``).

The port's module names are the reference's, so a reference ``.pt``
state_dict loads into ``models.megacrn.MegaCRN``, ``models.megacrnx.
MegaCRNx`` or ``models.gts.GTS`` with ``load_state_dict`` and no
conversion. The JAX package names the same weights with flat paths
(``memory/Memory``, ``encoder/{i}/gate/W``, ``proj/W`` stored input-major,
...): its ``.npz`` checkpoints and ``tests/goldens/*.npz`` hold them. The
functions here convert between the two namings, one pair per model family.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_MEMORY = ("Memory", "Wq", "We1", "We2")
_MEMORY_X = ("Memory", "Wq", "FC_E")  # MegaCRNx's memory bank
_CELLS = ("encoder", "decoder")
_SUBS = ("gate", "update")


def _tensor(flat, k, dtype):
    return torch.as_tensor(np.array(flat[k], copy=True), dtype=dtype)


def _numpy(sd, k) -> np.ndarray:
    return np.array(sd[k].detach().cpu().numpy(), copy=True)


def params_from_flat(flat: Mapping[str, np.ndarray], cfg,
                     dtype=torch.float32, memory=_MEMORY
                     ) -> "OrderedDict[str, torch.Tensor]":
    """The port's (and the reference's) state_dict from the JAX package's
    flat naming. ``cfg`` gives ``num_layers``; ``memory`` the memory
    bank's parameter names."""
    sd = OrderedDict()
    for k in memory:
        sd[f"memory.{k}"] = _tensor(flat, f"memory/{k}", dtype)
    for mod in _CELLS:
        for i in range(cfg.num_layers):
            for sub in _SUBS:
                sd[f"{mod}.dcrnn_cells.{i}.{sub}.weights"] = _tensor(
                    flat, f"{mod}/{i}/{sub}/W", dtype)
                sd[f"{mod}.dcrnn_cells.{i}.{sub}.bias"] = _tensor(
                    flat, f"{mod}/{i}/{sub}/b", dtype)
    sd["proj.0.weight"] = _tensor(flat, "proj/W", dtype).T.contiguous()
    sd["proj.0.bias"] = _tensor(flat, "proj/b", dtype)
    return sd


def flat_from_state_dict(sd: Mapping[str, torch.Tensor], num_layers: int,
                         memory=_MEMORY) -> Dict[str, np.ndarray]:
    """The JAX package's flat naming from a port or reference state_dict
    (what ``train.checkpoint.save_checkpoint`` writes)."""
    flat = {f"memory/{k}": _numpy(sd, f"memory.{k}") for k in memory}
    for mod in _CELLS:
        for i in range(num_layers):
            for sub in _SUBS:
                flat[f"{mod}/{i}/{sub}/W"] = _numpy(
                    sd, f"{mod}.dcrnn_cells.{i}.{sub}.weights")
                flat[f"{mod}/{i}/{sub}/b"] = _numpy(
                    sd, f"{mod}.dcrnn_cells.{i}.{sub}.bias")
    flat["proj/W"] = np.ascontiguousarray(_numpy(sd, "proj.0.weight").T)
    flat["proj/b"] = _numpy(sd, "proj.0.bias")
    return flat


def megacrnx_params_from_flat(flat: Mapping[str, np.ndarray], cfg,
                              dtype=torch.float32
                              ) -> "OrderedDict[str, torch.Tensor]":
    """A MegaCRNx state_dict (the reference's names) from the JAX package's
    flat naming: MegaCRN's, with the memory bank's ``FC_E`` in place of
    ``We1``/``We2`` and the free ``node_embeddings`` (the MegaCRNx goldens'
    layout)."""
    sd = OrderedDict(node_embeddings=_tensor(flat, "node_embeddings", dtype))
    sd.update(params_from_flat(flat, cfg, dtype, memory=_MEMORY_X))
    return sd


def flat_from_megacrnx_state_dict(sd: Mapping[str, torch.Tensor],
                                  num_layers: int) -> Dict[str, np.ndarray]:
    """The JAX package's flat MegaCRNx naming from a port or reference
    state_dict."""
    return {"node_embeddings": _numpy(sd, "node_embeddings"),
            **flat_from_state_dict(sd, num_layers, memory=_MEMORY_X)}


_LINEARS = ("fc", "fc_out", "fc_cat")
_BNS = ("bn1", "bn2", "bn3")


def _gts_renames(cfg):
    """[(JAX flat name, reference state_dict name, transposed)] of every
    GTS parameter: the fixed renaming between the two packages (the
    reference's LayerParams names carry the weight's shape)."""
    out = [(f"{c}/W", f"{c}.weight", False) for c in ("conv1", "conv2")]
    out += [(f"{c}/b", f"{c}.bias", False) for c in ("conv1", "conv2")]
    out += [(f"{f}/W", f"{f}.weight", True) for f in _LINEARS]
    out += [(f"{f}/b", f"{f}.bias", False) for f in _LINEARS]
    out += [(f"{b}/scale", f"{b}.weight", False) for b in _BNS]
    out += [(f"{b}/bias", f"{b}.bias", False) for b in _BNS]
    units, k1 = cfg.rnn_units, cfg.max_diffusion_step + 1
    for tag, mod, dim_in in (("encoder", "encoder_model", cfg.input_dim),
                             ("decoder", "decoder_model", cfg.output_dim)):
        for i in range(cfg.num_layers):
            rows = ((dim_in if i == 0 else units) + units) * k1
            p = f"{mod}.dcgru_layers.{i}"
            out += [(f"{tag}/{i}/gate/W",
                     f"{p}.gconv_weight_{(rows, 2 * units)}", False),
                    (f"{tag}/{i}/gate/b", f"{p}.gconv_biases_{2 * units}",
                     False),
                    (f"{tag}/{i}/candidate/W",
                     f"{p}.gconv_weight_{(rows, units)}", False),
                    (f"{tag}/{i}/candidate/b", f"{p}.gconv_biases_{units}",
                     False)]
    out += [("proj/W", "decoder_model.projection_layer.weight", True),
            ("proj/b", "decoder_model.projection_layer.bias", False)]
    return out


def gts_params_from_flat(flat: Mapping[str, np.ndarray],
                         bn_flat: Mapping[str, np.ndarray], cfg,
                         dtype=torch.float32
                         ) -> "OrderedDict[str, torch.Tensor]":
    """A GTS state_dict (the reference's names) from the JAX package's flat
    params naming (``conv1/W``, ``bn1/scale``, ``encoder/{i}/gate/W``,
    ``proj/W`` input-major, ...) and its BatchNorm state (``bn1/mean``,
    ``bn1/var``, ...): the ``gts_small.npz`` layout, and the params and
    ``.bn`` files of a GTS checkpoint."""
    sd = OrderedDict()
    for jax_name, ref_name, transposed in _gts_renames(cfg):
        t = _tensor(flat, jax_name, dtype)
        sd[ref_name] = t.T.contiguous() if transposed else t
    for b in _BNS:
        sd[f"{b}.running_mean"] = _tensor(bn_flat, f"{b}/mean", dtype)
        sd[f"{b}.running_var"] = _tensor(bn_flat, f"{b}/var", dtype)
        sd[f"{b}.num_batches_tracked"] = torch.tensor(0)
    return sd


def flat_from_gts_state_dict(sd: Mapping[str, torch.Tensor], cfg
                             ) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """(params, BatchNorm state) in the JAX package's flat GTS naming from a
    port or reference state_dict."""
    flat = {}
    for jax_name, ref_name, transposed in _gts_renames(cfg):
        a = _numpy(sd, ref_name)
        flat[jax_name] = np.ascontiguousarray(a.T) if transposed else a
    bn = {}
    for b in _BNS:
        bn[f"{b}/mean"] = _numpy(sd, f"{b}.running_mean")
        bn[f"{b}/var"] = _numpy(sd, f"{b}.running_var")
    return flat, bn
