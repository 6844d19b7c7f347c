"""Checkpoints in the JAX package's ``.npz`` format (counterpart of
``megacrn_tpu/train/checkpoint.py``), with numpy alone.

A checkpoint is one ``.npz`` file:

* ``params/<path>``: the weights under the JAX package's flat paths
  (``interop.flat_from_state_dict`` gives them for a model), so either
  package loads the other's params;
* ``opt/<path>``: optimizer state. The JAX package writes its optax state
  here; the port writes its own, under ``opt/torch/``:
  ``opt/torch/adam/<name>/step``, ``.../exp_avg``, ``.../exp_avg_sq`` per
  parameter (``<name>`` is the module's state_dict name, the arrays in its
  layout), ``opt/torch/lr`` (one learning rate per param group) and
  ``opt/torch/lr_scheduler/last_epoch`` (``MultiStepLR`` counts epochs);
* ``extra/<name>``: arrays that come back merged into the metadata, losslessly
  (the fit loop's scheduled-sampling generator state, the per-column scaler);
* ``meta/json``: the metadata as uint8 JSON bytes.

Orbax directory checkpoints need the JAX package.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_PORT = "torch/"


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, params: Mapping[str, Any],
                    opt_state: Optional[Mapping[str, Any]] = None, *,
                    metadata: Optional[Dict[str, Any]] = None,
                    arrays: Optional[Dict[str, Any]] = None) -> None:
    """Atomic write (tmp file + rename) of flat ``{path: array}`` params and
    optimizer state (numpy arrays or tensors). ``path`` should end in .npz.
    ``arrays`` come back merged into the metadata on load, losslessly."""
    blob = {f"params/{k}": _numpy(v) for k, v in params.items()}
    blob.update({f"opt/{k}": _numpy(v) for k, v in (opt_state or {}).items()})
    blob.update({f"extra/{k}": _numpy(v) for k, v in (arrays or {}).items()})
    blob["meta/json"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray],
                                        Optional[Dict[str, np.ndarray]],
                                        Dict[str, Any]]:
    """(params, opt_state, metadata): params and opt_state as flat
    ``{path: array}`` dicts (opt_state None when the file has none)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax directory checkpoint; only the .npz format "
            "is readable without the JAX package (ROADMAP Queue 1 item 4)")
    with np.load(path) as z:
        blob = dict(z)
    meta = json.loads(bytes(blob.pop("meta/json").tobytes()).decode())

    def section(prefix):
        return {k[len(prefix):]: v for k, v in blob.items()
                if k.startswith(prefix)}

    meta.update(section("extra/"))
    return section("params/"), section("opt/") or None, meta


def optimizer_state(optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    named_params: Sequence[Tuple[str, torch.Tensor]]
                    ) -> Dict[str, np.ndarray]:
    """The ``opt/`` section of a port checkpoint (without the prefix): Adam's
    ``step``, ``exp_avg`` and ``exp_avg_sq`` of each parameter that has
    taken a step, the learning rate of each param group and the scheduler's
    epoch count."""
    names = {id(p): n for n, p in named_params}
    flat = {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            for k, v in optimizer.state.get(p, {}).items():
                flat[f"{_PORT}adam/{names[id(p)]}/{k}"] = _numpy(v)
    flat[f"{_PORT}lr"] = np.array([g["lr"] for g in optimizer.param_groups])
    flat[f"{_PORT}lr_scheduler/last_epoch"] = np.array(scheduler.last_epoch)
    return flat


def restore_optimizer(optimizer: torch.optim.Optimizer,
                      scheduler: torch.optim.lr_scheduler.LRScheduler,
                      opt_state: Optional[Mapping[str, np.ndarray]],
                      named_params: Sequence[Tuple[str, torch.Tensor]]
                      ) -> None:
    """Load what ``optimizer_state`` saved into ``optimizer`` and
    ``scheduler``. Raises ValueError when the checkpoint holds no port
    optimizer state (a JAX-written file keeps optax's state, which the port
    cannot resume from; its params still load)."""
    if not opt_state or f"{_PORT}lr" not in opt_state:
        raise ValueError(
            "the checkpoint holds no optimizer state written by "
            "megacrn_tpu_torch (keys opt/torch/...); a JAX-package checkpoint "
            f"keeps optax's state ({sorted(opt_state or {})[:3]}...), which "
            "cannot resume a torch Adam. Load its params without resume, or "
            "resume from a checkpoint the port wrote")
    names = {id(p): n for n, p in named_params}
    sd = optimizer.state_dict()
    index = 0
    for g, group in enumerate(optimizer.param_groups):
        sd["param_groups"][g]["lr"] = float(opt_state[f"{_PORT}lr"][g])
        for p in group["params"]:
            prefix = f"{_PORT}adam/{names[id(p)]}/"
            st = {k[len(prefix):]: torch.from_numpy(np.array(v))
                  for k, v in opt_state.items() if k.startswith(prefix)}
            if st:
                sd["state"][index] = st
            index += 1
    optimizer.load_state_dict(sd)
    scheduler.load_state_dict({
        **scheduler.state_dict(),
        "last_epoch": int(opt_state[f"{_PORT}lr_scheduler/last_epoch"]),
        "_last_lr": [g["lr"] for g in optimizer.param_groups]})
