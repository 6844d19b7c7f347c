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

The directory backend, ``ckpt_backend="orbax"`` in the fit loops and the
CLIs (the JAX package's name for its directory format, so scripts carry
over): Orbax needs JAX, so the port writes the same state with
``torch.distributed.checkpoint`` (DCP) instead, the tensors under the same
``params/`` and ``opt/`` keys, and ``meta.json`` beside them, the
``arrays`` encoded in it losslessly as the JAX package encodes them. On a
mesh every rank calls the save; the state is replicated, so DCP writes
each tensor once. A directory that Orbax wrote is refused: ``.npz`` is the
format both packages read.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import warnings
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

_PORT = "torch/"
BACKENDS = ("npz", "orbax")
META_JSON = "meta.json"
# Files that only an Orbax checkpoint directory holds.
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


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


def _remove(path: str) -> None:
    if os.path.isdir(path) and not os.path.islink(path):
        shutil.rmtree(path)
    elif os.path.lexists(path):
        os.remove(path)


def save_checkpoint_dcp(path: str, params: Mapping[str, Any],
                        opt_state: Optional[Mapping[str, Any]] = None, *,
                        metadata: Optional[Dict[str, Any]] = None,
                        arrays: Optional[Dict[str, Any]] = None,
                        group=None) -> None:
    """The directory backend: what ``save_checkpoint`` writes to a file,
    written as a ``torch.distributed.checkpoint`` directory at ``path``
    with ``meta.json`` beside the tensors. It is written whole under
    ``path + ".tmp"`` and then put in place of any checkpoint at ``path``
    (the best-val overwrite). ``group``: the mesh's world group
    (``parallel.comm.Group``), whose every rank calls this with the same
    replicated state; None for one process."""
    import torch.distributed.checkpoint as dcp

    from megacrn_tpu_torch.parallel.comm import barrier

    def tensor(v):  # a C-ordered host copy (0-d stays 0-d)
        return torch.from_numpy(np.array(_numpy(v), order="C"))

    state = {f"params/{k}": tensor(v) for k, v in params.items()}
    state.update({f"opt/{k}": tensor(v)
                  for k, v in (opt_state or {}).items()})
    meta = dict(metadata or {})
    for k, v in (arrays or {}).items():
        a = _numpy(v)
        meta[k] = {"__array__": True, "dtype": a.dtype.str,
                   "data": a.tolist()}
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    lead = group is None or group.index == 0
    if lead:
        _remove(tmp)
        _remove(old)
    if group is not None:
        barrier(group)
    dist = group is not None and group.size > 1
    with warnings.catch_warnings():  # DCP warns when it runs in one process
        warnings.simplefilter("ignore", UserWarning)
        dcp.save(state, checkpoint_id=tmp, no_dist=not dist,
                 process_group=group.pg if dist else None)
    if lead:
        with open(os.path.join(tmp, META_JSON), "w") as f:
            json.dump(meta, f)
        if os.path.lexists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        _remove(old)
    if group is not None:
        barrier(group)


def write(backend: str, mesh, path: str, params: Mapping[str, Any],
          opt_state: Optional[Mapping[str, Any]] = None, *,
          metadata: Optional[Dict[str, Any]] = None,
          arrays: Optional[Dict[str, Any]] = None) -> None:
    """A fit loop's checkpoint write on ``backend`` ('npz': rank 0 writes
    the file while the others wait; 'orbax': the directory, every rank
    taking part). Every rank of ``mesh`` (or the one process) calls it."""
    if backend == "orbax":
        save_checkpoint_dcp(path, params, opt_state, metadata=metadata,
                            arrays=arrays,
                            group=None if mesh is None else mesh.world)
    elif backend == "npz":
        from megacrn_tpu_torch.train.logs import write_on_rank0

        write_on_rank0(mesh, lambda: save_checkpoint(
            path, params, opt_state, metadata=metadata, arrays=arrays))
    else:
        raise ValueError(f"unknown ckpt_backend {backend!r}; one of "
                         f"{BACKENDS}")


def _load_dir(path: str):
    """(params, opt_state, metadata) of a directory ``save_checkpoint_dcp``
    wrote; an Orbax directory, or any other, is refused."""
    import torch.distributed.checkpoint as dcp

    inside = [path] + [os.path.join(path, d) for d in os.listdir(path)
                       if os.path.isdir(os.path.join(path, d))]
    if any(os.path.exists(os.path.join(d, m))
           for d in inside for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an Orbax checkpoint (the JAX package's directory "
            "format), which the port cannot read: it needs JAX. The port's "
            "directories are torch.distributed.checkpoint ones; save the "
            "checkpoint as .npz (ckpt_backend='npz'), the format both "
            "packages read")
    if not (os.path.exists(os.path.join(path, ".metadata"))
            and os.path.exists(os.path.join(path, META_JSON))):
        raise ValueError(
            f"{path} is a directory but no checkpoint: it holds no "
            f"torch.distributed.checkpoint .metadata and {META_JSON}")
    reader = dcp.FileSystemReader(path)
    state = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
             for k, m in reader.read_metadata().state_dict_metadata.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dcp.load(state, storage_reader=reader, no_dist=True)
    with open(os.path.join(path, META_JSON)) as f:
        meta = json.load(f)
    for k, v in meta.items():
        if isinstance(v, dict) and v.get("__array__"):
            meta[k] = np.asarray(v["data"], dtype=np.dtype(v["dtype"]))
    blob = {k: v.numpy() for k, v in state.items()}
    return blob, meta


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray],
                                        Optional[Dict[str, np.ndarray]],
                                        Dict[str, Any]]:
    """(params, opt_state, metadata): params and opt_state as flat
    ``{path: array}`` dicts (opt_state None when the checkpoint has none).
    ``path``: an ``.npz`` file (either package's) or a directory that
    ``save_checkpoint_dcp`` wrote."""
    if os.path.isdir(path):
        blob, meta = _load_dir(path)
    else:
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
