"""Checkpoints in the JAX package's ``.npz`` format (counterpart of
``megacrn_tpu/train/checkpoint.py``), with numpy alone.

A checkpoint is one ``.npz`` file: ``params/<path>`` and ``opt/<path>``
arrays under the JAX package's flat paths (``interop.flat_from_state_dict``
gives them for a model), ``extra/<name>`` arrays, and ``meta/json``, the
metadata as uint8 JSON bytes. Files written here load in the JAX package and
the other way round. Orbax directory checkpoints need the JAX package.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np


def _numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, params: Mapping[str, Any], *,
                    metadata: Optional[Dict[str, Any]] = None,
                    arrays: Optional[Dict[str, Any]] = None) -> None:
    """Atomic write (tmp file + rename) of flat ``{path: array}`` params
    (numpy arrays or tensors). ``path`` should end in .npz. ``arrays`` come
    back merged into the metadata on load, losslessly. Optimizer state
    comes with the training slice."""
    blob = {f"params/{k}": _numpy(v) for k, v in params.items()}
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
            "is readable without the JAX package")
    with np.load(path) as z:
        blob = dict(z)
    meta = json.loads(bytes(blob.pop("meta/json").tobytes()).decode())

    def section(prefix):
        return {k[len(prefix):]: v for k, v in blob.items()
                if k.startswith(prefix)}

    meta.update(section("extra/"))
    return section("params/"), section("opt/") or None, meta
