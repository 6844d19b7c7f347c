"""Process-group start, the global mesh and per-process batch feeding
(counterpart of ``megacrn_tpu/parallel/multihost.py``).

One rank per process. ``initialize`` starts the ``torch.distributed``
group: from its arguments, or, with none, from torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). The backend
follows ``comm.choose_backend``.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.parallel import comm
from megacrn_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> torch.device:
    """Start the process group of this rank (a no-op for one process, or
    when it is already started) and return the device this rank computes
    on. ``coordinator_address``: ``host:port`` (TCP) or an ``init_method``
    URL such as ``file:///path``; default torchrun's
    ``MASTER_ADDR:MASTER_PORT``. ``device``: the card unless it says
    otherwise (``resolve_device``); it picks the backend, and under NCCL
    each local rank takes the card of its ``LOCAL_RANK``."""
    env = os.environ
    dev = resolve_device(device)
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return dev
    local_ranks = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    if dist.is_initialized():
        return _rank_device(dev, dist.get_backend(), dist.get_rank(),
                            local_ranks)
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    backend = comm.choose_backend(dev, local_ranks)
    dev = _rank_device(dev, backend, process_id, local_ranks)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if process_id == 0:
        staging = ("every collective of a CUDA tensor staged through pinned "
                   "host memory" if backend == "gloo" and dev.type == "cuda"
                   else "no staging")
        print(f"torch.distributed: backend {backend} ({num_processes} ranks "
              f"on {dev.type}, {local_ranks} on this host; {staging})",
              flush=True)
    return dev


def _rank_device(dev: torch.device, backend: str, rank: int,
                 local_ranks: int) -> torch.device:
    """Under NCCL the card of this rank's ``LOCAL_RANK``; else ``dev``."""
    if backend != "nccl":
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                   rank % local_ranks)))


def global_mesh(data: Optional[int] = None,
                node: Optional[int] = None) -> Mesh:
    """The (data, node) mesh over every rank. Defaults: the node axis spans
    the ranks of one host (``LOCAL_WORLD_SIZE``), the data axis the
    hosts."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if node is None:
        node = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if data is None:
        data = world // node
    return make_mesh(data, node)


def host_local_batch_to_global(mesh: Mesh, arrays):
    """Each process feeds its own slice of the global batch along the data
    axis (``B / data`` rows, every node); this returns the rank's block of
    it, its nodes cut out along the node axis. The counterpart of JAX's
    ``make_array_from_process_local_data``: with one rank per process no
    rows need to move."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        if mesh.node > 1:
            k = a.shape[2] // mesh.node
            a = a[:, :, mesh.node_index * k:(mesh.node_index + 1) * k]
        out.append(np.ascontiguousarray(a))
    return out
