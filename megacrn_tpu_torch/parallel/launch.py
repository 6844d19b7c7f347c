"""Local ranks for a mesh run (the counterpart of a single-process JAX mesh
over the local devices).

``spawn(fn, nprocs, args)`` starts ``nprocs`` processes with
``torch.multiprocessing``'s spawn context. Each sets torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), starts
the process group (``multihost.initialize``) and calls ``fn(*args)``; a
CLI run with ``--mesh_data x --mesh_node y > 1`` and no ``WORLD_SIZE`` in
its environment spawns itself this way, and under torchrun it joins the
group it is given instead. ``fn`` must be importable (a module-level
function): a spawned child imports its module afresh.

If a rank exits with a code other than 0, the others are stopped and
``spawn`` exits with that code. ``cli_mesh`` is the CLIs' entry to all
of it.
"""
from __future__ import annotations

import os
import socket
import sys
import time

import torch
import torch.multiprocessing as mp

from megacrn_tpu_torch import resolve_device


def in_group() -> bool:
    """Whether this process is already one rank of a launched group."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, nprocs, coordinator, device, threads, args):
    import torch.distributed as dist

    from megacrn_tpu_torch.parallel import multihost

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    if threads:
        torch.set_num_threads(threads)
    multihost.initialize(coordinator, nprocs, rank, device)
    try:
        fn(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, nprocs: int, args=(), coordinator=None, device=None) -> None:
    """Run ``fn(*args)`` on ``nprocs`` local ranks and wait for all of
    them. ``coordinator``: the rendezvous (``host:port`` or a ``file://``
    URL; default a free TCP port on this host). ``device``: where the
    ranks compute (the card unless it says otherwise); CPU ranks share the
    host's cores, ``cpu_count // nprocs`` threads each."""
    if coordinator is None:
        coordinator = f"127.0.0.1:{_free_port()}"
    threads = 0
    if device is not None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, nprocs, coordinator,
                                              device, threads, args))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next(((r, p.exitcode) for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed:
                break
            time.sleep(0.05)
        if failed is None:
            failed = next(((r, p.exitcode) for r, p in enumerate(procs)
                           if p.exitcode != 0), None)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
    if failed is not None:
        rank, code = failed
        print(f"launch: rank {rank} of {nprocs} exited with code {code}",
              file=sys.stderr, flush=True)
        raise SystemExit(code if code and code > 0 else 1)


def cli_mesh(main, argv, data: int, node: int, device):
    """A CLI's ``--mesh_data``/``--mesh_node``: ``(spawned, mesh, dev)``,
    ``dev`` the device this process computes on (``device`` resolved: the
    card unless it says otherwise, which raises at once if there is none).
    ``(False, None, dev)`` for one rank; ``(True, None, dev)`` once
    ``data * node`` local ranks, spawned here and each running
    ``main(argv)``, have all finished; ``(False, mesh, dev)`` inside a
    launched group (a spawned rank, or torchrun's), whose process group it
    starts if need be, ``dev`` then this rank's card under NCCL."""
    if data < 1 or node < 1:
        raise SystemExit(f"--mesh_data and --mesh_node must be >= 1, got "
                         f"{data} x {node}")
    dev = resolve_device(device)
    if data * node == 1:
        return False, None, dev
    if not in_group():
        argv = list(sys.argv[1:] if argv is None else argv)
        spawn(main, data * node, args=(argv,), device=device)
        return True, None, dev
    from megacrn_tpu_torch.parallel import multihost
    from megacrn_tpu_torch.parallel.mesh import make_mesh

    dev = multihost.initialize(device=device)
    return False, make_mesh(data, node), dev
