"""The (data, node) mesh over ``torch.distributed`` ranks (counterpart of
``megacrn_tpu/parallel/mesh.py``).

One rank per process; rank ``r`` sits at ``(r // node, r % node)``, the
row-major layout of the JAX mesh's ``reshape(data, node)``.

* ``data``: batch parallelism. Each rank of a data row takes its slice of
  the batch; gradients are summed over the axis.
* ``node``: the graph partition. Each rank of a node column holds
  ``N / node`` nodes of every node-axis activation and the matching rows
  of the supports; an aggregation gathers the x node blocks over the axis.

Parameters are replicated on every rank, We1/We2 included. The JAX GSPMD
path row-shards We1/We2 over ``node`` (``param_sharding``); that is a
layout choice of GSPMD's, which the JAX explicit-collective ring step does
not make either (it replicates them and slices the node embeddings), so
``param_sharding``/``shard_params`` have no counterpart here, and
``make_shard_fn``'s is the ``node_group`` argument of
``models.megacrn.MegaCRN.forward``.

The loader is seeded, so every rank reads the same global batch and
``shard_batch`` cuts its own block out of it: no data moves.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch.distributed as dist

from megacrn_tpu_torch.parallel.comm import SOLO, Group

DATA_AXIS = "data"
NODE_AXIS = "node"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world group, this rank's ``(data, node)`` coordinates, and the
    group of its data row (``node_group``: the ranks that share its batch
    slice and partition the nodes) and of its node column
    (``data_group``: the ranks that hold the same nodes of other batch
    slices)."""

    data: int
    node: int
    rank: int
    world: Group
    data_group: Group
    node_group: Group

    @property
    def data_index(self) -> int:
        return self.rank // self.node

    @property
    def node_index(self) -> int:
        return self.rank % self.node


def _group(ranks, rank, pg=None) -> Group:
    ranks = tuple(ranks)
    return Group(pg if len(ranks) > 1 else None, ranks, ranks.index(rank))


def make_mesh(data: int = 1, node: int = 1) -> Mesh:
    """The mesh over the process group that ``multihost.initialize``
    started (every rank calls it, in the same order: it creates one group
    per data row and one per node column). ``data * node`` must equal the
    world size; a 1 x 1 mesh needs no process group."""
    if data < 1 or node < 1:
        raise ValueError(f"mesh {data}x{node}: both axes must be >= 1")
    if data * node == 1:
        return Mesh(1, 1, 0, SOLO, SOLO, SOLO)
    if not dist.is_initialized():
        raise ValueError(f"mesh {data}x{node} needs {data * node} ranks; "
                         "start them with parallel.launch or torchrun and "
                         "call parallel.multihost.initialize first")
    world = dist.get_world_size()
    if data * node != world:
        raise ValueError(f"mesh {data}x{node} needs {data * node} ranks, "
                         f"the process group has {world}")
    rank = dist.get_rank()
    rows = [[d * node + j for j in range(node)] for d in range(data)]
    cols = [[d * node + j for d in range(data)] for j in range(node)]
    row_pgs = [dist.new_group(r) if node > 1 else None for r in rows]
    col_pgs = [dist.new_group(c) if data > 1 else None for c in cols]
    d, j = rank // node, rank % node
    return Mesh(data, node, rank,
                _group(range(world), rank, dist.group.WORLD),
                data_group=_group(cols[j], rank, col_pgs[j]),
                node_group=_group(rows[d], rank, row_pgs[d]))


def shard_batch(arrays, mesh: Mesh, nodes: bool = True):
    """This rank's block of each (B, T, N, C) numpy array or tensor: batch
    rows over ``data`` and, with ``nodes``, nodes over ``node`` (else all
    nodes, the data-parallel steps' layout); contiguous copies."""
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch {b} does not divide by the data axis "
                             f"{mesh.data}")
        rows = b // mesh.data
        a = a[mesh.data_index * rows:(mesh.data_index + 1) * rows]
        if nodes and mesh.node > 1:
            n = a.shape[2]
            if n % mesh.node:
                raise ValueError(f"num_nodes {n} does not divide by the "
                                 f"node axis {mesh.node}")
            k = n // mesh.node
            a = a[:, :, mesh.node_index * k:(mesh.node_index + 1) * k]
        out.append(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                   else a.contiguous())
    return out
