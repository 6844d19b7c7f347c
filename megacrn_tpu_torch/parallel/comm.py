"""The collectives of the mesh (counterpart of the ``jax.lax`` collectives
that ``shard_map`` bodies of ``megacrn_tpu/parallel`` use).

PyTorch has no GSPMD, so every collective of the port is written out, as a
``shard_map`` body writes it: ``psum`` (all-reduce, sum; the steps sum
gradients where JAX takes ``pmean``: see ``parallel.api``), ``all_gather``
(tiled, along one dim), the reduce-scatter that is its transpose (a
``psum`` and a slice), and ``shift``, the ``ppermute`` toward the lower
rank of ``parallel/ring.py``.
``all_gather_nodes``, ``ring_shift`` and ``all_reduce_sum`` are
``torch.autograd.Function``s whose backward is the transposed collective:
the ``psum_scatter``, the reverse ``ppermute`` and the ``psum`` that JAX's
VJP inserts.

**The backend**, one rule (``choose_backend``), decided once when the
process group starts (``multihost.initialize``) and printed there: NCCL
when the ranks compute on CUDA and every rank of the host has a card of
its own; gloo otherwise: on the CPU, and when several ranks share one card
(NCCL refuses two ranks on one GPU).

**How a CUDA tensor crosses gloo.** Here gloo moves host tensors only:
every op below copies a CUDA tensor into pinned host memory, runs the
collective there and copies the result back, explicitly and in that op,
and adds one to ``staged[op]``. Gloo's own CUDA support differs by op
(all-reduce and broadcast, not point-to-point), so one rule for every op
keeps the path the same whichever torch runs it. Under NCCL nothing is
staged. A collective that fails raises; it is never retried on another
path.

Every op moves raw bytes where the op is a copy (all-gather, shift), so
any dtype crosses either backend; a sum runs in the tensor's dtype, bf16
in f32 (rounded once, after the sum).
"""
from __future__ import annotations

import collections
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

# Per-op counts: calls that crossed ranks, and those staged through host.
calls: collections.Counter = collections.Counter()
staged: collections.Counter = collections.Counter()


class Group(NamedTuple):
    """One axis group of the mesh: its ``ProcessGroup`` (None for a group
    of one rank, where every op is the identity), its global ranks in axis
    order, and this rank's position among them."""

    pg: object
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


SOLO = Group(None, (0,), 0)


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """``"nccl"`` when the ranks compute on CUDA and the host has a card
    for each of its ``local_ranks`` ranks, else ``"gloo"``."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local_ranks):
        return "nccl"
    return "gloo"


def reset_counts() -> None:
    calls.clear()
    staged.clear()


def _staging(t: torch.Tensor, group: Group) -> bool:
    return t.is_cuda and dist.get_backend(group.pg) == "gloo"


def _out(t: torch.Tensor, group: Group, op: str) -> torch.Tensor:
    """``t`` as the collective sends it: a contiguous tensor, copied into
    pinned host memory when gloo must move a CUDA tensor (counted)."""
    t = t.contiguous()
    if not _staging(t, group):
        return t
    staged[op] += 1
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1).view(torch.uint8)


def psum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum of ``t`` over the group's ranks (a new tensor, on t's device, no
    autograd: the steps sum gradients, mask counts and losses with it)."""
    if group.size == 1:
        return t
    calls["all_reduce"] += 1
    work = t.float() if t.dtype == torch.bfloat16 else t
    buf = _out(work, group, "all_reduce")
    if buf is work:
        buf = buf.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group.pg)
    return buf.to(device=t.device, dtype=t.dtype)


def all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The tiled ``all_gather``: the group's blocks of ``t`` concatenated
    along ``dim`` in axis order. No autograd (``all_gather_nodes`` has
    one)."""
    if group.size == 1:
        return t
    calls["all_gather"] += 1
    front = t.movedim(dim, 0)
    src = _out(front, group, "all_gather")
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather([_bytes(p) for p in parts], _bytes(src), group=group.pg)
    return torch.cat(parts, 0).to(t.device).movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The transpose of ``all_gather``: the sum over ranks of ``t``, of
    which this rank keeps its block along ``dim`` (``psum_scatter``), as a
    ``psum`` of the whole tensor and a slice of it."""
    if group.size == 1:
        return t
    block = t.shape[dim] // group.size
    total = psum(t, group)
    return total.narrow(dim, group.index * block, block).contiguous()


def shift(t: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """This rank receives the tensor of the rank ``step`` places above it
    (cyclically) and sends its own ``step`` places below: ``step=1`` is the
    ppermute toward the lower rank of ``parallel/ring.py``, ``step=-1`` its
    reverse. One ``batch_isend_irecv`` of raw bytes."""
    if group.size == 1:
        return t
    calls["shift"] += 1
    src = _out(t, group, "shift")
    dst = torch.empty_like(src)
    p, i = group.size, group.index
    ops = [dist.P2POp(dist.isend, _bytes(src), group.ranks[(i - step) % p],
                      group=group.pg),
           dist.P2POp(dist.irecv, _bytes(dst), group.ranks[(i + step) % p],
                      group=group.pg)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return dst.to(t.device)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank of the process group (a run dir's
    name, a seed)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(group: Group) -> None:
    if group.size > 1:
        dist.barrier(group=group.pg)


class AllReduceSum(torch.autograd.Function):
    """``psum`` inside a differentiated function: every rank uses the sum
    of the ranks' partial terms, so the cotangent of a rank's term is the
    sum of the ranks' cotangents of the total (an all-reduce too)."""

    @staticmethod
    def forward(ctx, t, group: Group):
        ctx.group = group
        return psum(t, group)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return psum(g.contiguous(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group, differentiable in t."""
    return AllReduceSum.apply(t, group)


class AllGatherNodes(torch.autograd.Function):
    """The tiled ``all_gather(axis=1)`` of the node blocks, differentiable:
    the backward reduce-scatters the cotangent (summed over ranks)."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return all_gather(x, group, dim=1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=1), None


def all_gather_nodes(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(B, n_loc, C) node block -> (B, N, C), differentiable in x."""
    return AllGatherNodes.apply(x, group)


class RingShift(torch.autograd.Function):
    """``ppermute`` toward the lower rank; the backward sends the cotangent
    the other way."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    return RingShift.apply(x, group)
