"""Input prefetching: overlap host-to-card batch copies with compute
(counterpart of ``megacrn_tpu/train/prefetch.py``).

A loop that copies batch k, runs step k, then copies batch k+1 leaves the
copy on the critical path. ``device_prefetch`` keeps up to ``depth``
batches placed ahead: on the card each batch's host arrays are pinned and
copied on a side CUDA stream with ``non_blocking=True``, and when a batch
is handed out the consumer's stream waits for its copy (an event) and
each of its tensors is recorded on that stream (``record_stream``), so the
caching allocator keeps the memory until the consumer's work that reads it
is done. On the CPU the placement is the identity: numpy arrays become
tensors over the same memory, and nothing is copied. As in the JAX
package it is an opt-in utility: ``train.loop.fit`` does not use it.
"""
from __future__ import annotations

import collections
import itertools
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from megacrn_tpu_torch import resolve_device


def _to_tensor(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


class _SideStreamCopy:
    """The card's placement: ``place(batch)`` starts the copies of one
    batch (any nest of numpy arrays and host tensors) on the side stream;
    ``ready(placed)`` makes the current stream wait for them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def place(self, batch):
        host = tree_map(lambda a: _to_tensor(a).pin_memory(), batch)
        with torch.cuda.stream(self.stream):
            placed = tree_map(
                lambda t: t.to(self.device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(self.stream)
        return placed, done

    def ready(self, item):
        placed, done = item
        current = torch.cuda.current_stream(self.device)
        current.wait_event(done)
        for t in tree_leaves(placed):
            if isinstance(t, torch.Tensor):
                t.record_stream(current)
        return placed


def device_prefetch(batches: Iterable, place_fn: Optional[Callable] = None,
                    depth: int = 2, device=None) -> Iterator:
    """Yield the batches in order with up to ``depth`` of the next ones
    already placed. ``place_fn``: the placement of one batch (default: on
    the card, pinned copies on a side stream; on the CPU the identity, as
    tensors).
    ``device``: where the default placement puts them (the card unless the
    caller says otherwise)."""
    ready = None
    if place_fn is None:
        device = resolve_device(device)
        if device.type == "cuda":
            copier = _SideStreamCopy(device)
            place_fn, ready = copier.place, copier.ready
        else:
            place_fn = lambda batch: tree_map(_to_tensor, batch)  # noqa: E731
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    it = iter(batches)
    queue = collections.deque(place_fn(b) for b in itertools.islice(it, depth))
    while queue:
        out = queue.popleft()
        # One more placed before this one is handed out.
        queue.extend(place_fn(b) for b in itertools.islice(it, 1))
        yield out if ready is None else ready(out)
