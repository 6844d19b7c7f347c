"""Meta-node memory bank: parameters, attention read, top-2 prototype lookup
(counterpart of ``megacrn_tpu/nn/memory.py``; reference
``model/MegaCRN.py:149-166``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from megacrn_tpu_torch.nn.init import xavier_normal


def memory_init(num_nodes: int, rnn_units: int, mem_num: int, mem_dim: int,
                generator: torch.Generator,
                dtype=torch.float32) -> nn.ParameterDict:
    """Memory (M,d), Wq (H,d), We1/We2 (N,M), all xavier-normal, under the
    reference's names (``memory.Memory`` etc. in a state_dict)."""
    shapes = {"Memory": (mem_num, mem_dim), "Wq": (rnn_units, mem_dim),
              "We1": (num_nodes, mem_num), "We2": (num_nodes, mem_num)}
    return nn.ParameterDict({
        k: nn.Parameter(xavier_normal(s, generator, dtype))
        for k, s in shapes.items()})


def query_memory(mem, h_t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Attention read + top-2 prototypes (model/MegaCRN.py:159-166).

    h_t: (B, N, H); the memory parameters are read in h_t's dtype. Returns
    (value, query, pos, neg), each (B, N, d).
    """
    memory = mem["Memory"].to(h_t.dtype)
    query = h_t @ mem["Wq"].to(h_t.dtype)
    att = torch.softmax(query @ memory.T, dim=-1)  # (B, N, M)
    value = att @ memory
    # Top-2, descending; an exact tie goes to the lower slot, as in
    # jax.lax.top_k and the reference goldens (torch.topk on the CPU may
    # pick the higher one, and METR-LA's golden has such a tie).
    ind = torch.sort(att, dim=-1, descending=True, stable=True).indices
    return value, query, memory[ind[..., 0]], memory[ind[..., 1]]
