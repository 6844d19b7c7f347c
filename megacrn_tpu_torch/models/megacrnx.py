"""MegaCRNx: the older ablation generation of the model family (counterpart
of ``megacrn_tpu/models/megacrnx.py``; reference
``model_futurework/MegaCRNx.py``).

A single-support AGCN built from node embeddings inside the conv
(``MegaCRNx.py:15-30``), free ``node_embeddings (N, embed_dim)``, a memory
read that also gives per-batch *meta node embeddings*
``W_E = (att @ Memory) @ FC_E`` (``:169-178``), the ablation flags
``memory_type`` / ``meta_type`` / ``decoder_type in {sequence, stepwise}``
(``:118-158``), and no curriculum learning: the forward is deterministic.

Parity notes:
* 3-D (meta) embeddings build the support through a batch-summed outer
  product ``einsum('bnc,bmc->nm')`` (``:21``): one N x N support shared by
  the batch, not one per sample.
* The support softmax is over ``dim=1`` (``:18,21``), which for (N, N)
  equals the canonical model's last axis.
* The weight width is ``cheb_k * dim_in`` (single support, ``:10``): the
  cells are MegaCRN's ``GCRNCell`` with one support.

Parameter names are the reference's (``node_embeddings``,
``memory.{Memory,Wq,FC_E}``, ``encoder.dcrnn_cells.{i}.gate.weights``,
``proj.0.weight``), so a reference state_dict loads as it is;
``interop.megacrnx_params_from_flat`` converts the JAX package's naming.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import nn

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.models.megacrn import DTYPES
from megacrn_tpu_torch.nn import memory as memory_mod
from megacrn_tpu_torch.nn.init import torch_linear, xavier_normal
from megacrn_tpu_torch.nn.seq import (decoder_init, encoder_init, init_hidden,
                                      stack_step)


@dataclasses.dataclass(frozen=True)
class MegaCRNxConfig:
    num_nodes: int = 207
    input_dim: int = 1
    output_dim: int = 1
    horizon: int = 12
    seq_len: int = 12
    rnn_units: int = 32
    num_layers: int = 1
    embed_dim: int = 8
    cheb_k: int = 3
    ycov_dim: int = 1
    mem_num: int = 10
    mem_dim: int = 32
    # Matmul-input dtype: "float32" (parity default) | "bfloat16" (the
    # support softmaxes and the memory read stay f32) | "float64" (CPU
    # parity control).
    compute_dtype: str = "float32"
    memory_type: bool = True
    meta_type: bool = True
    decoder_type: str = "stepwise"  # "sequence" | "stepwise"

    @property
    def decoder_dim(self) -> int:
        return self.rnn_units + (self.mem_dim if self.memory_type else 0)


class MegaCRNxOutput(NamedTuple):
    output: torch.Tensor  # (B, horizon, N, output_dim)
    h_att: Optional[torch.Tensor]  # (B, N, mem_dim), None without memory
    query: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    neg: Optional[torch.Tensor]


def support_from_embeddings(emb: torch.Tensor,
                            data_group=None) -> torch.Tensor:
    """MegaCRNx.py:15-21: the single support softmax(relu(E E^T), dim=1);
    3-D (B, N, e) embeddings are contracted over the batch first: over the
    WHOLE batch, so on a data-parallel mesh (``data_group``) the ranks'
    partial contractions are summed before the relu."""
    if emb.dim() == 2:
        logits = torch.relu(emb @ emb.T)
    else:
        gram = torch.einsum("bnc,bmc->nm", emb, emb)
        if data_group is not None:
            from megacrn_tpu_torch.parallel.comm import all_reduce_sum

            gram = all_reduce_sum(gram, data_group)
        logits = torch.relu(gram)
    return torch.softmax(logits, dim=1)


def query_memory(mem, h_t: torch.Tensor):
    """MegaCRNx.py:169-178: the MegaCRN memory read (its stable top-2)
    plus the meta node embeddings ``w_e = proto @ FC_E``. Returns (w_e,
    proto, query, pos, neg)."""
    proto, query, pos, neg = memory_mod.query_memory(mem, h_t)
    return proto @ mem["FC_E"].to(h_t.dtype), proto, query, pos, neg


class MegaCRNx(nn.Module):
    """MegaCRNx with reference-parity initial distributions, drawn from
    ``generator`` (a CPU ``torch.Generator``; default: seeded with 0).
    ``device``: where the model lives, the card unless the caller says
    otherwise (``resolve_device``)."""

    def __init__(self, cfg: MegaCRNxConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        self.node_embeddings = nn.Parameter(torch.randn(
            (cfg.num_nodes, cfg.embed_dim), generator=g, dtype=dtype))
        shapes = {"Memory": (cfg.mem_num, cfg.mem_dim),
                  "Wq": (cfg.rnn_units, cfg.mem_dim),
                  "FC_E": (cfg.mem_dim, cfg.embed_dim)}
        self.memory = nn.ParameterDict({
            k: nn.Parameter(xavier_normal(s, g, dtype))
            for k, s in shapes.items()})
        dec_in = (cfg.ycov_dim if cfg.decoder_type == "sequence"
                  else cfg.output_dim + cfg.ycov_dim)
        self.encoder = encoder_init(cfg.input_dim, cfg.rnn_units, cfg.cheb_k,
                                    cfg.num_layers, 1, g, dtype)
        self.decoder = decoder_init(dec_in, cfg.decoder_dim, cfg.cheb_k,
                                    cfg.num_layers, 1, g, dtype)
        self.proj = nn.Sequential(torch_linear(cfg.decoder_dim,
                                               cfg.output_dim, g, dtype))
        self.to(device)

    def forward(self, x: torch.Tensor, y_cov: torch.Tensor,
                data_group=None) -> MegaCRNxOutput:
        """MegaCRNx.py:180-214, deterministic. x: (B, T, N, input_dim);
        y_cov: (B, horizon, N, ycov_dim). ``data_group``: the mesh's data
        group inside a data-parallel step, where x holds this rank's batch
        rows; the decoder's meta support then still contracts the whole
        batch.

        ``compute_dtype="bfloat16"`` narrows the recurrence and projection
        matmul inputs; the support softmaxes and the memory read keep f32
        (the decoder's 3-D support is contracted and softmaxed in f32, then
        cast)."""
        cfg = self.cfg
        batch = x.shape[0]
        cd = DTYPES[cfg.compute_dtype]
        acc = torch.promote_types(torch.float32, cd)
        enc_support = support_from_embeddings(self.node_embeddings).to(cd)
        x = x.to(cd)
        y_cov = y_cov.to(cd)

        states = init_hidden(cfg.num_layers, batch, cfg.num_nodes,
                             cfg.rnn_units, cd, x.device)
        supports = enc_support[None]
        for t in range(x.shape[1]):
            _, states = stack_step(self.encoder, x[:, t], states, supports,
                                   cfg.cheb_k)
        h_t = states[-1].to(acc)

        h_att = query = pos = neg = None
        if cfg.memory_type:
            meta_emb, h_att, query, pos, neg = query_memory(self.memory, h_t)
            h_t = torch.cat([h_t, h_att], dim=-1)
            dec_emb = meta_emb if cfg.meta_type else self.node_embeddings
        else:
            if cfg.meta_type:
                raise ValueError(
                    "meta graph must derive from memory (MegaCRNx.py:194)")
            dec_emb = self.node_embeddings
        supports = support_from_embeddings(dec_emb.to(acc),
                                           data_group).to(cd)[None]
        states = (h_t.to(cd),) * cfg.num_layers
        proj_w = self.proj[0].weight.to(cd).T
        proj_b = self.proj[0].bias.to(cd)

        if cfg.decoder_type == "sequence":
            tops = []
            for t in range(cfg.horizon):
                top, states = stack_step(self.decoder, y_cov[:, t], states,
                                         supports, cfg.cheb_k)
                tops.append(top)
            output = torch.stack(tops, dim=1) @ proj_w + proj_b
        elif cfg.decoder_type == "stepwise":
            go = torch.zeros((batch, cfg.num_nodes, cfg.output_dim),
                             dtype=cd, device=x.device)
            outs = []
            for t in range(cfg.horizon):
                top, states = stack_step(self.decoder,
                                         torch.cat([go, y_cov[:, t]], -1),
                                         states, supports, cfg.cheb_k)
                go = top @ proj_w + proj_b
                outs.append(go)
            output = torch.stack(outs, dim=1)
        else:
            raise ValueError(f"unknown decoder_type {cfg.decoder_type!r}")
        return MegaCRNxOutput(output.to(acc), h_att, query, pos, neg)
