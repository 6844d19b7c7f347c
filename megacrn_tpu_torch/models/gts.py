"""GTS baseline: graph-structure-learning seq2seq (counterpart of
``megacrn_tpu/models/gts.py``; reference ``model/GTS.py:338-454``).

The second model family: a Conv1d feature extractor with BatchNorm over the
whole normalised training series, an all-pairs edge scorer, a
straight-through Gumbel-softmax sample of a discrete graph, and a DCGRU
encoder-decoder with scheduled sampling over that graph. The kNN-prior BCE
auxiliary loss lives in the harness (``train/gts_loop.py``).

Module names are the reference's (``conv1``, ``conv2``, ``fc``,
``fc_out``, ``fc_cat``, ``bn1``-``bn3``,
``encoder_model.dcgru_layers.{i}``,
``decoder_model.{dcgru_layers.{i},projection_layer}``), so a reference
state_dict loads as it is; ``interop.gts_params_from_flat`` converts the
JAX package's naming. The BatchNorms' running stats are module buffers,
updated in place by a training forward (``nn/norm.py``).

Random draws come from an explicit ``torch.Generator``: the Gumbel
uniforms first (``gumbel_uniforms``), then the decoder's coins
(``models.megacrn.sampling_mask``); ``gumbel_noise=False`` gives the
deterministic argmax graph that the parity tests, the eval and serving
use. The sampled adjacency's random-walk support is built once per forward
(``nn/dcgru.py``).

``compute_dtype="bfloat16"`` narrows the extractor convs, ``fc`` and the
DCGRU gconvs; BatchNorm, the edge logits, the softmax and the sampling stay
f32. In "float64" (a CPU parity control) everything runs in double: the
JAX function's f32 casts around BatchNorm read here as "at least f32".
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from megacrn_tpu_torch import resolve_device
from megacrn_tpu_torch.config import GTSConfig
from megacrn_tpu_torch.models.megacrn import (DTYPES,
                                              compute_sampling_threshold,
                                              sampling_mask)
from megacrn_tpu_torch.nn.dcgru import DCGRUStack, random_walk_support
from megacrn_tpu_torch.nn.init import torch_linear, torch_linear_bias
from megacrn_tpu_torch.nn.norm import bn_apply, bn_init


class GTSOutput(NamedTuple):
    output: torch.Tensor  # (B, horizon, N, output_dim)
    adj_prob: torch.Tensor  # (N, N) soft edge probabilities (BCE side)
    adj_sample: torch.Tensor  # (N, N) hard sampled adjacency


def _conv1d(in_c: int, out_c: int, k: int, g: torch.Generator,
            dtype) -> nn.Conv1d:
    """torch's Conv1d default: weight and bias U(+-1/sqrt(in_c * k))."""
    conv = nn.utils.skip_init(nn.Conv1d, in_c, out_c, k, dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch_linear_bias(in_c * k, (out_c, in_c, k), g,
                                            dtype))
        conv.bias.copy_(torch_linear_bias(in_c * k, (out_c,), g, dtype))
    return conv


def gumbel_uniforms(shape, generator: torch.Generator,
                    dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) draws for the Gumbel noise, on the generator's device (the
    one draw of the graph sampler, so a test can hand both packages the
    same uniforms)."""
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device)


def gumbel_softmax_hard(logits: torch.Tensor, temperature: float,
                        uniforms: Optional[torch.Tensor] = None,
                        eps: float = 1e-20) -> torch.Tensor:
    """Straight-through Gumbel-softmax (GTS.py:228-257): the one-hot of the
    first maximum in the forward, the soft sample's gradient in the
    backward. ``uniforms=None`` adds no noise (the deterministic argmax
    path)."""
    if uniforms is not None:
        logits = logits + (-torch.log(-torch.log(uniforms + eps) + eps))
    y_soft = torch.softmax(logits / temperature, dim=-1)
    y_hard = F.one_hot(torch.argmax(y_soft, dim=-1),
                       logits.shape[-1]).to(y_soft.dtype)
    return (y_hard - y_soft).detach() + y_soft


class GTS(nn.Module):
    """GTS with reference-parity initial distributions, drawn from
    ``generator`` (a CPU ``torch.Generator``; default: seeded with 0).
    ``device``: where the model lives, the card unless the caller says
    otherwise (``resolve_device``)."""

    def __init__(self, cfg: GTSConfig,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else (
            torch.Generator().manual_seed(0))
        self.cfg = cfg
        emb = cfg.embedding_dim
        self.conv1 = _conv1d(1, 8, 10, g, dtype)
        self.conv2 = _conv1d(8, 16, 10, g, dtype)
        self.fc = torch_linear(cfg.dim_fc, emb, g, dtype)
        self.fc_out = torch_linear(2 * emb, emb, g, dtype)
        self.fc_cat = torch_linear(emb, 2, g, dtype)
        self.bn1 = bn_init(8, dtype)
        self.bn2 = bn_init(16, dtype)
        self.bn3 = bn_init(emb, dtype)
        # Encoder layer 0 takes input_dim; decoder layer 0 takes output_dim
        # (its input is the previous projected output, GTS.py:396-403).
        self.encoder_model = DCGRUStack(cfg.input_dim, cfg.rnn_units,
                                        cfg.max_diffusion_step,
                                        cfg.num_layers, g, dtype)
        self.decoder_model = DCGRUStack(cfg.output_dim, cfg.rnn_units,
                                        cfg.max_diffusion_step,
                                        cfg.num_layers, g, dtype)
        self.decoder_model.projection_layer = torch_linear(
            cfg.rnn_units, cfg.output_dim, g, dtype)
        self.to(device)

    def _dtypes(self):
        cd = DTYPES[self.cfg.compute_dtype]
        return cd, torch.promote_types(torch.float32, cd)

    def node_embeddings(self, node_feas: torch.Tensor,
                        training: bool) -> torch.Tensor:
        """The Conv1d feature extractor over the whole training series
        (GTS.py:423-434): node_feas (T_train, N) -> (N, embedding_dim).
        With ``training`` the BatchNorms use and update batch stats."""
        cd, acc = self._dtypes()

        def conv(m, x):
            return torch.relu(F.conv1d(x.to(cd), m.weight.to(cd),
                                       m.bias.to(cd)))

        x = node_feas.T[:, None, :]  # (N, 1, T)
        x = bn_apply(self.bn1, conv(self.conv1, x).to(acc), training)
        x = bn_apply(self.bn2, conv(self.conv2, x).to(acc), training)
        x = x.reshape(x.shape[0], -1)  # (N, 16 * (T - 18))
        x = F.linear(x.to(cd), self.fc.weight.to(cd), self.fc.bias.to(cd))
        return bn_apply(self.bn3, torch.relu(x.to(acc)), training)

    def pairwise_logits(self, emb: torch.Tensor) -> torch.Tensor:
        """All-pairs edge logits (GTS.py:436-440): pair p = (i, j)
        row-major, features [sender_j || receiver_i] -> fc_out -> relu ->
        fc_cat. Returns (N*N, 2)."""
        n = emb.shape[0]
        receivers = emb.repeat_interleave(n, dim=0)  # i varies slowly
        senders = emb.repeat(n, 1)  # j varies quickly
        x = torch.relu(self.fc_out(torch.cat([senders, receivers], dim=1)))
        return self.fc_cat(x)

    def sample_graph(self, node_feas: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     training: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The graph-learner half of the forward (GTS.py:423-444):
        extractor -> pairwise scorer -> straight-through Gumbel sample with
        uniforms from ``generator`` (None: no noise, the argmax graph).
        Returns (adj, adj_prob); neither depends on the batch, so serving
        samples the graph once."""
        logits = self.pairwise_logits(self.node_embeddings(node_feas,
                                                           training))
        uniforms = (None if generator is None else gumbel_uniforms(
            logits.shape, generator, logits.dtype).to(logits.device))
        sample = gumbel_softmax_hard(logits, self.cfg.temperature, uniforms)
        n = self.cfg.num_nodes
        eye = torch.eye(n, dtype=sample.dtype, device=sample.device)
        adj = sample[:, 0].reshape(n, n) * (1.0 - eye)  # zero diagonal
        adj_prob = torch.softmax(logits, dim=-1)[:, 0].reshape(n, n)
        return adj, adj_prob

    def forward(self, x: torch.Tensor, node_feas: Optional[torch.Tensor],
                labels: Optional[torch.Tensor] = None, batches_seen=0,
                generator: Optional[torch.Generator] = None,
                training: bool = False, gumbel_noise: bool = True,
                graph: Optional[Tuple] = None) -> GTSOutput:
        """The full forward (GTS.py:412-454). x: (B, T, N, input_dim);
        node_feas: (T_train, N), the normalised training series; labels:
        (B, horizon, N, output_dim). ``graph``: a precomputed (adj,
        adj_prob) pair from ``sample_graph`` in place of the graph learner
        (node_feas may then be None). ``generator`` draws the Gumbel
        uniforms (with ``gumbel_noise``) and then, with ``training`` and
        ``cfg.use_curriculum_learning``, one coin per horizon step: the
        decoder feeds the label where ``coin < c / (c + exp(batches_seen /
        c))``."""
        cfg = self.cfg
        cd, acc = self._dtypes()
        use_cl = training and cfg.use_curriculum_learning
        if (use_cl or (gumbel_noise and graph is None)) and generator is None:
            raise ValueError("the Gumbel noise and curriculum training draw "
                             "from a generator: pass one")
        if use_cl and labels is None:
            raise ValueError("curriculum training requires labels")
        if graph is not None:
            adj, adj_prob = graph
        else:
            adj, adj_prob = self.sample_graph(
                node_feas, generator if gumbel_noise else None, training)

        # The sampled adj (and the straight-through gradient through it)
        # stays f32; the support narrows to the compute dtype.
        support = random_walk_support(adj).to(cd)
        x = x.to(cd)
        batch = x.shape[0]
        states = tuple(torch.zeros((batch, cfg.num_nodes, cfg.rnn_units),
                                   dtype=cd, device=x.device)
                       for _ in range(cfg.num_layers))
        for t in range(x.shape[1]):  # encoder (GTS.py:375-385)
            _, states = self.encoder_model.step(x[:, t], states, support)

        use_truth = None
        if use_cl:
            use_truth = sampling_mask(
                compute_sampling_threshold(cfg.cl_decay_steps, batches_seen),
                cfg.horizon, generator).to(x.device)
            labels = labels.to(cd)
        proj = self.decoder_model.projection_layer
        proj_w, proj_b = proj.weight.to(cd), proj.bias.to(cd)
        go = torch.zeros((batch, cfg.num_nodes, cfg.output_dim), dtype=cd,
                         device=x.device)
        outs = []
        for t in range(cfg.horizon):  # decoder (GTS.py:387-410)
            top, states = self.decoder_model.step(go, states, support)
            out_t = F.linear(top, proj_w, proj_b)
            outs.append(out_t)
            go = (out_t if use_truth is None
                  else torch.where(use_truth[t], labels[:, t], out_t))
        return GTSOutput(torch.stack(outs, dim=1).to(acc), adj_prob, adj)
