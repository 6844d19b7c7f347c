"""Plain PyTorch MegaCRN: the forward, the composite training loss and the
Adam update, written from the published model (deepkashiwa20/MegaCRN,
``model/MegaCRN.py`` and the two ``traintest_MegaCRN.py`` harnesses).

This is the benchmark's yardstick. It imports nothing of the program under
test and computes every derived quantity itself: the Chebyshev support
matrices, the learned meta-graph, the normalisation. Parameters are a plain
``{name: tensor}`` dict under the reference's state_dict names.

Departures from the published code, none of which changes the function:
- the Chebyshev matrices ``[I, A, 2A.A - I, ...]`` are built once per
  forward, not once per graph convolution, and the identity term is applied
  as ``x`` itself (``I @ x == x`` exactly);
- a static road graph may stand in for the learned meta-graph
  (``road_supports``: the dense ``(S, N, N)`` supports);
- the decoder's scheduled-sampling coins come from a ``torch.Generator``,
  one ``rand(horizon)`` per forward, in place of ``np.random.uniform`` per
  step, so that a caller can hand the program and this reference the same
  coins.

Precision: float32 with TF32 off (``precision("float32")``). The control
of the benchmark's correctness check runs the same code with TF32 on
(``precision("tf32")``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(mode: str):
    """float32 matmuls with TF32 off ("float32") or on ("tf32")."""
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def decoder_dim(m: dict) -> int:
    return m["rnn_units"] + m["mem_dim"]


def param_shapes(m: dict) -> Dict[str, tuple]:
    """The parameters of a MegaCRN with model settings ``m`` (the "model"
    group of a configuration file), in the reference's state_dict order.
    Graph-convolution weights are ``(S*K*dim_in, dim_out)``, applied as
    ``x @ W``; the projection is an ``nn.Linear`` ``(out, in)``."""
    s, k = 2, m["cheb_k"]
    shapes = {"memory.Memory": (m["mem_num"], m["mem_dim"]),
              "memory.Wq": (m["rnn_units"], m["mem_dim"]),
              "memory.We1": (m["num_nodes"], m["mem_num"]),
              "memory.We2": (m["num_nodes"], m["mem_num"])}
    for part, d_in, hid in (
            ("encoder", m["input_dim"], m["rnn_units"]),
            ("decoder", m["output_dim"] + m["ycov_dim"], decoder_dim(m))):
        for layer in range(m["num_layers"]):
            d = d_in if layer == 0 else hid
            p = f"{part}.dcrnn_cells.{layer}"
            shapes[f"{p}.gate.weights"] = (s * k * (d + hid), 2 * hid)
            shapes[f"{p}.gate.bias"] = (2 * hid,)
            shapes[f"{p}.update.weights"] = (s * k * (d + hid), hid)
            shapes[f"{p}.update.bias"] = (hid,)
    shapes["proj.0.weight"] = (m["output_dim"], decoder_dim(m))
    shapes["proj.0.bias"] = (m["output_dim"],)
    return shapes


def meta_graph(p) -> torch.Tensor:
    """``[softmax(relu(E1 E2^T)), softmax(relu(E2 E1^T))]`` with
    ``E_i = We_i @ Memory`` (model/MegaCRN.py:168-173)."""
    e1 = p["memory.We1"] @ p["memory.Memory"]
    e2 = p["memory.We2"] @ p["memory.Memory"]
    return torch.stack([torch.softmax(torch.relu(e1 @ e2.T), dim=-1),
                        torch.softmax(torch.relu(e2 @ e1.T), dim=-1)])


def chebyshev_set(supports: torch.Tensor, cheb_k: int) -> List:
    """Support-major ``[I, A_1, T_2(A_1), .., I, A_2, ..]``; ``None`` stands
    for the identity (model/MegaCRN.py:16-22)."""
    out = []
    for a in supports:
        ks = [None, a]
        for _ in range(2, cheb_k):
            prev = (torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
                    if ks[-2] is None else ks[-2])
            ks.append(2.0 * (a @ ks[-1]) - prev)
        out += ks
    return out


def agcn(x: torch.Tensor, support_set, w, b) -> torch.Tensor:
    """model/MegaCRN.py:16-27: concat of ``T @ x`` over the set, then
    ``@ W + b``."""
    xg = torch.cat([x if t is None else torch.einsum("nm,bmc->bnc", t, x)
                    for t in support_set], dim=-1)
    return xg @ w + b


def gcrn_cell(p, prefix: str, x, h, support_set) -> torch.Tensor:
    """model/MegaCRN.py:37-48: the first half ``z`` of the gate scales the
    state fed to the candidate, the second ``r`` is the convex gate."""
    zr = torch.sigmoid(agcn(torch.cat([x, h], -1), support_set,
                            p[f"{prefix}.gate.weights"],
                            p[f"{prefix}.gate.bias"]))
    z, r = zr.split(h.shape[-1], dim=-1)
    hc = torch.tanh(agcn(torch.cat([x, z * h], -1), support_set,
                         p[f"{prefix}.update.weights"],
                         p[f"{prefix}.update.bias"]))
    return r * h + (1.0 - r) * hc


def forward(p, m: dict, x, y_cov, road_supports=None, labels=None,
            batches_seen: int = 0, generator=None, training: bool = False):
    """model/MegaCRN.py:168-194. x: (B, T, N, input_dim); y_cov:
    (B, horizon, N, ycov_dim). Returns (output, h_att, query, pos, neg)."""
    supports = meta_graph(p) if road_supports is None else road_supports
    sset = chebyshev_set(supports, m["cheb_k"])
    b, n = x.shape[0], x.shape[2]
    layers = m["num_layers"]
    h = [x.new_zeros((b, n, m["rnn_units"])) for _ in range(layers)]
    for t in range(x.shape[1]):
        inp = x[:, t]
        for i in range(layers):
            h[i] = gcrn_cell(p, f"encoder.dcrnn_cells.{i}", inp, h[i], sset)
            inp = h[i]
    h_t = h[-1]
    memory = p["memory.Memory"]
    query = h_t @ p["memory.Wq"]
    att = torch.softmax(query @ memory.T, dim=-1)
    h_att = att @ memory
    # The two nearest slots; of slots that tie exactly, the lower index
    # (the source's torch.topk leaves a tie's order open).
    ind = torch.sort(att, dim=-1, descending=True, stable=True).indices
    pos, neg = memory[ind[..., 0]], memory[ind[..., 1]]
    h = [torch.cat([h_t, h_att], dim=-1)] * layers
    go = x.new_zeros((b, n, m["output_dim"]))
    coins = None
    if training and m["use_curriculum_learning"]:
        c = float(m["cl_decay_steps"])
        threshold = c / (c + math.exp(batches_seen / c))
        coins = torch.rand(m["horizon"], generator=generator,
                           device=generator.device) < threshold
        coins = coins.tolist()
    outs = []
    for t in range(m["horizon"]):
        inp = torch.cat([go, y_cov[:, t]], dim=-1)
        for i in range(layers):
            h[i] = gcrn_cell(p, f"decoder.dcrnn_cells.{i}", inp, h[i], sset)
            inp = h[i]
        go = inp @ p["proj.0.weight"].T + p["proj.0.bias"]
        outs.append(go)
        if coins is not None and coins[t]:
            go = labels[:, t]
    return torch.stack(outs, dim=1), h_att, query, pos, neg


def inverse_transform(x, std: float, mean: float):
    """``x * std + mean``; a result within half an ulp of ``mean`` from 0
    is 0, the two-rounding round trip of a missing (zero) reading."""
    y = x * std + mean
    m32 = torch.tensor(abs(mean), dtype=torch.float32)
    tol = 0.5 * float(torch.nextafter(m32, torch.tensor(math.inf)) - m32)
    return torch.where(y.abs() <= tol, torch.zeros_like(y), y)


def masked_mae(y_pred, y_true):
    """model/utils.py:126-133 (DCRNN): mask ``y != 0`` over its mean, NaN
    losses zeroed."""
    mask = (y_true != 0).float()
    mask = mask / mask.mean()
    loss = (y_pred - y_true).abs() * mask
    return torch.where(torch.isnan(loss), torch.zeros_like(loss), loss).mean()


def composite_loss(out, y, train: dict, mean: float, std: float):
    """model/traintest_MegaCRN.py:118-125 and the EXPY-TKY harness's
    :76-94: ``L_pred + lamb * triplet + lamb1 * mse`` on the memory read,
    pos and neg detached."""
    output, _, query, pos, neg = out
    if train["pred_loss"] == "masked_mae_inv":
        pred = masked_mae(inverse_transform(output, std, mean),
                          inverse_transform(y, std, mean))
    elif train["pred_loss"] == "l1_normalized":
        pred = F.l1_loss(output, y)
    else:
        raise ValueError(f"unknown pred_loss {train['pred_loss']!r}")
    pos, neg = pos.detach(), neg.detach()
    return (pred + train["lamb"] * F.triplet_margin_loss(query, pos, neg,
                                                         margin=1.0)
            + train["lamb1"] * F.mse_loss(query, pos))


def train_steps(params: Dict[str, torch.Tensor], m: dict, train: dict,
                batches, generator, road_supports=None, mean: float = 0.0,
                std: float = 1.0, betas=(0.9, 0.999)) -> dict:
    """Adam steps from ``params`` over ``batches`` ((x, y, y_cov) device
    tensors; batches_seen counts from 0), with torch's
    ``clip_grad_norm_`` where ``train["max_grad_norm"]`` is set.

    Returns {"losses": [float], "grad": {name: tensor}} (the first step's
    gradient as Adam receives it, clipped; a parameter the loss does not
    reach has none) and "params" after the last step."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in
         params.items()}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in
             p.items()}
    b1, b2 = betas
    losses, first_grad = [], None
    for step, (x, y, y_cov) in enumerate(batches, start=1):
        out = forward(p, m, x, y_cov, road_supports, labels=y,
                      batches_seen=step - 1, generator=generator,
                      training=True)
        loss = composite_loss(out, y, train, mean, std)
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names],
                                    allow_unused=True)
        grads = dict(zip(names, grads))
        if train["max_grad_norm"] is not None:
            total = torch.linalg.vector_norm(torch.stack([
                torch.linalg.vector_norm(g) for g in grads.values()
                if g is not None]))
            coef = torch.clamp(train["max_grad_norm"] / (total + 1e-6),
                               max=1.0)
            grads = {k: None if g is None else g * coef
                     for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: None if g is None else g.detach().clone()
                          for k, g in grads.items()}
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in grads.items():
                if g is None:
                    continue
                mo, ve = state[k]
                mo.mul_(b1).add_(g, alpha=1 - b1)
                ve.mul_(b2).addcmul_(g, g, value=1 - b2)
                bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
                denom = ve.sqrt() / math.sqrt(bc2) + train["epsilon"]
                p[k].sub_(train["lr"] / bc1 * mo / denom)
    return {"losses": losses, "grad": first_grad,
            "params": {k: v.detach() for k, v in p.items()}}


def predict(params, m: dict, x_raw, y_cov, mean: float, std: float,
            road_supports=None, block: int = 64):
    """Raw-scale forecasts of raw windows x_raw (B, T, N, >=1), computed
    in blocks of ``block`` windows: channel 0 normalised, the
    deterministic forward, the inverse transform."""
    outs = []
    with torch.no_grad():
        for s in range(0, x_raw.shape[0], block):
            xb = x_raw[s:s + block].clone()
            xb[..., 0] = (xb[..., 0] - mean) / std
            out = forward(params, m, xb[..., :m["input_dim"]],
                          y_cov[s:s + block], road_supports)
            outs.append(out[0] * std + mean)
    return torch.cat(outs)
