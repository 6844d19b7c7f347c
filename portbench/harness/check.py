"""The numbers that decide ``correct``: the program's outputs against the
reference's.

Training (the first steps of the window's own train step, from the seed):
- ``loss_gap``: ``|L - L_ref| / |L_ref|``, the worst of the steps' losses;
- ``grad_gap_med`` and ``grad_gap_max``: the first step's gradient as the
  optimizer received it, per leaf ``| |g| - |g_ref| |`` over the larger of
  the leaf's ``|g_ref|`` and the median leaf's; the median leaf and the
  worst leaf;
- ``delta_gap_med`` and ``delta_gap_max``: the parameters' change over the
  steps, the same way; leaves whose reference gradient is under a
  thousandth of the median leaf's move by round-off alone under Adam and
  are left out.
The median leaf is steady from seed to seed, and catches a fault spread
over the model; the worst leaf catches one confined to a few leaves, with
a wider limit: on some seeds an L1 residual within rounding of zero takes
the other sign in the program than in the reference, which moves a
one-element leaf's gradient (``proj.0.bias``) by up to 1e-4. The later
steps' losses catch a gradient of the right norm but the wrong direction.
Serving:
- ``out_err``: the largest ``|y - y_ref|`` over the compared forecasts,
  over the largest ``|y_ref|``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

QUIET_GRAD = 1e-3  # of the median leaf's gradient norm
NOT_COMPARED = 1e30  # the reading where an output is missing or malformed


def norms(d: Dict[str, Optional[torch.Tensor]]) -> Dict[str, float]:
    return {k: 0.0 if v is None else float(torch.linalg.vector_norm(
        v.double())) for k, v in d.items()}


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    scale = float(torch.tensor([ref[k] for k in leaves]).median())
    return {k: abs(got[k] - ref[k]) / max(ref[k], scale) for k in leaves}


def _median(gaps: Dict[str, float]) -> float:
    return float(torch.tensor(list(gaps.values()), dtype=torch.float64)
                 .median())


def quiet_leaves(ref_grad: Dict[str, Optional[torch.Tensor]]) -> List[str]:
    """The leaves left out of ``delta_gap``: no reference gradient, or one
    under ``QUIET_GRAD`` of the median leaf's."""
    size = norms(ref_grad)
    moved = [k for k, v in ref_grad.items() if v is not None]
    scale = float(torch.tensor([size[k] for k in moved]).median())
    return [k for k in ref_grad if k not in moved
            or size[k] < QUIET_GRAD * scale]


def train_readings(losses: List[float], grad: Dict[str, float],
                   delta: Dict[str, float], ref: dict):
    """(compared numbers, each step's loss gap and the worst leaves) of
    the program's losses and per-leaf norms ``grad`` and ``delta`` against
    ``ref``, the reference's ``train_steps`` result and its initial
    parameters (``ref["init"]``)."""
    loss_gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    ref_grad = norms(ref["grad"])
    moved = [k for k, v in ref["grad"].items() if v is not None]
    quiet = quiet_leaves(ref["grad"])
    loud = [k for k in ref["grad"] if k not in quiet]
    ref_delta = norms({k: ref["params"][k] - ref["init"][k]
                        for k in ref["params"]})
    g = leaf_gaps(grad, ref_grad, moved)
    d = leaf_gaps(delta, ref_delta, loud)
    worst_g, worst_d = max(g, key=g.get), max(d, key=d.get)
    return ({"loss_gap": max(loss_gaps),
             "grad_gap_med": _median(g), "grad_gap_max": g[worst_g],
             "delta_gap_med": _median(d), "delta_gap_max": d[worst_d]},
            {"loss_gaps": loss_gaps, "grad_leaf": worst_g,
             "delta_leaf": worst_d})


def out_err(outs: List[torch.Tensor], refs: List[torch.Tensor]) -> float:
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(outs, refs))
    scale = max(float(b.double().abs().max()) for b in refs)
    return err / scale
