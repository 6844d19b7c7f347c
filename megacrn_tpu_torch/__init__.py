"""megacrn-tpu-torch: the PyTorch/CUDA port of ``megacrn_tpu`` for one
NVIDIA H100.

The port keeps the JAX package's module layout and public names so each
counterpart is easy to find, and imports nothing of it. Entry points run on
the CUDA card unless the caller asks for ``device="cpu"``; with no card and
no explicit CPU request they raise (``resolve_device``).
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` says
    otherwise. ``None`` (or a CUDA device) with no card raises instead of
    quietly running on the CPU."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    device = torch.device("cuda" if device is None else device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
