"""Device resolution shared by every entry point of the port.

Entry points take a `device` argument that defaults to ``"cuda"``.  The
CPU is used only when the caller asks for it (``device="cpu"``, as the
tests do); with the default and no card the call raises instead of
quietly running somewhere else.
"""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """`device` as a `torch.device`; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev
