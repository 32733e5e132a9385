"""The one rule for picking a device: what the caller asked for, or an error.

There is no silent CPU fallback. A run that asked for the card and found none
must fail, not quietly measure PyTorch's CPU kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when CUDA is
    asked for and ``torch.cuda.is_available()`` is false."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
