"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller passes ``device="cpu"``.
There is no silent fallback: without a CUDA device, ``device=None`` raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device (raises if there is none)."""
    if device is not None:
        device = torch.device(device)
        if (device.type == "cuda" and device.index is None
                and torch.cuda.is_available()):
            # One name for one card: "cuda" is the current device.
            device = torch.device("cuda", torch.cuda.current_device())
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return torch.device("cuda", torch.cuda.current_device())
