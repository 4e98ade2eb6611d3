"""Device selection for the port's entry points.

Every entry point that runs the batched engine or a kernel takes a
``device`` argument.  ``None`` means the CUDA card; the CPU is used only
when the caller asks for it (``device="cpu"``, as the tests do).  There
is no silent fallback: without CUDA and without an explicit device the
call raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a concrete ``torch.device`` (``None`` -> the current
    CUDA device; raises when CUDA is missing)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device=\"cpu\" to run on the "
                "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
