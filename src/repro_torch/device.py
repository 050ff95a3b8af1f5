"""Device selection for the port's entry points: the card unless the
caller asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, defaulting to ``cuda``.  Raises
    when a CUDA device is asked for (or defaulted to) and none exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev


__all__ = ["resolve_device"]
