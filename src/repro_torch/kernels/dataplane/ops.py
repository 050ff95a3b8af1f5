"""Backend selection + calibration for the dataplane kernels.

:func:`use_pallas_dataplane` keeps the ``DataplaneConfig.pallas_dataplane``
name of the JAX package: ``"auto"`` runs the fused cost kernel
(``mediated_cost``) on a CUDA device and the explicit emulation
(``techniques.delay_chain`` / ``staged_copy``) elsewhere; ``"on"`` forces
the fused kernel path everywhere (its plain version on the CPU); ``"off"``
keeps the explicit emulation.  On the card the explicit emulation is the
same kernel launched once per primitive instead of once per fused side,
so the setting changes the launch split, never values.

The port has one delay slope per device (the kernel's own on the card),
so :func:`kernel_calibrate` is ``techniques.calibrate`` and
:func:`rescale_iters` is the identity.
"""

from __future__ import annotations

import torch

from repro_torch.core import techniques as tech
from repro_torch.kernels.dataplane.bounce import bounce_copy, mediated_cost


def use_pallas_dataplane(setting: str | bool, device="cuda") -> bool:
    """Resolve a ``DataplaneConfig.pallas_dataplane`` setting to a bool."""
    if isinstance(setting, bool):
        return setting
    if setting == "auto":
        return torch.device(device).type == "cuda"
    if setting in ("on", "true", "1"):
        return True
    if setting in ("off", "false", "0"):
        return False
    raise ValueError(
        f"pallas_dataplane must be auto/on/off, got {setting!r}")


def kernel_calibrate(probe_iters: int = 200_000, device="cuda") -> float:
    """ns per in-kernel delay iteration on ``device`` (memoized)."""
    return tech.calibrate(probe_iters, device=device)


def kernel_iters_for_ns(ns: float, device="cuda") -> int:
    """Requested emulated cost (ns) -> in-kernel delay iterations."""
    if ns <= 0:
        return 0
    return max(1, int(ns / kernel_calibrate(device=device)))


def rescale_iters(iters: int) -> int:
    """Emulation iterations -> in-kernel iterations: the identity, since
    both read one slope."""
    return max(int(iters), 0)


__all__ = ["bounce_copy", "mediated_cost", "use_pallas_dataplane",
           "kernel_calibrate", "kernel_iters_for_ns", "rescale_iters"]
