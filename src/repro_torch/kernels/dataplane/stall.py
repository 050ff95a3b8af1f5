"""The QoS stall: a serial delay chain whose trip count lives on the card.

``stall(x, iters)`` delays the availability of ``x`` by ``iters``
dependent fma steps (the chain the dataplane kernel burns) and returns
``x`` itself.  ``iters`` is an int32 tensor: on a CUDA tensor the entry
``bounce_stall_launch`` of ``csrc/bounce.cu`` reads it on the card, so
the caller's thread never reads it back and never waits for the device;
stream order makes every later use of ``x`` wait for the chain.  The
chain's result goes to a one-word scratch buffer per card.

``repro``'s counterpart is ``core/techniques.delay_chain_dyn``, an XLA
loop rather than the Pallas kernel, so the stall bumps no cost counter.
A CPU tensor takes the plain version: the host chain of
``techniques.delay_scalar`` and ``tie``; a ``meta`` tensor is returned
as it is, after a call of the operator ``repro_torch::bounce_stall``,
which a dispatch mode sees (``analysis/cost.py`` prices it).
``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import techniques as tech
from repro_torch.kernels import build

# kernel launches since the count was last set to 0
LAUNCHES = 0

_FN = None


def _bind():
    global _FN
    _FN = build.function("bounce", "bounce_stall_launch",
                         [ctypes.c_void_p] * 3)
    return _FN


@functools.lru_cache(maxsize=16)
def _sink(dev: int) -> torch.Tensor:
    """The chain's one-word result buffer on card ``dev``."""
    return torch.empty((1,), dtype=torch.float32, device=dev)


def stall_plain(x: torch.Tensor, iters) -> torch.Tensor:
    """The plain version: the chain on the host, ``x`` tied to it."""
    n = int(iters.item()) if isinstance(iters, torch.Tensor) else int(iters)
    return tech.tie(x, tech.delay_scalar(max(n, 0)))


# the stall on ``meta`` as an operator with a Meta kernel and no output
# (the wrapper returns ``x``), so that a dispatch mode sees the call and
# its trip count; the card's launch stays a direct ``ctypes`` call
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("bounce_stall(Tensor x, int iters) -> ()")
_LIB.impl("bounce_stall", lambda x, iters: None, "Meta")
_shape_rule = torch.ops.repro_torch.bounce_stall


def _kernel(x: torch.Tensor, iters: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if iters.device != x.device or iters.numel() != 1:
        raise ValueError(f"stall wants one int32 trip count on {x.device}, "
                         f"got {tuple(iters.shape)} on {iters.device}")
    iters = iters.to(torch.int32).contiguous()
    dev = x.get_device()
    err = (_FN or _bind())(iters.data_ptr(), _sink(dev).data_ptr(),
                           build.raw_stream(dev))
    build.check(err, "bounce_stall_launch")
    LAUNCHES += 1
    return x


def stall(x: torch.Tensor, iters) -> torch.Tensor:
    """Delay ``x`` by ``iters`` chain steps; returns ``x`` itself on the
    card (value-identical on the CPU).  ``iters`` is an int tensor on
    ``x``'s device or a Python int."""
    if x.is_cuda:
        if not isinstance(iters, torch.Tensor):
            iters = torch.full((), int(iters), dtype=torch.int32,
                               device=x.device)
        return _kernel(x, iters)
    if x.is_meta:
        # a trip count on meta has no value: the call is priced by its
        # trip count only when given a Python int
        _shape_rule(x, 0 if isinstance(iters, torch.Tensor)
                    else max(int(iters), 0))
        return x
    if x.device.type != "cpu":
        raise ValueError(f"no stall kernel for device {x.device}")
    return stall_plain(x, iters)


__all__ = ["stall", "stall_plain", "LAUNCHES"]
