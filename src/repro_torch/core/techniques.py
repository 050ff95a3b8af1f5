"""Emulation of the three RDMA performance techniques (paper §2, Fig. 1).

* **zero-copy removed**  → an extra memory copy on send and on receive
  (:func:`staged_copy`, a bounce-buffer copy).
* **kernel-bypass removed** → a calibrated serial delay per op, the
  user→kernel crossing (:func:`delay_chain`).
* **polling removed** → a larger calibrated delay on the completion path.

The delay primitive is a serial dependent fma chain.  On a CUDA tensor
both primitives launch the dataplane kernel (``kernels/dataplane``):
:func:`delay_chain` is ``mediated_cost(x, iters, 0)`` and
:func:`staged_copy` is ``bounce_copy``, so no per-iteration torch loop
ever runs on the card.  On a CPU tensor the chain runs on the host in
float32 and the copies are torch roll / roll-back pairs.  Outputs are
bit-identical to the input either way.

:func:`calibrate` measures ns per iteration once per process and device
type: the kernel's own slope on the card, the host chain's on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_ONE = np.float32(1.0)
_MUL = np.float32(1.0000001)
_ADD = np.float32(1e-9)


def delay_scalar(iters, seed: float = 1.0) -> float:
    """A serial dependent float32 computation of ``iters`` steps, run on
    the host — the chain the dataplane kernel burns on the card."""
    v = np.float32(seed)
    for _ in range(max(int(iters), 0)):
        v = v * _MUL + _ADD
    return float(v)


def tie(x: torch.Tensor, tok: float) -> torch.Tensor:
    """``x`` made to depend on ``tok`` with O(1) work, value-identical:
    the first element is selected on ``tok == tok`` (true for any finite
    token).  Returns ``x`` itself when the select keeps it."""
    if tok == tok or x.numel() == 0:
        return x
    out = x.clone()
    flat = out.view(-1)
    flat[0] = flat[0] + 1
    return out


def delay_chain(x: torch.Tensor, iters: int) -> torch.Tensor:
    """Delay the availability of ``x`` by a serial ``iters``-step chain;
    bit-identical output."""
    if iters <= 0:
        return x
    if x.device.type == "cuda":
        from repro_torch.kernels.dataplane.bounce import mediated_cost
        return mediated_cost(x, iters, 0)[0]
    return tie(x, delay_scalar(iters))


def delay_chain_dyn(x: torch.Tensor, iters) -> torch.Tensor:
    """``delay_chain`` with a trip count held in a tensor — the QoS token
    bucket's runtime stall.  On a CUDA tensor the count stays on the
    card: the stall kernel (``kernels/dataplane/stall.py``) reads it
    there and ``x`` itself is returned, so no value is read back and no
    stream waits.  On the CPU the chain runs on the host."""
    from repro_torch.kernels.dataplane.stall import stall
    return stall(x, iters)


_CALIBRATION: dict[tuple[str, int], float] = {}   # (device type, iters) -> ns/iter

# iterations actually timed on the host (the Python chain is slow)
_HOST_PROBE_ITERS = 20_000


def _time_kernel_chain(probe_iters: int, device: torch.device) -> float:
    from repro_torch.kernels.dataplane.bounce import mediated_cost
    x = torch.zeros((256,), dtype=torch.float32, device=device)
    mediated_cost(x, probe_iters, 0)                     # build + warm up
    torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mediated_cost(x, probe_iters, 0)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e6)   # ms -> ns
    return best / probe_iters


def calibrate(probe_iters: int = 200_000, device="cuda") -> float:
    """ns per delay-chain iteration on ``device``, memoized per device
    type: on the card the dataplane kernel's own slope (timed with CUDA
    events), on the CPU the host chain's."""
    dev = torch.device(device)
    key = (dev.type, probe_iters)
    hit = _CALIBRATION.get(key)
    if hit is not None:
        return hit
    if dev.type == "cuda":
        ns = _time_kernel_chain(probe_iters, dev)
    else:
        n = min(probe_iters, _HOST_PROBE_ITERS)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            delay_scalar(n)
            best = min(best, time.perf_counter() - t0)
        ns = best * 1e9 / n
    _CALIBRATION[key] = ns
    return ns


def iters_for_ns(ns: float, device="cuda") -> int:
    """Requested emulated cost (ns) -> delay iterations on ``device``."""
    if ns <= 0:
        return 0
    return max(1, int(ns / calibrate(device=device)))


def staged_copy_plain(x: torch.Tensor, copies: int = 1) -> torch.Tensor:
    """``copies`` real copies of ``x`` by roll / roll-back pairs (the copy
    into and out of the bounce buffer), on any device; bit-identical."""
    shape = x.shape
    flat = x.reshape(-1)
    for _ in range(copies):
        flat = torch.roll(flat, 1, 0)
        flat = torch.roll(flat, -1, 0)
    return flat.reshape(shape)


def staged_copy(x: torch.Tensor, copies: int = 1) -> torch.Tensor:
    """Force ``copies`` materialized copies of ``x`` (bounce buffer): the
    bounce kernel on a CUDA tensor, :func:`staged_copy_plain` on the CPU."""
    if x.device.type == "cuda":
        from repro_torch.kernels.dataplane.bounce import bounce_copy
        return bounce_copy(x, copies)
    return staged_copy_plain(x, copies)


__all__ = ["delay_chain", "delay_chain_dyn", "delay_scalar", "tie",
           "calibrate", "iters_for_ns", "staged_copy", "staged_copy_plain"]
