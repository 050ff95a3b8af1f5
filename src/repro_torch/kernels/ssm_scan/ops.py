"""Public wrapper for the SSM-scan kernel (``csrc/ssm_scan.cu``).

Given CUDA tensors it launches the Hopper kernel (or raises); given CPU
tensors it runs the plain version, ``ref.ssm_scan_ref``.  Unlike
``repro``'s wrapper it pads nothing: the kernel takes any sequence
length.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

STATE_SIZES = (1, 2, 4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the count was last set to 0
LAUNCHES = 0

# dt, x, a, b, c, h0, y, hf; dtype, B, S, di, N, chunk; stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def ssm_scan_plain(dt, x, a, b, c, h0):
    """The kernel's plain version on any device: y in dt's dtype, h_final
    in float32."""
    y, hf = ssm_scan_ref(dt, x, a, b, c, h0)
    return y.to(dt.dtype), hf


def _check(dt, x, a, b, c, h0) -> None:
    if dt.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"ssm_scan wants dt/x (B, S, di); got "
                         f"{tuple(dt.shape)}, {tuple(x.shape)}")
    bsz, s, di = dt.shape
    n = a.shape[-1]
    if a.shape != (di, n) or b.shape != (bsz, s, n) or c.shape != b.shape \
            or h0.shape != (bsz, di, n):
        raise ValueError(f"ssm_scan shape mismatch: dt {tuple(dt.shape)} a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)} h0 {tuple(h0.shape)}")
    if n not in STATE_SIZES:
        raise ValueError(f"ssm_scan kernel takes state size N in "
                         f"{STATE_SIZES}, got {n}")
    if dt.dtype not in _DTYPES or x.dtype != dt.dtype:
        raise ValueError(f"ssm_scan kernel takes float32 or bfloat16 dt/x of "
                         f"one dtype, got {dt.dtype}/{x.dtype}")
    for name, t in (("a", a), ("b", b), ("c", c), ("h0", h0)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssm_scan kernel: {name} must be float32, got "
                             f"{t.dtype}")
    for name, t in (("dt", dt), ("x", x), ("a", a), ("b", b), ("c", c),
                    ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
        if t.device != dt.device:
            raise ValueError("ssm_scan: inputs on different devices")


def _kernel(dt, x, a, b, c, h0, chunk: int):
    global LAUNCHES
    _check(dt, x, a, b, c, h0)
    bsz, s, di = dt.shape
    n = a.shape[1]
    y = torch.empty_like(dt)
    hf = torch.empty_like(h0)
    fn = build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    stream = torch.cuda.current_stream(dt.device).cuda_stream
    err = fn(dt.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), h0.data_ptr(), y.data_ptr(), hf.data_ptr(),
             _DTYPES[dt.dtype], bsz, s, di, n, int(chunk), stream)
    build.check(err, "ssm_scan_launch")
    LAUNCHES += 1
    return y, hf


def ssm_scan(dt, x, a, b, c, h0=None, *, chunk: int = 128,
             channel_block: int = 256):
    """Selective scan.  dt/x: (B, S, di) float32 or bfloat16; a: (di, N);
    b/c: (B, S, N); h0: (B, di, N), zeros when None.  a, b, c and h0 are
    float32 for the kernel.  Returns (y (B, S, di) in dt's dtype,
    h_final (B, di, N) float32).

    ``chunk`` caps the time steps the kernel stages in shared memory at
    once (the Pallas kernel's time block).  ``channel_block`` is the
    Pallas kernel's channel block, kept for the signature: the Hopper
    kernel's channel tile is one thread per (channel, n), 256 // N
    channels per block."""
    if chunk < 1 or channel_block < 1:
        raise ValueError(f"ssm_scan: chunk and channel_block must be >= 1, "
                         f"got {chunk}, {channel_block}")
    if h0 is None:
        h0 = torch.zeros((dt.shape[0], dt.shape[2], a.shape[1]),
                         dtype=torch.float32, device=dt.device)
    if dt.device.type == "cuda":
        return _kernel(dt, x, a, b, c, h0, chunk)
    if dt.device.type != "cpu":
        raise ValueError(f"no ssm_scan kernel for device {dt.device}")
    return ssm_scan_plain(dt, x, a, b, c, h0)


__all__ = ["ssm_scan", "ssm_scan_plain", "STATE_SIZES", "LAUNCHES"]
