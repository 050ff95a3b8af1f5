"""Public wrappers for the SSM-scan kernels (``csrc/ssm_scan.cu``).

Given CUDA tensors each launches its Hopper kernel (or raises); given
CPU tensors it runs the plain version; given ``meta`` tensors it calls
an operator with a Meta kernel only, the kernel's shape rule, which a
dispatch mode sees (``analysis/cost.py`` prices it).

* :func:`ssm_scan`, the forward: plain version ``ref.ssm_scan_ref``,
  operator ``repro_torch::ssm_scan``.  Unlike ``repro``'s wrapper it
  pads nothing: the kernel takes any sequence length.  The kernel scans
  time chunks in parallel and carries the state between them
  (:func:`chunk_plan` cuts the sequence); ``ref.py`` mirrors that
  algorithm in plain torch for the tests.  ``LAUNCHES`` counts calls
  that launched it: one CUDA launch for a one-chunk scan (decode, short
  prompts), three for a chunked one (chunk states, carry, scan).
* :func:`ssm_scan_bwd`, the gradient of (y, h_final): plain version
  ``ref.ssm_scan_bwd_plain`` (float64, as the kernel computes),
  operator ``repro_torch::ssm_scan_bwd``.  ``repro`` has no backward
  kernel: XLA differentiates its chunked scan.  ``BWD_LAUNCHES`` counts
  calls that launched the backward kernel (two CUDA launches a call: the
  gradient kernel, which walks each chain in 8-step tiles, and the sum of
  its per-block d a, d b and d c in a fixed order);
  ``ref.ssm_scan_bwd_tiled_ref`` mirrors its algorithm for the tests.

:class:`SSMScan` is the scan with a gradient: the kernel forward and the
kernel backward on a CUDA tensor, the plain versions on the CPU or with
``plain=True``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_plain, ssm_scan_ref

STATE_SIZES = (1, 2, 4, 8, 16, 32)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel calls since the count was last set to 0: forward, backward
LAUNCHES = 0
BWD_LAUNCHES = 0

CHANNELS_PER_BLOCK = 128   # one thread per channel (csrc/ssm_scan.cu)
MIN_CHUNK_STEPS = 16       # shorter sequences keep one chunk
BLOCKS_PER_SM = 4          # the chunk count aims at this many blocks a SM
DEFAULT_SMS = 132          # H100 SXM

# dt, x, a, b, c, h0, y, hf, agg; dtype, B, S, di, N, chunk_len,
# n_chunks, tile; stream
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_FN = None
F32 = torch.float32


@functools.lru_cache(maxsize=1024)
def chunk_plan(bsz: int, s: int, di: int, sms: int = DEFAULT_SMS,
               n_chunks: int | None = None) -> tuple[int, int]:
    """``(chunk_len, n_chunks)``: the kernel's cut of ``s`` time steps into
    chunks scanned in parallel.  Without ``n_chunks`` it asks for enough
    chunks that the grid (``bsz * ceil(di / 128)`` blocks a chunk) fills
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs, with no chunk shorter
    than ``MIN_CHUNK_STEPS`` steps, so decode and short prompts keep one
    chunk.  Every chunk has ``chunk_len`` steps but the last, which has
    1..chunk_len: the chunks cover ``s`` exactly and none is empty (a
    requested count is lowered where it would leave one empty)."""
    if n_chunks is None:
        blocks = bsz * -(-di // CHANNELS_PER_BLOCK)
        n_chunks = min(-(-sms * BLOCKS_PER_SM // blocks),
                       s // MIN_CHUNK_STEPS)
    n_chunks = max(1, min(n_chunks, s))
    chunk_len = -(-s // n_chunks)
    return chunk_len, -(-s // chunk_len)


def ssm_scan_plain(dt, x, a, b, c, h0):
    """The kernel's plain version on any device: y in dt's dtype, h_final
    in float32."""
    y, hf = ssm_scan_ref(dt, x, a, b, c, h0)
    return y.to(dt.dtype), hf


def _check(dt, x, a, b, c, h0) -> int:
    """Raise ``ValueError`` on inputs the kernel does not take; return the
    inputs' device index.  One pass of cheap tests on the common path; the
    tests that name the fault run only when that pass fails."""
    shp = dt.shape
    dev = dt.get_device()
    if len(shp) == 3:
        bsz, s, di = shp
        n = a.shape[-1]
        if (x.shape == shp and a.shape == (di, n) and b.shape == (bsz, s, n)
                and c.shape == b.shape and h0.shape == (bsz, di, n)
                and n in STATE_SIZES and dt.dtype in _DTYPES
                and x.dtype == dt.dtype and a.dtype == F32
                and b.dtype == F32 and c.dtype == F32 and h0.dtype == F32
                and dt.is_contiguous() and x.is_contiguous()
                and a.is_contiguous() and b.is_contiguous()
                and c.is_contiguous() and h0.is_contiguous()
                and x.get_device() == dev and a.get_device() == dev
                and b.get_device() == dev and c.get_device() == dev
                and h0.get_device() == dev):
            return dev
    _explain(dt, x, a, b, c, h0)
    return dev


def _explain(dt, x, a, b, c, h0) -> None:
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
        if t.dtype != F32:
            raise ValueError(f"ssm_scan kernel: {name} must be float32, got "
                             f"{t.dtype}")
    for name, t in (("dt", dt), ("x", x), ("a", a), ("b", b), ("c", c),
                    ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
        if t.device != dt.device:
            raise ValueError("ssm_scan: inputs on different devices")


def _bind():
    """The launch function, built and bound on first use."""
    global _FN
    _FN = build.function("ssm_scan", "ssm_scan_launch", _ARGTYPES)
    return _FN


def _kernel(dt, x, a, b, c, h0, chunk: int):
    global LAUNCHES
    dev = _check(dt, x, a, b, c, h0)
    bsz, s, di = dt.shape
    n = a.shape[1]
    chunk_len, n_chunks = chunk_plan(bsz, s, di, build.sm_count(dev))
    y = torch.empty_like(dt)
    hf = torch.empty_like(h0)
    agg = None
    if n_chunks > 1:     # chunk end states and decays
        agg = dt.new_empty((2 * bsz * (n_chunks - 1) * di * n,), dtype=F32)
    err = (_FN or _bind())(
        dt.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
        c.data_ptr(), h0.data_ptr(), y.data_ptr(), hf.data_ptr(),
        agg.data_ptr() if agg is not None else None,
        _DTYPES[dt.dtype], bsz, s, di, n, chunk_len, n_chunks, chunk,
        build.raw_stream(dev))
    if err:
        build.check(err, "ssm_scan_launch")
    LAUNCHES += 1
    return y, hf


# the shape rule (y and h_final on ``meta``) as an operator with a Meta
# kernel only, so that a dispatch mode sees the call with its arguments;
# the card's launch stays a direct ``ctypes`` call, off the dispatcher's
# host cost
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssm_scan(Tensor dt, Tensor x, Tensor a, Tensor b, Tensor c, "
            "Tensor h0) -> (Tensor, Tensor)")
_LIB.impl("ssm_scan", lambda dt, x, a, b, c, h0: (torch.empty_like(dt),
                                                  torch.empty_like(h0)),
          "Meta")
_shape_rule = torch.ops.repro_torch.ssm_scan


def _meta(dt, x, a, b, c, h0):
    if not all(t.is_meta for t in (x, a, b, c, h0)):
        raise ValueError("ssm_scan: inputs on different devices")
    _check(dt, x, a, b, c, h0)
    return _shape_rule(dt, x, a, b, c, h0)


def ssm_scan(dt, x, a, b, c, h0=None, *, chunk: int = 128,
             channel_block: int = 256):
    """Selective scan.  dt/x: (B, S, di) float32 or bfloat16; a: (di, N);
    b/c: (B, S, N); h0: (B, di, N), zeros when None.  a, b, c and h0 are
    float32 for the kernel.  Returns (y (B, S, di) in dt's dtype,
    h_final (B, di, N) float32).

    ``chunk`` is the Pallas kernel's time block; on the Hopper kernel it
    caps the time steps staged in shared memory at once (at most 16).
    The time chunks that the Hopper kernel scans in parallel are its own
    (:func:`chunk_plan`), not ``chunk``.  ``channel_block`` is the Pallas
    kernel's channel block, kept for the signature: the Hopper kernel
    runs one thread per channel, 128 channels per block."""
    if chunk < 1 or channel_block < 1:
        raise ValueError(f"ssm_scan: chunk and channel_block must be >= 1, "
                         f"got {chunk}, {channel_block}")
    if h0 is None:
        h0 = torch.zeros((dt.shape[0], dt.shape[2], a.shape[1]),
                         dtype=torch.float32, device=dt.device)
    if dt.is_cuda:
        return _kernel(dt, x, a, b, c, h0, chunk)
    if dt.is_meta:
        return _meta(dt, x, a, b, c, h0)
    if dt.device.type != "cpu":
        raise ValueError(f"no ssm_scan kernel for device {dt.device}")
    return ssm_scan_plain(dt, x, a, b, c, h0)


# dt, x, a, b, c, h0, gy, ghf, ddt, dx, da, db, dc, dh0, work; dtype, B,
# S, di, N; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + \
    [ctypes.c_void_p]
_BWD_FN = None


def _check_bwd(dt, x, a, b, c, h0, gy, ghf) -> int:
    """:func:`_check` and the cotangents: gy as dt (or None), ghf as h0
    (or None), contiguous, on the same card.  Returns the device index."""
    dev = _check(dt, x, a, b, c, h0)
    if ((gy is None or (gy.shape == dt.shape and gy.dtype == dt.dtype
                        and gy.is_contiguous() and gy.get_device() == dev))
            and (ghf is None or (ghf.shape == h0.shape and ghf.dtype == F32
                                 and ghf.is_contiguous()
                                 and ghf.get_device() == dev))):
        return dev
    _explain_bwd(dt, h0, gy, ghf)
    return dev


def _explain_bwd(dt, h0, gy, ghf) -> None:
    for name, t, like, dtype in (("gy", gy, dt, dt.dtype),
                                 ("ghf", ghf, h0, F32)):
        if t is None:
            continue
        if t.shape != like.shape or t.dtype != dtype:
            raise ValueError(f"ssm_scan_bwd: {name} must be {dtype} of shape "
                             f"{tuple(like.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_bwd: {name} must be contiguous")
        if t.device != dt.device:
            raise ValueError("ssm_scan_bwd: inputs on different devices")


def _bind_bwd():
    """The backward's launch function, built and bound on first use."""
    global _BWD_FN
    _BWD_FN = build.function("ssm_scan", "ssm_scan_bwd_launch",
                             _BWD_ARGTYPES)
    return _BWD_FN


@functools.lru_cache(maxsize=256)
def _bwd_scratch(bsz: int, s: int, di: int, n: int) -> int:
    """Doubles of scratch the backward kernel takes at this shape."""
    fn = build.function("ssm_scan", "ssm_scan_bwd_scratch",
                        [ctypes.c_int] * 4, restype=ctypes.c_longlong)
    return fn(bsz, s, di, n)


def _bwd_kernel(dt, x, a, b, c, h0, gy, ghf):
    global BWD_LAUNCHES
    gy = None if gy is None else gy.contiguous()
    ghf = None if ghf is None else ghf.contiguous()
    dev = _check_bwd(dt, x, a, b, c, h0, gy, ghf)
    fn = _BWD_FN or _bind_bwd()
    bsz, s, di = dt.shape
    n = a.shape[1]
    work = dt.new_empty((_bwd_scratch(bsz, s, di, n),), dtype=torch.float64)
    grads = tuple(torch.empty_like(t) for t in (dt, x, a, b, c, h0))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(dt.data_ptr(), x.data_ptr(), a.data_ptr(), b.data_ptr(),
             c.data_ptr(), h0.data_ptr(), ptr(gy), ptr(ghf),
             *(g.data_ptr() for g in grads), work.data_ptr(),
             _DTYPES[dt.dtype], bsz, s, di, n, build.raw_stream(dev))
    if err:
        build.check(err, "ssm_scan_bwd_launch")
    BWD_LAUNCHES += 1
    return grads


# the backward's shape rule: the six gradients, each like its input
_LIB.define("ssm_scan_bwd(Tensor dt, Tensor x, Tensor a, Tensor b, "
            "Tensor c, Tensor h0, Tensor? gy, Tensor? ghf) -> (Tensor, "
            "Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("ssm_scan_bwd",
          lambda dt, x, a, b, c, h0, gy, ghf: tuple(
              torch.empty_like(t) for t in (dt, x, a, b, c, h0)), "Meta")
_bwd_shape_rule = torch.ops.repro_torch.ssm_scan_bwd


def ssm_scan_bwd(dt, x, a, b, c, h0, gy, ghf):
    """Gradients (d dt, d x, d a, d b, d c, d h0) of ``(y, h_final) =
    ssm_scan(dt, x, a, b, c, h0)`` for the cotangents ``gy`` (B, S, di,
    dt's dtype) and ``ghf`` (B, di, N, float32); either may be None
    (zero).  Each gradient has its input's dtype.  The Hopper kernel on a
    CUDA tensor (it takes what :func:`ssm_scan`'s kernel takes), its plain
    version ``ref.ssm_scan_bwd_plain`` on the CPU, the shape rule on
    ``meta``; both compute in float64."""
    if dt.is_cuda:
        return _bwd_kernel(dt, x, a, b, c, h0, gy, ghf)
    if dt.is_meta:
        gy = None if gy is None else gy.contiguous()
        ghf = None if ghf is None else ghf.contiguous()
        if not all(t is None or t.is_meta for t in (x, a, b, c, h0, gy, ghf)):
            raise ValueError("ssm_scan_bwd: inputs on different devices")
        _check_bwd(dt, x, a, b, c, h0, gy, ghf)
        return _bwd_shape_rule(dt, x, a, b, c, h0, gy, ghf)
    if dt.device.type != "cpu":
        raise ValueError(f"no ssm_scan_bwd kernel for device {dt.device}")
    return ssm_scan_bwd_plain(dt, x, a, b, c, h0, gy, ghf)


class SSMScan(torch.autograd.Function):
    """The selective scan with a gradient.  On a CUDA tensor the forward
    is :func:`ssm_scan`'s kernel and the backward :func:`ssm_scan_bwd`'s;
    on the CPU both wrappers take their plain versions.  With
    ``plain=True`` the forward is :func:`ssm_scan_plain` and the backward
    ``ref.ssm_scan_bwd_plain`` on any device, so the card can hold the
    kernels against them inside the same function.  The backward works
    from the saved inputs and recomputes the states a chunk at a time.
    Returns (y, h_final)."""

    @staticmethod
    def forward(ctx, dt, x, a, b, c, h0, plain):
        fwd = ssm_scan_plain if plain else ssm_scan
        y, hf = fwd(dt, x, a, b, c, h0)
        ctx.save_for_backward(dt, x, a, b, c, h0)
        ctx.plain = plain
        return y, hf

    @staticmethod
    def backward(ctx, gy, ghf):
        bwd = ssm_scan_bwd_plain if ctx.plain else ssm_scan_bwd
        grads = bwd(*ctx.saved_tensors, gy, ghf)
        return (*grads, None)


__all__ = ["ssm_scan", "ssm_scan_plain", "ssm_scan_bwd", "chunk_plan",
           "SSMScan", "STATE_SIZES", "LAUNCHES", "BWD_LAUNCHES"]
