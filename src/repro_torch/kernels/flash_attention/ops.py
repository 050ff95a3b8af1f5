"""Public wrappers for the flash-attention kernels
(``csrc/flash_attention.cu``): the forward and its gradient.

Both take the framework's (B, S, H, D) layout and GQA shapes.  Given
CUDA tensors each launches its Hopper kernel (or raises); given CPU
tensors it runs the plain version; given ``meta`` tensors it calls an
operator with a Meta kernel only, the kernel's shape rule, which
allocates the kernel's outputs there and which a dispatch mode sees
(``analysis/cost.py`` prices it).

:func:`flash_attention`, the forward, with the runtime window /
valid-length scalars: plain version ``ref.flash_attention_ref``,
operator ``repro_torch::flash_attention``.  ``LAUNCHES`` counts its
launches and ``LSE_LAUNCHES`` those of them that also wrote the
log-sum-exp.  ``return_lse=True`` adds each row's natural-log
log-sum-exp of its scaled, soft-capped logits, (B, KVH, G, Sq) float32
as ``repro``'s ``_flash_fwd_impl`` returns it, for the training
backward.  A call whose masks leave some query row with no key is
refused then: such a row has no log-sum-exp.  The bf16 kernel (wgmma on
64-column panels) takes D in {64, 128, 256}; bf16 q/k/v with D of 16 or
32 are zero-padded to 64 here, which leaves every dot product as it was,
and the scale stays 1/sqrt(D).  The f32 kernel takes every D of
:data:`HEAD_DIMS` as it is and runs its products on the tensor cores too
(``mma.sync``), as three TF32 products for each f32 product, which keeps
about f32 accuracy.

:func:`flash_attention_bwd`, the gradient (dq, dk, dv) of the forward
with lse: plain version ``ref.flash_attention_bwd_plain``, operator
``repro_torch::flash_attention_bwd``.  ``BWD_LAUNCHES`` counts its
launches, one a call (three to five CUDA kernels: the delta rows, a
dK/dV pass, a dQ pass and, where the grid is too small for the card, an
in-order sum of each pass's partials).  Its bf16 kernels run all five
products (Q.K^T, dO.V^T, P^T.dO, dS^T.Q, dS.K) as wgmma on 64 x 64 tiles
that TMA brings through a ring in shared memory: the dK/dV pass keeps a
kv tile's K and V resident and streams the group's q tiles, one
warpgroup accumulating dV and one dK; the dQ pass keeps a q tile
resident and streams the kv tiles.  They take D in {64, 128, 256};
bf16 with D of 16 or 32 is zero-padded to 64 here, as for the forward,
and the gradients are cut back to D.  The f32 kernels take every D of
:data:`HEAD_DIMS` as it is, with the same two passes, each warp a 16-row
band of the resident tile, and run all five products on the tensor cores
as three TF32 products for each f32 one.  No atomics: two calls give the
same bits.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain,
    flash_attention_ref,
)

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_BF16_MIN_D = 64       # the bf16 kernel's panel width
_ERR_TENSOR_MAP = 10001   # flash_attention_launch's code beside cudaError_t

# kernel launches since the count was last set to 0: the forward, those
# of them with the lse, the backward
LAUNCHES = 0
LSE_LAUNCHES = 0
BWD_LAUNCHES = 0


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          logit_cap: float = 0.0, valid_len=None,
                          return_lse: bool = False):
    """The kernel's plain version in the (B, S, H, D) layout, any device."""
    if return_lse:
        _check_rows(q, k, causal, window, valid_len)
    out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), window=int(window or 0),
                              valid_len=valid_len, causal=causal,
                              logit_cap=logit_cap, return_lse=return_lse)
    if not return_lse:
        return out.transpose(1, 2)
    o, lse = out
    return o.transpose(1, 2), _lse_view(lse, k.shape[2])


def _lse_view(lse, kvh: int):
    """(B, H, Sq) as ``repro``'s (B, KVH, G, Sq): the same memory."""
    b, h, sq = lse.shape
    return lse.reshape(b, kvh, h // kvh, sq)


def _check_rows(q, k, causal: bool, window, valid_len) -> None:
    """Refuse masks that leave a query row with no key.  Query row i of
    0..Sq-1 sees keys below kv_end = min(valid_len, Skv), from i - window
    + 1 on with a window, and up to i when causal; the first and last
    rows are the first to run empty."""
    sq, skv = q.shape[1], k.shape[1]
    kv_end = min(skv if valid_len is None else int(valid_len), skv)
    w = int(window or 0)
    if kv_end < 1 or (w > 0 and kv_end < sq - w + 1):
        raise ValueError(f"flash_attention with lse: a query row has no "
                         f"key (Sq {sq}, kv_end {kv_end}, window {w}, "
                         f"causal {causal})")


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention wants q (B,S,H,D), k/v (B,S,KVH,D);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f" k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned")
        if t.device != q.device:
            raise ValueError("flash_attention: q/k/v on different devices")


# q, k, v, o, lse; dtype, B, Sq, Skv, H, KVH, D, causal, window,
# valid_len; logit_cap, scale; stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
    [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_FN = None


def _bind():
    """The launch function, built and bound on first use."""
    global _FN
    _FN = build.function("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
    return _FN


def _panel_pad(*ts):
    """bf16 tensors of D 16 or 32 zero-padded to the bf16 kernels' 64-column
    panel, which leaves every dot product and row sum as it was; other
    tensors as they are."""
    d = ts[0].shape[-1]
    if ts[0].dtype != torch.bfloat16 or d >= _BF16_MIN_D:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, _BF16_MIN_D - d))
                 for t in ts)


def _kernel(q, k, v, *, causal, window, logit_cap, valid_len,
            return_lse=False):
    global LAUNCHES, LSE_LAUNCHES
    _check(q, k, v)
    if return_lse:
        _check_rows(q, k, causal, window, valid_len)
    d = q.shape[3]
    scale = 1.0 / math.sqrt(d)
    q, k, v = _panel_pad(q, k, v)
    b, sq, h, dk = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    err = (_FN or _bind())(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPES[q.dtype], b, sq, skv, h, kvh, dk, int(bool(causal)),
        int(window or 0), int(skv if valid_len is None else valid_len),
        float(logit_cap), scale, build.raw_stream(q.get_device()))
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("flash_attention_launch: cuTensorMapEncodeTiled "
                           "refused a tensor map")
    build.check(err, "flash_attention_launch")
    LAUNCHES += 1
    o = o if dk == d else o[..., :d].contiguous()
    if lse is None:
        return o
    LSE_LAUNCHES += 1
    return o, _lse_view(lse, kvh)


def _meta_outputs(q, k, v, causal, window, valid_len, return_lse):
    """The kernel's outputs on ``meta``: o and the (B, H, Sq) lse."""
    b, sq, h, _ = q.shape
    return torch.empty_like(q), torch.empty((b, h, sq), dtype=torch.float32,
                                            device=q.device)


# the shape rule as an operator with a Meta kernel only, so that a
# dispatch mode sees the call with its arguments; the card's launch stays
# a direct ``ctypes`` call, off the dispatcher's host cost
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int? valid_len, bool return_lse) -> (Tensor, Tensor)")
_LIB.impl("flash_attention", _meta_outputs, "Meta")
_shape_rule = torch.ops.repro_torch.flash_attention


def _meta(q, k, v, *, causal, window, logit_cap, valid_len,
          return_lse=False):
    _check(q, k, v)
    if return_lse:
        _check_rows(q, k, causal, window, valid_len)
    o, lse = _shape_rule(q, k, v, bool(causal), int(window or 0),
                         None if valid_len is None else int(valid_len),
                         bool(return_lse))
    return (o, _lse_view(lse, k.shape[2])) if return_lse else o


def tensor_map_ns(q, k, v, iters: int = 1000) -> float:
    """Host nanoseconds the bf16 kernel's launch spends encoding the three
    TMA tensor maps of one call (q/k/v on the card, D >= 64)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    fn = build.function("flash_attention", "flash_attention_map_ns",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7,
                        restype=ctypes.c_double)
    ns = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, k.shape[1], h,
            k.shape[2], d, iters)
    if ns < 0:
        raise RuntimeError("flash_attention_map_ns: encoding failed")
    return ns


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    logit_cap: float = 0.0, valid_len=None,
                    return_lse: bool = False):
    """q: (B, Sq, H, D); k/v: (B, Skv, KVH, D).  Query positions are
    0..Sq-1 and key positions 0..Skv-1.  ``window``: int (0/None =
    global).  ``valid_len``: filled kv length; defaults to Skv.  Returns
    o, or (o, lse) with ``return_lse``."""
    window = int(window or 0)
    kw = dict(causal=causal, window=window, logit_cap=logit_cap,
              valid_len=valid_len, return_lse=return_lse)
    if q.device.type == "cuda":
        return _kernel(q, k, v, **kw)
    if q.is_meta:
        return _meta(q, k, v, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return flash_attention_plain(q, k, v, **kw)


# q, k, v, o, do, lse, delta, dq, dk, dv, scratch; dtype, B, Sq, Skv, H,
# KVH, D, causal, window; logit_cap, scale; sms; stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + \
    [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_FN = None


def _check_bwd(q, k, v, o, lse, do) -> None:
    """What :func:`_check` asks of q, k and v, and of the rest: o and do
    like q, lse (B, KVH, G, Sq) float32, all contiguous on q's device, do
    16-byte aligned as q."""
    _check(q, k, v)
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} must be like q "
                             f"({q.dtype} {tuple(q.shape)}), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lse.shape != (b, kvh, h // kvh, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be float32 of shape "
                         f"{(b, kvh, h // kvh, sq)}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    for name, t in (("o", o), ("do", do), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous")
        if name == "do" and t.data_ptr() % 16:
            raise ValueError("flash_attention_bwd: do must be 16-byte "
                             "aligned")
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: inputs on different "
                             "devices")


def _bind_bwd():
    """The backward's launch function, built and bound on first use."""
    global _BWD_FN
    _BWD_FN = build.function("flash_attention", "flash_attention_bwd_launch",
                             _BWD_ARGTYPES)
    return _BWD_FN


@functools.lru_cache(maxsize=256)
def _bwd_scratch(dtype: int, b: int, sq: int, skv: int, h: int, kvh: int,
                 d: int, sms: int) -> int:
    """f32 scratch the backward kernel takes for this dtype and shape on a
    card of ``sms`` SMs: the partial sums of the runs it cuts dK/dV and dQ
    into to fill the card."""
    fn = build.function("flash_attention", "flash_attention_bwd_scratch",
                        [ctypes.c_int] * 8, restype=ctypes.c_longlong)
    return fn(dtype, b, sq, skv, h, kvh, d, sms)


def _bwd_kernel(q, k, v, o, lse, do, *, causal, window, logit_cap):
    global BWD_LAUNCHES
    o, do = o.contiguous(), do.contiguous()
    _check_bwd(q, k, v, o, lse, do)
    fn = _BWD_FN or _bind_bwd()
    d = q.shape[3]
    scale = 1.0 / math.sqrt(d)
    q, k, v, o, do = _panel_pad(q, k, v, o, do)
    b, sq, h, dpad = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dev = q.get_device()
    sms = build.sm_count(dev)
    n_scratch = _bwd_scratch(_DTYPES[q.dtype], b, sq, skv, h, kvh, dpad, sms)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    scratch = delta.new_empty((n_scratch,)) if n_scratch else None
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             _DTYPES[q.dtype], b, sq, skv, h, kvh, dpad, int(bool(causal)),
             int(window or 0), float(logit_cap), scale, sms,
             build.raw_stream(dev))
    if err == _ERR_TENSOR_MAP:
        raise RuntimeError("flash_attention_bwd_launch: "
                           "cuTensorMapEncodeTiled refused a tensor map")
    build.check(err, "flash_attention_bwd_launch")
    BWD_LAUNCHES += 1
    if dpad != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


# the backward's shape rule: dq, dk, dv like q, k, v
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor dout, bool causal, int window, "
            "float logit_cap) -> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention_bwd",
          lambda q, k, v, o, lse, dout, causal, window, logit_cap: (
              torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)),
          "Meta")
_bwd_shape_rule = torch.ops.repro_torch.flash_attention_bwd


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window=None, logit_cap: float = 0.0,
                        q_block: int = 512, kv_block: int = 1024):
    """(dq, dk, dv) of :func:`flash_attention` with its lse, each in its
    input's dtype: q, o, do (B, Sq, H, D); k, v (B, Skv, KVH, D); lse
    (B, KVH, G, Sq) float32 as the forward returned it; every key below
    Skv valid.  The Hopper kernel on a CUDA tensor, the plain version
    (``q_block`` x ``kv_block`` blocks, as ``repro``'s ``_flash_bwd``) on
    the CPU, the shape rule on ``meta``."""
    window = int(window or 0)
    kw = dict(causal=causal, window=window, logit_cap=logit_cap)
    if q.device.type == "cuda":
        return _bwd_kernel(q, k, v, o, lse, do, **kw)
    if q.is_meta:
        o, do = o.contiguous(), do.contiguous()
        _check_bwd(q, k, v, o, lse, do)
        return _bwd_shape_rule(q, k, v, o, lse, do, bool(causal), window,
                               float(logit_cap))
    if q.device.type != "cpu":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    return flash_attention_bwd_plain(q, k, v, o, lse, do, q_block=q_block,
                                     kv_block=kv_block, **kw)


__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_bwd",
           "tensor_map_ns", "HEAD_DIMS", "LAUNCHES", "LSE_LAUNCHES",
           "BWD_LAUNCHES"]
