"""The cost of a program, counted while it runs on the ``meta`` device.

This is the port's counterpart of ``repro/analysis/hlo.py``.  That module
re-derives FLOPs, bytes and collective bytes from XLA's post-SPMD HLO
text, because ``compiled.cost_analysis()`` counts each ``while`` body
once and a scan over layers is one such body.  The port has no HLO to
parse: PyTorch runs eagerly, a Python loop over layers runs every layer,
and so nothing is undercounted.  What takes the parser's place is
:class:`CostCounter`, a ``TorchDispatchMode`` that sees every ATen op as
it runs and counts

* FLOPs: matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 ×
  the result's elements × the contracted length) and convolutions (2 ×
  the result's elements × the inputs a result element reads);
  elementwise work is not counted, as ``hlo.py`` leaves it out of its
  dots;
* bytes: each operand read once and each result written once, for every
  op that moves data; views and allocations move nothing.

Over ``meta`` tensors no op computes anything, so a full-size program is
counted with no memory, no card and no data.

The hand-written kernels run outside ATen, through ``ctypes``, and
a dispatch mode cannot see a launch.  On a ``meta`` tensor each wrapper
calls its kernel's shape rule instead, an operator ``repro_torch::<name>``
that allocates the kernel's outputs on ``meta``; the counter sees that
call and prices it here (:data:`KERNEL_COSTS`), by the formulas
``chip_smoke.py`` also bounds the kernels with.  The shape rule is not a
fallback: a CUDA tensor still launches the kernel or raises, and a CPU
tensor still takes the plain version.

Collectives are not in the op stream either: on one card a collective is
a reduction over a rank-stacked tensor, and a constraint edge is the
identity.  :func:`collectives` reads them from the dataplane's records
(``core/telemetry.OpRecord``), which every edge and explicit collective
writes.

Every count is that of the logical program, all ranks' work together;
``launch/dryrun.py`` divides by the mesh's size for a per-device figure.
"""

from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# importing the wrappers registers their shape rules as operators
from repro_torch.kernels.dataplane import bounce, stall  # noqa: F401
from repro_torch.kernels.flash_attention import ops as _flash  # noqa: F401
from repro_torch.kernels.ssm_scan import ops as _ssm  # noqa: F401

_aten = torch.ops.aten

_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
_CONVS = {_aten.convolution.default, _aten._convolution.default}
# ops that allocate without writing, or only relabel a tensor
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_like.default,
             _aten.empty_strided.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.detach.default,
             _aten.lift_fresh.default}
SSM_FLOPS_PER_STATE_STEP = 6   # dt*a, exp, *h, dx*b, +, *c (+ reduction)
# the scan's backward a state element and step: the forward's state
# again (dt*a, exp, f*h, dx*b, +), the cotangent (gy*c, +, *f), gf =
# g*h_prev*f (2), its terms a*gf, g*b, h*gy, g*dx, dt*gf (5), the d a sum
# (1) and the four sums over N or channels (4)
SSM_BWD_FLOPS_PER_STATE_STEP = 20


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> int:
    if func is _aten.mm.default:
        a, b = args[0], args[1]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if func is _aten.addmm.default:
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is _aten.bmm.default else \
        (args[1], args[2])
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(args, out: torch.Tensor) -> int:
    w = args[1]                   # (out_ch, in_ch / groups, *kernel)
    return 2 * out.numel() * (w.numel() // w.shape[0])


@functools.lru_cache(maxsize=256)
def attention_pairs(sq: int, skv: int, causal: bool, window: int = 0,
                    valid_len: int | None = None) -> int:
    """(query, key) pairs whole-sequence attention scores: query row i of
    0..sq-1 sees keys below ``valid_len`` (default skv), from ``i -
    window + 1`` on with a window, and up to i when causal."""
    kv_end = skv if valid_len is None else min(int(valid_len), skv)
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, kv_end - 1) if causal else np.full_like(q, kv_end - 1)
    lo = np.maximum(q - window + 1, 0) if window else np.zeros_like(q)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(q_shape, skv: int, kv_heads: int, dtype_bytes: int, *,
               causal: bool = True, window: int = 0,
               valid_len: int | None = None,
               lse: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one flash-attention call: 4 x D operations a
    (query, key) pair a head (two products); q, k and v read and o
    written once, and the float32 lse written once when asked for."""
    b, sq, h, d = q_shape
    pairs = attention_pairs(sq, skv, bool(causal), int(window), valid_len)
    nbytes = (2 * b * sq * h + 2 * b * skv * kv_heads) * d * dtype_bytes
    return 4 * d * h * b * pairs, nbytes + (4 * b * h * sq if lse else 0)


def flash_bwd_cost(q_shape, skv: int, kv_heads: int, dtype_bytes: int, *,
                   causal: bool = True, window: int = 0) -> tuple[int, int]:
    """(operations, bytes) of one flash-attention backward: 10 x D
    operations a (query, key) pair a head (five products: q.k, dO.v,
    P^T dO, dS^T q, dS k) on the pairs the masks leave; q, k, v, o and
    dO read once, the float32 lse read once, dq, dk and dv written once."""
    b, sq, h, d = q_shape
    pairs = attention_pairs(sq, skv, bool(causal), int(window))
    nbytes = (4 * b * sq * h + 4 * b * skv * kv_heads) * d * dtype_bytes
    return 10 * d * h * b * pairs, nbytes + 4 * b * h * sq


def ssm_scan_cost(bsz: int, s: int, di: int, n: int,
                  dtype_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one selective scan: 6 operations a state
    element a step; dt, x and y once each in dt's dtype, b, c, a, h0 and
    h_final in float32."""
    nbytes = 3 * bsz * s * di * dtype_bytes + 4 * (
        2 * bsz * s * n + di * n + 2 * bsz * di * n)
    return SSM_FLOPS_PER_STATE_STEP * bsz * s * di * n, nbytes


def ssm_scan_bwd_cost(bsz: int, s: int, di: int, n: int,
                      dtype_bytes: int) -> tuple[int, int]:
    """(operations, bytes) of one scan backward: 20 operations a state
    element a step; dt, x, gy, d dt and d x once each in dt's dtype, b,
    c, d b, d c, a, d a, h0, the h_final cotangent and d h0 in float32."""
    nbytes = 5 * bsz * s * di * dtype_bytes + 4 * (
        4 * bsz * s * n + 2 * di * n + 3 * bsz * di * n)
    return SSM_BWD_FLOPS_PER_STATE_STEP * bsz * s * di * n, nbytes


def bounce_cost(numel: int, dtype_bytes: int,
                n_chunks: int, delay_iters: int) -> tuple[int, int]:
    """(operations, bytes) of one bounce launch: one fma (2 operations) a
    delay step, the delay split evenly over the chunks and rounded up;
    the payload read and written once, the int32 counters written."""
    ipc = -(-delay_iters // n_chunks) if delay_iters > 0 else 0
    return 2 * n_chunks * ipc, \
        2 * numel * dtype_bytes + 4 * n_chunks * bounce.NUM_COST_COLS


def _flash_op(args, out):
    q, k, _, causal, window, valid_len, lse = args
    return flash_cost(tuple(q.shape), k.shape[1], k.shape[2],
                      q.element_size(), causal=causal, window=window,
                      valid_len=valid_len, lse=lse)


def _flash_bwd_op(args, out):
    q, k, _, _, _, _, causal, window, _ = args
    return flash_bwd_cost(tuple(q.shape), k.shape[1], k.shape[2],
                          q.element_size(), causal=causal, window=window)


def _ssm_op(args, out):
    dt, _, a = args[:3]
    return ssm_scan_cost(*dt.shape, a.shape[1], dt.element_size())


def _ssm_bwd_op(args, out):
    dt, _, a = args[:3]
    return ssm_scan_bwd_cost(*dt.shape, a.shape[1], dt.element_size())


def _bounce_op(args, out):
    x, _, delay_iters, _ = args
    return bounce_cost(x.numel(), x.element_size(), out[1].shape[0],
                       delay_iters)


def _stall_op(args, out):
    return 2 * args[1], 4          # one fma a step, the one-word sink


# each hand kernel's shape-rule operator -> (its counter name, its cost
# (operations, bytes) from the call's arguments and outputs)
KERNEL_COSTS = {
    torch.ops.repro_torch.flash_attention.default:
        ("flash_attention", _flash_op),
    torch.ops.repro_torch.flash_attention_bwd.default:
        ("flash_attention_bwd", _flash_bwd_op),
    torch.ops.repro_torch.ssm_scan.default: ("ssm_scan", _ssm_op),
    torch.ops.repro_torch.ssm_scan_bwd.default:
        ("ssm_scan_bwd", _ssm_bwd_op),
    torch.ops.repro_torch.bounce.default: ("bounce", _bounce_op),
    torch.ops.repro_torch.bounce_stall.default: ("bounce_stall", _stall_op),
}


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of the ATen ops that run inside it, and
    of the hand kernels' shape rules (:data:`KERNEL_COSTS`).

    ``flops`` is ``matmul_flops`` (ATen's products and convolutions) plus
    the kernels' operations; ``bytes`` likewise.  ``ops`` counts ATen
    ops; ``kernels`` holds each kernel's ``{"calls", "flops", "bytes"}``."""

    def __init__(self):
        super().__init__()
        self.matmul_flops = 0
        self.op_bytes = 0
        self.ops = 0
        self.kernels: dict[str, dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in KERNEL_COSTS:
            name, price = KERNEL_COSTS[func]
            flops, nbytes = price(args, out)
            k = self.kernels[name]
            k["calls"] += 1
            k["flops"] += int(flops)
            k["bytes"] += int(nbytes)
            return out
        self.ops += 1
        if func in _MATMULS:
            self.matmul_flops += _matmul_flops(func, args)
        elif func in _CONVS:
            self.matmul_flops += _conv_flops(args, out)
        if not func.is_view and func not in _NO_BYTES:
            self.op_bytes += sum(
                _nbytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        return out

    @property
    def flops(self) -> int:
        return self.matmul_flops + sum(k["flops"]
                                       for k in self.kernels.values())

    @property
    def bytes(self) -> int:
        return self.op_bytes + sum(k["bytes"] for k in self.kernels.values())

    def result(self) -> dict:
        """``hlo.analyze``'s keys that the op stream gives, and the
        breakdown: ``flops``, ``bytes``, ``matmul_flops``, ``ops`` and
        ``kernels``."""
        return {"flops": self.flops, "bytes": self.bytes,
                "matmul_flops": self.matmul_flops, "ops": self.ops,
                "kernels": {n: dict(k) for n, k in self.kernels.items()}}


def _ways(axes, sizes: dict) -> int:
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def collectives(records, sizes: dict) -> dict:
    """``{kind: {"ops", "bytes"}}`` of dataplane records at the mesh's
    axis sizes: an explicit collective's record already holds one rank's
    shard; a constraint edge's holds the whole tensor, divided here over
    the mesh axes its spec names."""
    out: dict[str, dict[str, int]] = {}
    for rec in records:
        per = rec.bytes
        if rec.kind == "constraint":
            per //= _ways(rec.axes, sizes)
        d = out.setdefault(rec.kind, {"ops": 0, "bytes": 0})
        d["ops"] += rec.count
        d["bytes"] += per * rec.count
    return out


__all__ = ["CostCounter", "KERNEL_COSTS", "attention_pairs", "bounce_cost",
           "collectives", "flash_bwd_cost", "flash_cost", "ssm_scan_bwd_cost",
           "ssm_scan_cost"]
