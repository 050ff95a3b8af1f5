"""Gradient synchronization through the CoRD dataplane.

The framework's highest-volume communication path: every gradient
all-reduce is a dataplane op, so the policies see, account, schedule and
may compress it.  Gradients arrive rank-stacked (``launch/mesh.py``):
each leaf is (R, ...), slice ``r`` rank ``r``'s gradient.

  * **bucketing** — leaves are grouped into ~bucket_bytes buckets (by one
    rank's size), issued in reverse order: the last layers' gradients,
    produced first in the backward, sync first.
  * **QoS classes** — payload psums ride class ``grads``, the int8 scales
    ``grads-small``.
  * **int8 compression with error feedback** — per-leaf symmetric
    quantization before the all-reduce, dequantize after, the residual
    carried to the next step.
"""

from __future__ import annotations

import torch

from repro_torch.core.chunking import bucket_pytree
from repro_torch.core.tree import tree_flatten, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------

def quantize_int8(x: torch.Tensor):
    """``(q int8, scale float32)`` of one rank's tensor:
    ``scale = max|x| / 127 + 1e-12``, ``q = clip(round(x / scale), -127,
    127)``."""
    scale = x.abs().amax() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_error_feedback(g: torch.Tensor, err: torch.Tensor):
    """Returns (quantized, scale, new_error) of one rank's gradient."""
    total = g.to(torch.float32) + err
    q, scale = quantize_int8(total)
    recon = dequantize_int8(q, scale)
    return q, scale, total - recon


# ---------------------------------------------------------------------------
# dataplane-mediated sync
# ---------------------------------------------------------------------------

def sync_grads(dp, grads: dict, axis: str, *, bucket_bytes: int = 1 << 22,
               compression: str = "none", err_state=None, state=None):
    """All-reduce a rank-stacked gradient tree over mesh axis ``axis``
    through the dataplane; ``err_state`` is rank-stacked too, or None.

    Returns ``(mean_grads, new_err_state, state)`` — rank-stacked means
    (every rank's slice equal), the ranks' new residuals, and the threaded
    runtime state (None when not threaded)."""
    flat = tree_flatten(grads)
    paths = [path for path, _ in flat]
    leaves = [g for _, g in flat]
    n = dp.axis_size(axis)
    dev = leaves[0].device
    err_leaves = ([e for _, e in tree_flatten(err_state)]
                  if err_state is not None else [None] * len(leaves))

    # buckets by one rank's leaf; reverse order: the last layers' buckets
    # (produced first in the backward) sync first
    buckets = bucket_pytree(tree_map(lambda g: g[0], grads), bucket_bytes)
    bucket_leaf_ids, idx = [], 0
    for bucket in buckets:
        bucket_leaf_ids.append(list(range(idx, idx + len(bucket))))
        idx += len(bucket)

    flat_out: dict[int, torch.Tensor] = {}
    flat_err: dict[int, torch.Tensor] = {}
    for bi in reversed(range(len(buckets))):
        for li in bucket_leaf_ids[bi]:
            g = leaves[li]
            if compression == "int8" and g[0].numel() >= 1024:
                e = err_leaves[li]
                if e is None or e.shape != g.shape:
                    e = torch.zeros(g.shape, dtype=torch.float32, device=dev)
                # each rank quantizes its own gradient with its own scale
                q, scale, new_err = (torch.stack(t) for t in zip(
                    *(compress_error_feedback(g[i], e[i]) for i in range(n))))
                r, state = dp.psum(q.to(torch.int32), axis,
                                   tag=f"grads/bucket{bi}", qos="grads",
                                   state=state)
                s, state = dp.psum(scale, axis, tag=f"grads/scale{bi}",
                                   qos="grads-small", state=state)
                # mean of dequantized sums (scales averaged is an
                # approximation; error feedback absorbs the residual)
                s = s.reshape((n,) + (1,) * (r.dim() - 1))
                out = (r.to(torch.float32) * (s / n)) / n
                flat_err[li] = new_err
            else:
                r, state = dp.psum(g, axis, tag=f"grads/bucket{bi}",
                                   qos="grads", state=state)
                out = r / n
                flat_err[li] = (torch.zeros(g.shape, dtype=torch.float32,
                                            device=dev)
                                if compression == "int8" else
                                torch.zeros((n,), dtype=torch.float32,
                                            device=dev))
            flat_out[li] = out.to(leaves[li].dtype)

    mean = tree_unflatten(paths, [flat_out[i] for i in range(len(leaves))])
    new_err = tree_unflatten(paths, [flat_err[i] for i in range(len(leaves))])
    return mean, new_err, state


def err_state_init(params: dict, compression: str = "none"):
    """The error-feedback state of one rank (None without compression):
    zeros of each leaf of at least 1024 elements, a 0-d zero for the
    smaller ones."""
    if compression != "int8":
        return None
    return tree_map(lambda p: (torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                               if p.numel() >= 1024 else
                               torch.zeros((), dtype=torch.float32,
                                           device=p.device)), params)


__all__ = ["sync_grads", "err_state_init", "quantize_int8",
           "dequantize_int8", "compress_error_feedback"]
