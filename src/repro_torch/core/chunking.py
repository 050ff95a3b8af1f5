"""Chunked collective scheduling — the QoS control CoRD gives the OS, as
a policy mechanism (issue order by priority class) and a performance one
(communication issued at a granularity the framework controls).

A large collective is split into chunks along its leading dim and each
chunk is issued through the dataplane separately, so the scheduler can
reorder them by QoS class (:func:`schedule_batch`) and rate-limit a
tenant chunk by chunk.  ``repro`` fences the chunks with optimization
barriers so XLA cannot merge them again; here the chunks are issued one
after another on one stream, and program order is issue order.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core import telemetry as tl
from repro_torch.core.policies import QoSPolicy
from repro_torch.core.tree import tree_flatten


def split_chunks(x: torch.Tensor, num_chunks: int,
                 axis: int = 0) -> list[torch.Tensor]:
    """Split ``x`` into ``num_chunks`` equal chunks along ``axis``.

    Uneven extents are padded with zeros on the tail chunk rather than
    collapsing to one chunk; callers slice the concatenated result back
    to the original extent."""
    n = x.shape[axis]
    num_chunks = max(1, min(num_chunks, n))
    rem = n % num_chunks
    if rem:
        pad = list(x.shape)
        pad[axis] = num_chunks - rem
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)],
                      dim=axis)
    return list(torch.split(x, x.shape[axis] // num_chunks, dim=axis))


def _preempt_bucket(dp, state, tenant: str | None):
    """The QoS bucket governing ``tenant`` on ``dp``, if chunk-granular
    preemption can run: policies enforced, runtime state threaded with
    the bucket's slice present, and the tenant rate-limited."""
    if state is None or not getattr(dp, "enforce", False):
        return None
    name = tenant or dp.tenant
    for p in dp.policies:
        if isinstance(p, QoSPolicy) and p.governs(name) and p.name in state:
            return p
    return None


def chunked_psum(dp, x: torch.Tensor, axis, *, num_chunks: int,
                 tag: str = "chunked_psum", qos: str = "default",
                 state=None, tenant: str | None = None,
                 interleave: Callable[[int], None] | None = None):
    """psum the rank-stacked ``x`` (R, n, ...) in ``num_chunks`` chunks of
    its per-rank leading dim, issued one after another.  Returns ``(out,
    state)``, ``out`` bit for bit ``dp.psum(x, axis)``'s; with runtime
    state threaded, the issuing tenant's ``chunks`` counter counts the
    chunks.

    **Wire preemption**: when the tenant is governed by an enforced QoS
    token bucket, each chunk consults the bucket before it is issued
    (``QoSPolicy.on_chunk_runtime``).  A chunk that meets a dry bucket
    stalls on the deficit on the card (the stall kernel reads the trip
    count there: nothing waits on the host) and is counted as
    throttled.  The stall delays the whole rank-stacked chunk
    once.  The chunks are issued ``precharged`` so the pipeline's
    token-bucket stage does not debit them again.

    ``interleave``, when given, is called with the chunk index before
    each chunk is issued, as in ``repro``: the caller's other work runs
    between the chunks.  (``repro``'s ``preempt`` argument has no caller
    and is not ported.)"""
    n = x.shape[1]
    chunks = split_chunks(x, num_chunks, axis=1)
    bucket = _preempt_bucket(dp, state, tenant)
    tname = tenant or dp.tenant
    ti = dp.tenant_index(tenant)
    outs = []
    for i, c in enumerate(chunks):
        if interleave is not None:
            interleave(i)
        if bucket is not None:
            rec = tl.OpRecord(kind="all_reduce", tag=f"{tag}/chunk{i}",
                              bytes=tl.nbytes(c[0]),
                              axes=tl.normalize_axes(axis),
                              mode=dp.cfg.mode, qos=qos, precharged=True)
            c, state = bucket.on_chunk_runtime(c, state, rec, tname, ti)
        r, state = dp.psum(c, axis, tag=f"{tag}/chunk{i}", qos=qos,
                           state=state, tenant=tenant,
                           precharged=bucket is not None)
        outs.append(r)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    if out.shape[1] != n:     # drop the tail chunk's padding rows
        out = out[:, :n]
    if state is not None and "counters" in state and len(chunks) > 1:
        ctrs = tl.tenant_counters_bump(state["counters"], ti,
                                       chunks=len(chunks))
        state = {**state, "counters": ctrs}
    return out, state


def bucket_pytree(tree, bucket_bytes: int) -> list[list[tuple]]:
    """Group the leaves of a nested dict, in ``jax.tree``'s order, into
    communication buckets of about ``bucket_bytes``.

    Returns a list of buckets; each bucket is a list of ``(path, leaf)``
    tuples.  The gradient sync issues the buckets in reverse order."""
    buckets: list[list[tuple]] = []
    cur: list[tuple] = []
    cur_bytes = 0
    for path, leaf in tree_flatten(tree):
        sz = leaf.numel() * leaf.element_size()
        if cur and cur_bytes + sz > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append((path, leaf))
        cur_bytes += sz
    if cur:
        buckets.append(cur)
    return buckets


def schedule_batch(qos: QoSPolicy | None,
                   ops: Sequence[tuple[str, Callable[[], torch.Tensor]]]):
    """Issue a batch of dataplane ops in QoS-priority order.

    ``ops`` is a sequence of ``(qos_class, thunk)``; the thunks run in
    priority order (a stable sort, so equal classes keep their order),
    which on one stream is their order on the card, and the results come
    back in the original order."""
    indexed = list(enumerate(ops))
    if qos is not None:
        indexed.sort(key=lambda kv: qos.priority(kv[1][0]))
    results = {}
    for idx, (_cls, thunk) in indexed:
        results[idx] = thunk()
    return [results[i] for i in range(len(ops))]


__all__ = ["split_chunks", "chunked_psum", "bucket_pytree",
           "schedule_batch"]
