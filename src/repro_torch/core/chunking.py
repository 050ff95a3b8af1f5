"""Chunked collective scheduling helpers: splitting a payload into
chunks and grouping a gradient tree into communication buckets.

Two of ``repro``'s ``core/chunking.py`` functions.  ``chunked_psum``
and ``schedule_batch`` (QoS-ordered issue of chunked collectives) are
ported with a later slice.
"""

from __future__ import annotations

import torch

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


__all__ = ["split_chunks", "bucket_pytree"]
