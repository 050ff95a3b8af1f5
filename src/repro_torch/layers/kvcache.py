"""KV caches for serving: the fixed per-slot stripe layout.

A cache is ``{"k": (layers, batch, max_len, kv_heads, head_dim), "v":
...}``.  The serving engine preallocates ONE such cache whose batch rows
are long-lived *slots*: a request is prefilled alone (batch 1, prompt
length bucketed), its cache written into a free slot with
:func:`kv_slot_insert`, and the fixed-shape decode step advances every
slot at its own position (:func:`kv_update_slots`) behind a per-slot
validity mask (:func:`slot_validity`).

Unlike ``repro``'s functional updates, the update helpers here write
**in place** into the cache tensors they are given (and return them), so
a decode tick never copies the whole cache.  The paged block pool waits
for a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

# logical axis names of a (layers, batch, kv_seq, kv_heads, head_dim) cache
KV_CACHE_AXES = (None, "batch", "kv_seq", "kv_heads", "head_dim")


def kv_cache_init(layers: int, batch: int, max_len: int, kv_heads: int,
                  head_dim: int, dtype=torch.bfloat16, device=None) -> dict:
    shape = (layers, batch, max_len, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def kv_update(cache_k: torch.Tensor, cache_v: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, pos: int):
    """Write (B, s, KVH, hd) keys/values at position ``pos`` of one layer's
    (B, S_max, KVH, hd) cache, in place."""
    s = k.shape[1]
    cache_k[:, pos:pos + s] = k.to(cache_k.dtype)
    cache_v[:, pos:pos + s] = v.to(cache_v.dtype)
    return cache_k, cache_v


def kv_update_slots(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
    """Per-slot write, in place: one (B, 1, KVH, hd) token per slot at
    per-slot positions ``pos`` (B,)."""
    if k.shape[1] != 1:
        raise ValueError("kv_update_slots writes one token per slot")
    rows = torch.arange(cache_k.shape[0], device=cache_k.device)
    pos = pos.to(device=cache_k.device, dtype=torch.long)
    cache_k[rows, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, pos] = v[:, 0].to(cache_v.dtype)
    return cache_k, cache_v


def kv_slot_insert(cache: dict, prefilled: dict, slot: int) -> dict:
    """Write one prefilled request's cache (batch dim 1) into slot ``slot``
    of a persistent slot cache, in place.  Positions beyond the prefill
    capacity keep what the slot held; the validity mask hides them."""
    for name, dst in cache.items():
        src = prefilled[name]
        dst[:, slot:slot + 1, :src.shape[2]] = src.to(dst.dtype)
    return cache


def state_slot_insert(cache: dict, prefilled: dict, slot: int, *,
                      batch_axis: int = 1) -> dict:
    """Family-agnostic slot insert, in place: write the batch-1 source into
    row ``slot`` (on ``batch_axis``) of every tensor of the cache, over
    the source's leading extent on every other axis."""
    for name, dst in cache.items():
        src = prefilled[name]
        idx = tuple(slice(slot, slot + 1) if d == batch_axis
                    else slice(0, src.shape[d]) for d in range(dst.dim()))
        dst[idx] = src.to(dst.dtype)
    return cache


def slot_vectors_init(slots: int) -> dict:
    """Per-slot host bookkeeping: next write position, active flag and
    tenant index (−1 = free)."""
    return {
        "pos": np.zeros((slots,), np.int32),
        "active": np.zeros((slots,), bool),
        "tenant": np.full((slots,), -1, np.int32),
    }


def slot_validity(max_len: int, pos: torch.Tensor) -> torch.Tensor:
    """(B, max_len) mask of cache entries visible to each slot decoding at
    per-slot position ``pos`` (inclusive)."""
    return (torch.arange(max_len, dtype=torch.int32, device=pos.device)[None, :]
            <= pos.to(torch.int32)[:, None])


def kv_cache_constrain(dp, cache, *, tag: str = "kvcache",
                       qos: str = "kvcache", tenant: str | None = None):
    """Issue the KV cache's sharding edges through the dataplane (rank-5
    leaves only).  A no-op without a dataplane."""
    if dp is None or not isinstance(cache, dict):
        return cache
    return {k: (dp.constrain(v, KV_CACHE_AXES, tag=f"{tag}/{k}", qos=qos,
                             tenant=tenant)
                if isinstance(v, torch.Tensor) and v.dim() == 5 else v)
            for k, v in cache.items()}


__all__ = ["kv_cache_init", "kv_update", "kv_update_slots", "kv_slot_insert",
           "state_slot_insert", "slot_vectors_init", "slot_validity",
           "kv_cache_constrain", "KV_CACHE_AXES"]
