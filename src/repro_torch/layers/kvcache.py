"""KV caches for serving: the fixed per-slot stripe layout and the paged
block pool.

A cache is ``{"k": (layers, batch, max_len, kv_heads, head_dim), "v":
...}``.  The serving engine preallocates ONE such cache whose batch rows
are long-lived *slots*: a request is prefilled alone (batch 1, prompt
length bucketed), its cache written into a free slot with
:func:`kv_slot_insert`, and the fixed-shape decode step advances every
slot at its own position (:func:`kv_update_slots`) behind a per-slot
validity mask (:func:`slot_validity`).

The paged layout (``kv_pool_*``, :class:`BlockAllocator`) replaces the
stripe with one shared pool of fixed-size blocks plus a host-side block
table per slot; see the section below.

Unlike ``repro``'s functional updates, the update helpers here write
**in place** into the cache tensors they are given (and return them), so
a decode tick never copies the whole cache.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.obs import span

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
    row ``slot`` (on ``batch_axis``) of every tensor of the cache (nested
    dicts too: xlstm's per-block states), over the source's leading
    extent on every other axis."""
    for name, dst in cache.items():
        src = prefilled[name]
        if isinstance(dst, dict):
            state_slot_insert(dst, src, slot, batch_axis=batch_axis)
            continue
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


def cache_positions(max_len: int, device) -> torch.Tensor:
    """int32 (max_len,) positions of a cache's entries on ``device``."""
    return torch.arange(max_len, dtype=torch.int32, device=device)


def cache_validity(max_len: int, filled_len, device) -> torch.Tensor:
    """Boolean (max_len,) mask of the filled entries of a cache on
    ``device``."""
    return cache_positions(max_len, device) < filled_len


# ---------------------------------------------------------------------------
# Paged KV block pool
# ---------------------------------------------------------------------------
#
# One pool per k/v leaf, ``(layers, n_blocks + 1, block_size, kv_heads,
# head_dim)``, plus a host-side ``(max_batch, tables_len)`` int32 block
# table mapping each slot's logical block to a physical pool block.
# Physical block 0 is the shared null block: free slots and unallocated
# table entries point at it, so a gather is a total function of the
# table, and it is only ever read.  ``repro`` scatters with
# ``mode="drop"``: an inactive slot, or an unused id, goes to the
# out-of-bounds id ``n_blocks + 1`` and is dropped.  Torch has no drop
# mode (an out-of-bounds ``index_put_`` raises on the CPU and asserts on
# the card), so the scatters here filter their ids on the host, where the
# engine keeps its tables, before they touch the pool.

def kv_pool_init(layers: int, n_blocks: int, block_size: int, kv_heads: int,
                 head_dim: int, dtype=torch.bfloat16, device=None) -> dict:
    """Block pool with ``n_blocks`` usable blocks (physical ids
    1..n_blocks; id 0 is the shared null block)."""
    shape = (layers, n_blocks + 1, block_size, kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _host(a) -> np.ndarray:
    """A host numpy copy of an index array (numpy, list or tensor)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _kept(ids: np.ndarray, n_total: int) -> tuple[np.ndarray, np.ndarray]:
    """(mask, ids) of a drop-mode scatter: negative ids count from the end
    as in numpy, and whatever is still outside [0, n_total) is dropped."""
    ids = np.where(ids < 0, ids + n_total, ids)
    return (ids >= 0) & (ids < n_total), ids


def _upload(device, *arrays) -> list[torch.Tensor]:
    """Index arrays as int64 tensors on ``device`` in ONE host-to-device
    copy (each copy from pageable memory waits for the stream)."""
    n = [len(a) for a in arrays]
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1)
                           for a in arrays])
    return list(torch.as_tensor(flat, device=device).split(n))


def _geom(pool: dict) -> tuple[torch.device, int]:
    """(device, physical block count) shared by the pool's k/v leaves."""
    buf = next(iter(pool.values()))
    return buf.device, buf.shape[1]


def kv_pool_gather(pool: dict, tables, block_size: int) -> dict:
    """Dense (layers, B, T*block_size, KVH, hd) decode cache from the pool
    by per-slot block table (B, T), one indexing op per leaf.  Rows mapped
    to the null block read zeros; the slot validity mask hides them.
    In the engine's paged tick the tables' upload is an ``engine.upload``
    span and the indexing alone the device-timed ``engine.kv_gather``
    (core/obs.py), so the gather's device time holds no upload."""
    dev, _ = _geom(pool)
    tables = _host(tables)
    b, t = tables.shape
    with span("engine.upload"):
        (idx,) = _upload(dev, tables.reshape(-1))
    idx = idx.view(b, t)
    out = {}
    with span("engine.kv_gather", device=dev):
        for name, buf in pool.items():
            ll, _, bs, kvh, hd = buf.shape
            out[name] = buf[:, idx].reshape(ll, b, t * bs, kvh, hd)
    return out


def kv_pool_scatter_token(pool: dict, cache: dict, tables, pos, active,
                          block_size: int) -> dict:
    """Write back, in place, the ONE token each active slot appended this
    decode tick: ``cache`` is the gathered dense cache after the decode
    step, the token of slot b sits at ``pos[b]`` and lands in pool block
    ``tables[b, pos[b] // block_size]`` at offset ``pos[b] % block_size``.
    Inactive slots, and ids outside the pool, are dropped."""
    dev, n_total = _geom(pool)
    tables, pos = _host(tables), _host(pos).astype(np.int64)
    rows = np.nonzero(_host(active).astype(bool))[0]
    keep, blk = _kept(tables[rows, pos[rows] // block_size].astype(np.int64),
                      n_total)
    r = rows[keep]
    if not len(r):
        return pool
    r_t, p_t, b_t, o_t = _upload(dev, r, pos[r], blk[keep],
                                 pos[r] % block_size)
    for name, buf in pool.items():
        buf[:, b_t, o_t] = cache[name][:, r_t, p_t].to(buf.dtype)
    return pool


def _blocks(src: torch.Tensor, block_size: int) -> torch.Tensor:
    """(L, n, KVH, hd) rows as (L, ceil(n / bs), bs, KVH, hd) blocks, the
    last one zero-padded."""
    pad = (-src.shape[1]) % block_size
    if pad:
        src = torch.nn.functional.pad(src, (0, 0, 0, 0, 0, pad))
    ll, n, kvh, hd = src.shape
    return src.reshape(ll, n // block_size, block_size, kvh, hd)


def _put_blocks(pool: dict, pieces: dict, ids: np.ndarray) -> dict:
    """pool[:, ids[i]] = pieces[:, i] for every id kept by a drop-mode
    scatter, in place."""
    dev, n_total = _geom(pool)
    keep, ids = _kept(ids, n_total)
    if keep.any():
        dst, src = _upload(dev, ids[keep], np.nonzero(keep)[0])
        for name, buf in pool.items():
            buf[:, dst] = pieces[name][:, src].to(buf.dtype)
    return pool


def kv_pool_insert(pool: dict, prefilled: dict, block_ids,
                   block_size: int) -> dict:
    """Insert one prefilled request's cache (batch dim 1, capacity ``cap``)
    into pool blocks ``block_ids`` (ceil(cap / block_size) entries; unused
    entries hold an out-of-bounds id and are dropped), in place."""
    ids = _host(block_ids).astype(np.int64).reshape(-1)
    pieces = {name: _blocks(prefilled[name][:, 0], block_size)
              for name in pool}
    nblk = next(iter(pieces.values())).shape[1]
    if nblk != len(ids):
        raise ValueError(f"kv_pool_insert: {nblk} blocks of cache for "
                         f"{len(ids)} block ids")
    return _put_blocks(pool, pieces, ids)


def kv_pool_scatter_chunk(pool: dict, cache: dict, table_row, offset: int,
                          chunk: int, block_size: int) -> dict:
    """Scatter one prefill chunk, written into the dense batch-1 ``cache``
    at ``offset``, into the pool in place.  ``offset`` and ``chunk`` are
    multiples of ``block_size`` (ServeConfig validation), so the chunk
    covers whole blocks, ``table_row[offset // bs:][:chunk // bs]``.  Both
    slices start where ``repro``'s ``dynamic_slice`` starts them: clamped
    so that they fit."""
    row = _host(table_row).astype(np.int64).reshape(-1)
    nblk = chunk // block_size
    b0 = min(max(int(offset) // block_size, 0), len(row) - nblk)
    pieces = {}
    for name in pool:
        dense = cache[name]
        start = min(max(int(offset), 0), dense.shape[2] - chunk)
        pieces[name] = _blocks(dense[:, 0, start:start + chunk], block_size)
    return _put_blocks(pool, pieces, row[b0:b0 + nblk])


class BlockAllocator:
    """Host-side free list over the pool's usable physical blocks (ids
    1..n_blocks; 0 is the null block).  ``alloc`` is all-or-nothing; a
    double free raises, since a table bug would corrupt another tenant's
    cache."""

    def __init__(self, n_blocks: int):
        if n_blocks < 1:
            raise ValueError(f"need n_blocks >= 1, got {n_blocks}")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks, 0, -1))   # pop() yields 1, 2, ...
        self._held: set[int] = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, k: int) -> list[int] | None:
        """Claim ``k`` blocks, or None (and no change) if fewer are free."""
        if k < 0:
            raise ValueError(f"need k >= 0, got {k}")
        if k > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(k)]
        self._held.update(ids)
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._held:
                raise ValueError(f"double free / foreign block id {i}")
            self._held.discard(i)
            self._free.append(int(i))


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
           "kv_pool_init", "kv_pool_gather", "kv_pool_scatter_token",
           "kv_pool_insert", "kv_pool_scatter_chunk", "BlockAllocator",
           "kv_cache_constrain", "KV_CACHE_AXES"]
