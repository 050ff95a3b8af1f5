"""Port parity for the paged KV block pool (layers/kvcache.py ``kv_pool_*``
and ``BlockAllocator``).

The same numpy pool, caches and index arrays go through ``repro``'s
functional helpers and the port's in-place ones, including the ids that
``repro`` drops with ``mode="drop"``: inactive slots routed to the
out-of-bounds id, padded insert ids, and a chunk whose slices clamp.
Tolerance: exact — pools compare bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import kvcache as jkv

from repro_torch.layers import kvcache as tkv

from torch_port_util import bits, cuda_device

L, NB, BS, KVH, HD = 2, 6, 4, 2, 3
N_TOTAL = NB + 1          # usable blocks plus the null block
OOB = NB + 1              # the id repro routes dropped writes to


def _pool(seed):
    """A pool with distinct values in every usable block and a zero null
    block, as both packages hold it."""
    rng = np.random.default_rng(seed)
    shape = (L, N_TOTAL, BS, KVH, HD)
    out = {}
    for name in ("k", "v"):
        a = rng.standard_normal(shape).astype(np.float32)
        a[:, 0] = 0.0
        out[name] = a
    return out


def _dense(seed, b, s):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((L, b, s, KVH, HD)).astype(np.float32)
            for n in ("k", "v")}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def _assert_pools_equal(tpool, jpool):
    for name in ("k", "v"):
        np.testing.assert_array_equal(bits(tpool[name]), bits(jpool[name]))


def test_pool_init_matches():
    jp = jkv.kv_pool_init(L, NB, BS, KVH, HD, dtype=jnp.float32)
    tp = tkv.kv_pool_init(L, NB, BS, KVH, HD, dtype=torch.float32)
    assert tuple(tp["k"].shape) == jp["k"].shape == (L, N_TOTAL, BS, KVH, HD)
    _assert_pools_equal(tp, jp)


@pytest.mark.parametrize("tables", [
    [[2, 5, 0], [1, 3, 4]],              # full and part-filled rows
    [[0, 0, 0], [6, 6, 1]],              # a free slot on the null block
])
def test_gather_matches(tables):
    pool = _pool(0)
    tables = np.asarray(tables, np.int32)
    jd = jkv.kv_pool_gather(_j(pool), jnp.asarray(tables), BS)
    td = tkv.kv_pool_gather(_t(pool), tables, BS)
    assert tuple(td["k"].shape) == (L, 2, 3 * BS, KVH, HD)
    _assert_pools_equal(td, jd)
    # a table given as a tensor gathers the same rows
    _assert_pools_equal(tkv.kv_pool_gather(_t(pool), torch.from_numpy(tables),
                                           BS), jd)


@pytest.mark.parametrize("active", [[True, True, True], [True, False, True],
                                    [False, False, False]])
def test_scatter_token_matches_and_drops_inactive(active):
    pool = _pool(1)
    tables = np.asarray([[1, 2, 0], [3, 0, 0], [4, 5, 6]], np.int32)
    pos = np.asarray([5, 1, 11], np.int32)
    dense = _dense(2, 3, 3 * BS)
    active = np.asarray(active)
    jp = jkv.kv_pool_scatter_token(_j(pool), _j(dense), jnp.asarray(tables),
                                   jnp.asarray(pos), jnp.asarray(active), BS)
    tpool = _t(pool)
    tp = tkv.kv_pool_scatter_token(tpool, _t(dense), tables, pos, active, BS)
    assert tp is tpool                   # in place
    _assert_pools_equal(tp, jp)
    assert not tp["k"][:, 0].any()       # the null block is never written


def test_scatter_token_drops_out_of_bounds_table_ids():
    pool = _pool(3)
    tables = np.asarray([[1, OOB], [OOB + 3, 2]], np.int32)
    pos = np.asarray([5, 2], np.int32)   # slot 0 -> OOB, slot 1 -> OOB + 3
    dense = _dense(4, 2, 2 * BS)
    active = np.asarray([True, True])
    jp = jkv.kv_pool_scatter_token(_j(pool), _j(dense), jnp.asarray(tables),
                                   jnp.asarray(pos), jnp.asarray(active), BS)
    tp = tkv.kv_pool_scatter_token(_t(pool), _t(dense), tables, pos, active,
                                   BS)
    _assert_pools_equal(tp, jp)
    _assert_pools_equal(tp, _j(pool))    # both writes dropped


@pytest.mark.parametrize("cap,ids", [
    (8, [2, 5]),                         # whole blocks
    (6, [3, 1]),                         # a padded last block
    (12, [4, OOB, 6]),                   # a padded (dropped) id
    (8, [OOB, OOB]),                     # everything dropped
])
def test_insert_matches(cap, ids):
    pool = _pool(5)
    pre = {n: v[:, :1] for n, v in _dense(6, 1, cap).items()}
    ids = np.asarray(ids, np.int32)
    jp = jkv.kv_pool_insert(_j(pool), _j(pre), jnp.asarray(ids), BS)
    tp = tkv.kv_pool_insert(_t(pool), _t(pre), ids, BS)
    _assert_pools_equal(tp, jp)


def test_insert_then_gather_round_trips():
    pool = tkv.kv_pool_init(L, NB, BS, KVH, HD, dtype=torch.float32)
    pre = _t({n: v + 7.0 for n, v in _dense(7, 1, 8).items()})
    tkv.kv_pool_insert(pool, pre, [2, 5], BS)
    dense = tkv.kv_pool_gather(pool, np.asarray([[2, 5, 0]]), BS)
    np.testing.assert_array_equal(bits(dense["k"][:, 0, :8]),
                                  bits(pre["k"][:, 0]))
    assert not dense["k"][:, 0, 8:].any()   # the null block reads zeros


def test_insert_rejects_a_block_count_mismatch():
    pool = _t(_pool(0))
    pre = _t({n: v for n, v in _dense(1, 1, 8).items()})
    with pytest.raises(ValueError, match="block ids"):
        tkv.kv_pool_insert(pool, pre, [1, 2, 3], BS)


@pytest.mark.parametrize("offset,row", [
    (0, [1, 2, 3, 4, 0]),
    (8, [6, 5, 4, 3, 2]),
    (16, [1, 2, 3, 4, 5]),               # both slices clamp to fit
    (4, [1, OOB, 3, 0, 0]),              # an out-of-bounds id is dropped
])
def test_scatter_chunk_matches(offset, row):
    chunk = 8                            # two blocks per chunk
    pool = _pool(8)
    dense = {n: v[:, :1] for n, v in _dense(9, 1, 20).items()}
    row = np.asarray(row, np.int32)
    jp = jkv.kv_pool_scatter_chunk(_j(pool), _j(dense), jnp.asarray(row),
                                   jnp.int32(offset), chunk, BS)
    tp = tkv.kv_pool_scatter_chunk(_t(pool), _t(dense), row, offset, chunk,
                                   BS)
    _assert_pools_equal(tp, jp)


def test_block_allocator_round_trip_matches():
    for alloc_cls in (jkv.BlockAllocator, tkv.BlockAllocator):
        a = alloc_cls(4)
        assert a.alloc(3) == [1, 2, 3] and a.free_blocks == 1
        assert a.alloc(2) is None and a.free_blocks == 1   # all-or-nothing
        a.free([2])
        assert sorted(a.alloc(2)) == [2, 4]
        assert a.alloc(0) == [] and a.free_blocks == 0
        a.free([1, 2, 3, 4])
        assert a.free_blocks == 4
    with pytest.raises(ValueError, match="n_blocks"):
        tkv.BlockAllocator(0)
    with pytest.raises(ValueError, match="k >= 0"):
        tkv.BlockAllocator(2).alloc(-1)


def test_block_allocator_double_free_raises():
    a = tkv.BlockAllocator(2)
    a.alloc(1)
    a.free([1])
    with pytest.raises(ValueError, match="double free"):
        a.free([1])
    with pytest.raises(ValueError, match="double free"):
        a.free([0])                      # the null block is never handed out


@pytest.mark.cuda
def test_pool_gather_and_scatter_on_card_match_cpu():
    """Gather, token scatter, insert and chunk scatter on the card give the
    CPU result bit for bit, in bf16 at gemma3-1b's cache geometry (one kv
    head of 256), dropped ids included."""
    dev = cuda_device()
    gen = torch.Generator().manual_seed(0)
    ll, nb, bs, kvh, hd = 3, 40, 16, 1, 256
    pool = {n: torch.randn(ll, nb + 1, bs, kvh, hd, generator=gen)
            .to(torch.bfloat16) for n in ("k", "v")}
    for buf in pool.values():
        buf[:, 0] = 0
    tables = np.zeros((4, 10), np.int32)
    tables[0, :7] = [3, 9, 1, 27, 14, 2, 40]
    tables[1, :2] = [5, 6]
    tables[3, :10] = np.arange(11, 21)
    pos = np.asarray([100, 20, 0, 159], np.int32)
    active = np.asarray([True, True, False, True])
    pre = {n: torch.randn(ll, 1, 48, kvh, hd, generator=gen)
           .to(torch.bfloat16) for n in ("k", "v")}
    chunk = {n: torch.randn(ll, 1, 64, kvh, hd, generator=gen)
             .to(torch.bfloat16) for n in ("k", "v")}
    row = np.asarray([21, 22, nb + 1, 23, 24, 25, 26, 28], np.int32)

    def steps(device):
        p = {n: v.clone().to(device) for n, v in pool.items()}
        dense = tkv.kv_pool_gather(p, tables, bs)
        dense = {n: v + 1 for n, v in dense.items()}
        tkv.kv_pool_scatter_token(p, dense, tables, pos, active, bs)
        tkv.kv_pool_insert(p, {n: v.to(device) for n, v in pre.items()},
                           [30, nb + 1, 31], bs)
        tkv.kv_pool_scatter_chunk(p, {n: v.to(device)
                                      for n, v in chunk.items()},
                                  row, 32, 32, bs)
        return dense, p

    want_dense, want_pool = steps("cpu")
    got_dense, got_pool = steps(dev)
    torch.cuda.synchronize()
    for name in ("k", "v"):
        np.testing.assert_array_equal(bits(got_dense[name]),
                                      bits(want_dense[name]))
        np.testing.assert_array_equal(bits(got_pool[name]),
                                      bits(want_pool[name]))
