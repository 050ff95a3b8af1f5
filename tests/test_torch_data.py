"""Port parity for the synthetic data pipeline (``repro_torch.data``).

Tolerance: exact — every batch and shard bit for bit."""

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JData
from repro.data import ShardedLoader as JLoader
from repro.data import SyntheticLM as JSynth

from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM, to_torch

CONFIGS = [dict(), dict(vocab_size=262_144, seq_len=64, global_batch=4),
           dict(vocab_size=97, seq_len=33, global_batch=6, seed=5,
                noise=0.3)]


@pytest.mark.parametrize("kw", CONFIGS)
def test_batches_bit_for_bit(kw):
    jd, td = JSynth(JData(**kw)), SyntheticLM(DataConfig(**kw))
    np.testing.assert_array_equal(td.rules_a, jd.rules_a)
    np.testing.assert_array_equal(td.rules_b, jd.rules_b)
    for step in (0, 1, 7):
        jb, tb = jd.batch_at(step), td.batch_at(step)
        assert sorted(tb) == sorted(jb) == ["labels", "tokens"]
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_shards_are_contiguous_blocks(num_shards):
    """Shard r of the global batch is its r-th contiguous block, as
    ``P("data")`` shards the leading dim — the split the DP step makes."""
    cfg = dict(vocab_size=256, seq_len=16, global_batch=8)
    jd, td = JSynth(JData(**cfg)), SyntheticLM(DataConfig(**cfg))
    whole = td.batch_at(3)
    per = 8 // num_shards
    for r in range(num_shards):
        tb = td.batch_at(3, shard=r, num_shards=num_shards)
        jb = jd.batch_at(3, shard=r, num_shards=num_shards)
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])
            np.testing.assert_array_equal(tb[k],
                                          whole[k][r * per:(r + 1) * per])


def test_loader_and_to_torch():
    cfg = dict(vocab_size=256, seq_len=8, global_batch=4)
    jl = JLoader(JSynth(JData(**cfg)), shard=1, num_shards=2)
    tl = ShardedLoader(SyntheticLM(DataConfig(**cfg)), shard=1,
                       num_shards=2)
    for step in range(3):
        jb, tb = jl.get(step), tl.get(step)
        t = to_torch(tb, "cpu")
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert t[k].dtype == torch.int32
            np.testing.assert_array_equal(t[k].numpy(), jb[k])
    assert tl.straggler_events == jl.straggler_events == []
