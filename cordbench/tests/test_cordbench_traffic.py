"""The traffic generator: deterministic from the seed, the same multiset
of lengths for every seed, and each mix's parameters kept."""

import numpy as np
import pytest

from cordbench import cells, traffic_gen

SEEDS = (3, 2**31 + 7, 9_000_000_001)


def test_lengths_are_stratified_quantiles():
    logn = {"dist": "lognormal", "median": 256, "sigma": 1.0, "min": 32,
            "max": 2048}
    got = traffic_gen.lengths(logn, 5)
    assert got[2] == 256                          # the middle quantile
    assert got == sorted(got) and got[0] >= 32 and got[-1] <= 2048
    assert traffic_gen.lengths({"dist": "uniform", "min": 16, "max": 128},
                               4) == [30, 58, 86, 114]
    clipped = traffic_gen.lengths({**logn, "sigma": 10.0}, 3)
    assert clipped == [32, 256, 2048]


@pytest.mark.parametrize("mix_name", ["serve_burst"])
def test_serve_wave_deterministic_and_in_bounds(mix_name):
    mix = cells.load("grok1-serve-burst").mix
    w = mix["wave"]
    for seed in SEEDS:
        a = traffic_gen.serve_wave(mix, seed, 1, 131072)
        b = traffic_gen.serve_wave(mix, seed, 1, 131072)
        assert len(a) == w["requests"]
        for x, y in zip(a, b):
            assert np.array_equal(x["prompt"], y["prompt"])
            assert x["new"] == y["new"] and x["tenant"] == y["tenant"]
        assert [r["tenant"] for r in a[:4]] == ["alice", "bob"] * 2
        for r in a:
            assert w["prompt"]["min"] <= len(r["prompt"]) <= w["prompt"]["max"]
            assert w["new_tokens"]["min"] <= r["new"] <= \
                w["new_tokens"]["max"]
            assert r["prompt"].dtype == np.int32
            assert 0 <= r["prompt"].min() and r["prompt"].max() < 131072


def test_seeds_ask_for_the_same_work():
    mix = cells.load("grok1-serve-burst").mix
    a = traffic_gen.serve_wave(mix, SEEDS[0], 0, 131072)
    b = traffic_gen.serve_wave(mix, SEEDS[1], 0, 131072)
    c = traffic_gen.serve_wave(mix, SEEDS[0], 1, 131072)
    assert [(len(r["prompt"]), r["new"]) for r in a] == \
        [(len(r["prompt"]), r["new"]) for r in b]
    assert any(not np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, b))
    la = [len(r["prompt"]) for r in a]
    assert sorted(la) == sorted(len(r["prompt"]) for r in c)
    assert [len(r["prompt"]) for r in c] != la       # waves differ


def test_train_batch_packs_documents():
    mix = cells.load("hymba-train-dp2").mix
    for seed in SEEDS:
        rows = traffic_gen.train_batch(mix, seed, 4, 32001)
        again = traffic_gen.train_batch(mix, seed, 4, 32001)
        assert rows.shape == (mix["global_batch"], mix["seq_len"] + 1)
        assert np.array_equal(rows, again)
        assert rows.dtype == np.int32
        assert rows.max() < 32001 and rows.min() >= mix["eod_id"]
        text = rows[rows != mix["eod_id"]]
        assert text.min() >= mix["first_id"]
        assert (rows == mix["eod_id"]).any(axis=1).all()
    other = traffic_gen.train_batch(mix, SEEDS[0], 5, 32001)
    assert not np.array_equal(other, traffic_gen.train_batch(mix, SEEDS[0],
                                                             4, 32001))
