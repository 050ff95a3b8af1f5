"""The one generator of the benchmark's inputs.  A traffic mix is a JSON
file under `cordbench/traffic/`; this module reads its parameters and
draws the inputs from the seed.  The program receives only what it
returns.

Lengths are the same for every seed: each wave takes stratified
quantiles of the mix's length distribution in an order drawn from the
wave's index alone, and the seed draws only the token ids.  The
engine's schedule follows the order of the lengths, so two seeds ask
for the same work (runs of two seeds differed by up to 8 % in a cell
when the seed drew the order too).
"""

from __future__ import annotations

import math
import statistics

import numpy as np


def lengths(dist: dict, n: int) -> list[int]:
    """``n`` stratified draws of ``dist``: the (i + 1/2) / n quantiles of a
    ``lognormal`` (``median``, ``sigma``) or ``uniform`` integer range,
    clipped to [``min``, ``max``]."""
    lo, hi = int(dist["min"]), int(dist["max"])
    us = [(i + 0.5) / n for i in range(n)]
    if dist["dist"] == "lognormal":
        nd = statistics.NormalDist()
        vals = [dist["median"] * math.exp(dist["sigma"] * nd.inv_cdf(u))
                for u in us]
    elif dist["dist"] == "uniform":
        vals = [lo + math.floor(u * (hi - lo + 1)) for u in us]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return [min(max(int(round(v)), lo), hi) for v in vals]


def _rng(seed: int, *index: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *index])


def serve_wave(mix: dict, seed: int, wave: int, vocab: int) -> list[dict]:
    """Wave ``wave`` of a serve mix: ``requests`` dicts with ``prompt``
    (int32 ids in [first_id, vocab)), ``new`` (tokens to generate) and
    ``tenant`` (the mix's tenants in turn)."""
    w = mix["wave"]
    n = int(w["requests"])
    order = np.random.default_rng([int(wave)])
    prompts = order.permutation(lengths(w["prompt"], n))
    news = order.permutation(lengths(w["new_tokens"], n))
    rng = _rng(seed, wave)
    first = int(mix.get("first_id", 0))
    tenants = w["tenants"]
    return [{"prompt": rng.integers(first, vocab, int(p)).astype(np.int32),
             "new": int(k), "tenant": tenants[i % len(tenants)]}
            for i, (p, k) in enumerate(zip(prompts, news))]


def train_batch(mix: dict, seed: int, step: int, vocab: int) -> np.ndarray:
    """Step ``step``'s rows, (global_batch, seq_len + 1) int32: documents
    of the mix's lengths packed back to back, each followed by ``eod_id``,
    ids of the text in [first_id, vocab).  Tokens are ``[:, :-1]`` and
    labels ``[:, 1:]``."""
    b, s = int(mix["global_batch"]), int(mix["seq_len"]) + 1
    rng = _rng(seed, step)
    first, eod = int(mix["first_id"]), int(mix["eod_id"])
    docs = mix["docs"]
    out = np.empty((b, s), np.int32)
    for r in range(b):
        row, n = [], 0
        while n < s:
            k = _doc_len(docs, rng)
            row.append(rng.integers(first, vocab, k).astype(np.int32))
            row.append(np.asarray([eod], np.int32))
            n += k + 1
        out[r] = np.concatenate(row)[:s]
    return out


def _doc_len(docs: dict, rng: np.random.Generator) -> int:
    v = docs["median"] * math.exp(docs["sigma"] * rng.standard_normal())
    return min(max(int(round(v)), int(docs["min"])), int(docs["max"]))
