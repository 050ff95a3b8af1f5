"""Data pipeline: deterministic synthetic token streams (learnable
structure, so example trainings visibly reduce loss) and sharded loading.

A numpy copy of ``repro``'s ``data/pipeline.py``: the same seed gives the
same batches bit for bit.  The synthetic task mixes affine token chains
``x_{t+1} = (a·x_t + b) mod V`` (with (a, b) drawn per sequence from a
small pool) with noise tokens.

The loader is *stateless*: ``batch_at(step)`` is a pure function of
(seed, step, shard), so restarts replay the exact stream.
:func:`to_torch` moves a numpy batch onto a device; the explicit
data-parallel step (``train/step.py``) splits the global batch over its
ranks in contiguous blocks, as ``P("data")`` shards a leading dim.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    n_rules: int = 8          # size of the (a, b) pool
    noise: float = 0.02       # probability of a random token


class SyntheticLM:
    """Deterministic, shardable synthetic LM dataset."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # odd multipliers are invertible mod 2^k vocab sizes
        self.rules_a = rng.choice(np.arange(1, v, 2), cfg.n_rules)
        self.rules_b = rng.integers(0, v, cfg.n_rules)

    def _sequence(self, idx: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, idx))
        rule = rng.integers(0, cfg.n_rules)
        a, b = self.rules_a[rule], self.rules_b[rule]
        x = np.empty(cfg.seq_len + 1, np.int64)
        x[0] = rng.integers(0, cfg.vocab_size)
        for t in range(cfg.seq_len):
            x[t + 1] = (a * x[t] + b) % cfg.vocab_size
        noise = rng.random(cfg.seq_len + 1) < cfg.noise
        x[noise] = rng.integers(0, cfg.vocab_size, noise.sum())
        return x

    def batch_at(self, step: int, *, shard: int = 0, num_shards: int = 1):
        """Global batch for ``step``, optionally this shard's slice."""
        cfg = self.cfg
        per = cfg.global_batch // num_shards
        base = step * cfg.global_batch + shard * per
        seqs = np.stack([self._sequence(base + i) for i in range(per)])
        return {"tokens": seqs[:, :-1].astype(np.int32),
                "labels": seqs[:, 1:].astype(np.int32)}


class ShardedLoader:
    """Per-host loader with a straggler watchdog: if producing a batch
    exceeds ``deadline_s`` the loader substitutes the previous batch and
    records the event."""

    def __init__(self, dataset: SyntheticLM, shard: int = 0,
                 num_shards: int = 1, deadline_s: float = 5.0):
        self.ds = dataset
        self.shard = shard
        self.num_shards = num_shards
        self.deadline_s = deadline_s
        self.straggler_events: list[int] = []
        self._last = None

    def get(self, step: int):
        t0 = time.perf_counter()
        batch = self.ds.batch_at(step, shard=self.shard,
                                 num_shards=self.num_shards)
        if time.perf_counter() - t0 > self.deadline_s and self._last is not None:
            self.straggler_events.append(step)
            return self._last
        self._last = batch
        return batch


def to_torch(batch: dict, device) -> dict:
    """A numpy batch as int32 tensors on ``device`` (one copy each)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


__all__ = ["DataConfig", "SyntheticLM", "ShardedLoader", "to_torch"]
