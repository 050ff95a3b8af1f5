"""Smoke-size cells for the CPU tests: each cell's configuration cut by
the port's `reduced` (float32, 4 layers of d_model 64) and its mix cut to
a few short requests or rows, run through the same drivers."""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from cordbench import cells
from cordbench.common import Ctx

SERVE = {"check": {"sample_tokens": 64, "max_requests": 8}}
MIXES = {
    "serve_burst": {**SERVE, "engine": {
        "max_batch": 4, "block_size": 16, "kv_cache_len": 128,
        "n_blocks": 48, "prefill_chunk": 32, "max_new_tokens": 16},
        "wave": {"requests": 8,
                 "prompt": {"dist": "lognormal", "median": 24,
                            "sigma": 1.0, "min": 8, "max": 80},
                 "new_tokens": {"dist": "uniform", "min": 4, "max": 16}}},
    "prefill_long": {**SERVE, "engine": {
        "max_batch": 4, "kv_cache_len": 160, "max_new_tokens": 16},
        "wave": {"requests": 6,
                 "prompt": {"dist": "uniform", "min": 32, "max": 128},
                 "new_tokens": {"dist": "uniform", "min": 4, "max": 16}}},
    "train_packed": {"global_batch": 4, "seq_len": 32, "min_step_s": 0.05,
                     "docs": {"dist": "lognormal", "median": 8,
                              "sigma": 1.0, "min": 2, "max": 32},
                     "check": {"steps": 3, "rows": 2}},
}
LIMITS = {"serve": {"compared": {"mean_gap": {"limit": 1e-4}}},
          "train": {"compared": {"loss_gap": {"limit": 1e-4},
                                 "grad1_gap": {"limit": 1e-3},
                                 "change_gap": {"limit": 1e-2}}}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and \
            isinstance(out.get(k), dict) else v
    return out


def cell(workload: str) -> cells.Cell:
    """``workload`` of BENCHMARK.json at smoke size."""
    from repro_torch.configs.base import reduced
    c = cells.load(workload)
    small = dataclasses.asdict(reduced(c.model_config()))
    kind = c.mix["driver"]
    c.config = {**c.config, "model": small}
    c.mix = _merge(c.mix, MIXES[c.workload["traffic"]])
    c.limits = LIMITS["serve" if kind == "serve_waves" else "train"]
    return c


def ctx(workload: str, seed: int = 5, seconds: float = 0.0,
        trace: bool = False) -> Ctx:
    return Ctx(cell=cell(workload), seed=seed, seconds=seconds, trace=trace,
               device=torch.device("cpu"), t_start=time.perf_counter())
