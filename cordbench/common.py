"""What a driver gets and hands back."""

from __future__ import annotations

import dataclasses
import gc
import sys

import torch

from cordbench.cells import Cell


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float            # perf_counter stamp of the process's start


@dataclasses.dataclass
class Outcome:
    """A driver's result: the end-to-end metrics (name -> value), the run
    record the per-layer readers read, the counts, the numbers compared
    for `correct` with everything else the check read, and the device's
    peak memory."""
    e2e: dict
    record: dict
    attempted: int
    failed: int
    readings: dict
    memory_peak_bytes: int
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def release(device: torch.device) -> None:
    """Return the freed program state's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
