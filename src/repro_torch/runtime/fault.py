"""Fault-tolerant runtime: step-level failures.

Whole-step failures (a device or node lost) are handled on the host:
periodic, optionally async checkpoints (``checkpoint/store.py``),
auto-resume from the latest checkpoint, bounded retries, a restore from
the latest checkpoint when the retries run out, and a straggler watchdog
(steps slower than ``straggler_factor`` times the trailing median are
logged).  :class:`FaultInjector` fails chosen steps deterministically.

``repro``'s module also holds ``WireFault``, the wire-level loss and
corruption of its verbs transport, which is its only user; the port's
verbs slice brings it.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import store


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FaultInjector:
    """Deterministically fail specific steps (for tests and examples)."""
    fail_steps: tuple[int, ...] = ()
    max_failures_per_step: int = 1
    _counts: dict = field(default_factory=dict)

    def check(self, step: int) -> None:
        if step in self.fail_steps:
            n = self._counts.get(step, 0)
            if n < self.max_failures_per_step:
                self._counts[step] = n + 1
                raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class RunReport:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    straggler_steps: list = field(default_factory=list)
    step_times: list = field(default_factory=list)
    metrics: list = field(default_factory=list)


def _wait(metrics: dict) -> None:
    """Wait for the card that holds the step's metrics, so the clock
    reads the step's end (``jax.block_until_ready`` in ``repro``)."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def run_loop(step_fn, state, loader, *, steps: int,
             ckpt_dir: str | None = None, checkpoint_every: int = 0,
             keep_last: int = 3, async_ckpt: bool = True,
             injector: FaultInjector | None = None,
             straggler_factor: float = 3.0, max_retries: int = 2,
             log_every: int = 0, start_step: int = 0) -> tuple:
    """Run ``steps`` steps of ``step_fn(state, batch) -> (state,
    metrics)`` over ``loader.get(step)`` with checkpoint/restart and
    straggler tracking.  Returns ``(state, RunReport)``."""
    report = RunReport()
    pending: list = []

    # auto-resume
    step = start_step
    if ckpt_dir:
        latest = store.latest_step(ckpt_dir)
        if latest is not None and latest > step:
            state = store.restore(ckpt_dir, latest, state)
            step = latest
            report.restores += 1

    try:
        while step < steps:
            batch = loader.get(step)
            retries = 0
            while True:
                try:
                    if injector is not None:
                        injector.check(step)
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    _wait(metrics)
                    dt = time.perf_counter() - t0
                    break
                except SimulatedFailure:
                    report.failures += 1
                    retries += 1
                    if retries <= max_retries:
                        continue
                    # full restart path: restore from the checkpoint
                    latest = store.latest_step(ckpt_dir) if ckpt_dir \
                        else None
                    if latest is None:
                        raise
                    state = store.restore(ckpt_dir, latest, state)
                    step = latest
                    report.restores += 1
                    batch = loader.get(step)
                    retries = 0

            report.step_times.append(dt)
            trailing = report.step_times[-20:]
            if len(trailing) >= 5:
                med = statistics.median(trailing)
                if dt > straggler_factor * med:
                    report.straggler_steps.append(step)

            report.metrics.append({k: float(v) for k, v in metrics.items()})
            report.steps_run += 1
            step += 1

            if ckpt_dir and checkpoint_every and step % checkpoint_every == 0:
                th = store.save(ckpt_dir, step, state, keep_last=keep_last,
                                blocking=not async_ckpt)
                if th is not None:
                    pending.append(th)
            if log_every and step % log_every == 0:
                m = report.metrics[-1]
                print(f"step {step:5d} loss={m.get('loss', float('nan')):.4f} "
                      f"dt={dt*1e3:.1f}ms")
    finally:
        for th in pending:
            th.join()
    return state, report


__all__ = ["run_loop", "FaultInjector", "SimulatedFailure", "RunReport"]
