"""Fault-tolerant runtime: step-level failures and wire-level loss.

Two injection planes live here, as in ``repro.runtime.fault``:

* **Step plane** (:class:`FaultInjector` + :func:`run_loop`): whole-step
  failures (a device or node lost) are handled on the host: periodic,
  optionally async checkpoints (``checkpoint/store.py``), auto-resume
  from the latest checkpoint, bounded retries, a restore from the latest
  checkpoint when the retries run out, and a straggler watchdog (steps
  slower than ``straggler_factor`` times the trailing median are logged).

* **Wire plane** (:class:`WireFault`): per-work-request loss and
  corruption for the verbs transport (``core/verbs.py``):
  ``windowed_send`` / ``conn_send`` consult it per wire transmission, a
  dropped WR produces no CQE (the sender's RTO fires), a corrupted one
  completes with ``CQE_ERR_RETRY`` (a NAK), and the go-back-N machine
  re-posts until the transfer is bit-identical to a lossless run or
  ``QPConfig.retry_limit`` runs out.  The predicates are pure integer
  hashes of ``(wr, attempt, seed)``, equal to ``repro``'s bit for bit.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from repro_torch.checkpoint import store


class SimulatedFailure(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# wire-level fault injection (consumed by core/verbs.py)
# ---------------------------------------------------------------------------

_U32 = 0xffffffff


@dataclass(frozen=True)
class WireFault:
    """Deterministic wire loss and corruption for the verbs transport.

    ``drop_rate`` / ``corrupt_rate`` are per-transmission probabilities
    realised by a pure integer hash of ``(wr, attempt, seed)``: no RNG
    state, and a retry of the same WR rolls a fresh outcome (the attempt
    salts the hash), so any rate < 1 eventually delivers.  ``drops`` /
    ``corrupts`` are explicit ``(wr, attempt)`` schedules.  A drop beats a
    corrupt when both fire for one transmission.

    ``wr`` is the transfer-relative work-request identity the transport
    passes in (the message index for ``windowed_send``; ``qp_id * n_msgs
    + msg`` for ``conn_send``).  The predicates take Python ints (the
    transport's host loop) or integer tensors (elementwise)."""

    drop_rate: float = 0.0
    corrupt_rate: float = 0.0
    seed: int = 0
    drops: tuple = ()     # explicit (wr, attempt) pairs, always dropped
    corrupts: tuple = ()  # explicit (wr, attempt) pairs, always corrupted

    def __post_init__(self):
        for r in (self.drop_rate, self.corrupt_rate):
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"wire fault rate {r} outside [0, 1]")

    @property
    def active(self) -> bool:
        """True if any fault can ever fire: the transport runs its plain
        loop, without the retransmission machine, when it is not."""
        return bool(self.drop_rate or self.corrupt_rate
                    or self.drops or self.corrupts)

    def _roll(self, wr, attempt, salt: int):
        """16-bit hash of (wr, attempt, seed, salt): ``repro``'s uint32
        Knuth mix and murmur finaliser.  Torch has no full uint32
        multiply, so the arithmetic is int64 (or a Python int) masked to
        32 bits after every multiply and add; an int64 product that
        overflows wraps, which keeps its low 32 bits."""
        w = wr & _U32
        a = attempt & _U32
        h = (w * 2654435761) & _U32
        h = (h + ((a * 2246822519) & _U32)) & _U32
        h = (h + ((((self.seed * 2 + salt) & _U32) * 69069) & _U32)) & _U32
        h = h ^ (h >> 16)
        h = (h * 0x85ebca6b) & _U32
        h = h ^ (h >> 13)
        h = (h * 0xc2b2ae35) & _U32
        h = h ^ (h >> 16)
        return h & 0xffff

    @staticmethod
    def _scheduled(pairs, wr, attempt):
        hit = wr != wr           # False, or all-False of wr's shape
        for w, a in pairs:
            hit = hit | ((wr == int(w)) & (attempt == int(a)))
        return hit

    def drops_wr(self, wr, attempt):
        """This (wr, attempt) transmission is lost on the wire: no
        delivery, no CQE (silent loss; the RTO catches it)."""
        hit = self._scheduled(self.drops, wr, attempt)
        if self.drop_rate > 0:
            hit = hit | (self._roll(wr, attempt, 1)
                         < int(self.drop_rate * 0x10000))
        return hit

    def corrupts_wr(self, wr, attempt):
        """This transmission arrives damaged: the delivery is discarded
        and the CQE carries ``CQE_ERR_RETRY`` (a NAK)."""
        hit = self._scheduled(self.corrupts, wr, attempt)
        if self.corrupt_rate > 0:
            hit = hit | (self._roll(wr, attempt, 2)
                         < int(self.corrupt_rate * 0x10000))
        return hit


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


__all__ = ["run_loop", "FaultInjector", "SimulatedFailure", "RunReport",
           "WireFault"]
