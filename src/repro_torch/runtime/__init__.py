"""Fault-tolerant runtime: the train loop with checkpoint/restart."""

from repro_torch.runtime.fault import (
    FaultInjector,
    RunReport,
    SimulatedFailure,
    run_loop,
)

__all__ = ["run_loop", "FaultInjector", "SimulatedFailure", "RunReport"]
