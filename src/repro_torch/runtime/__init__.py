"""Fault-tolerant runtime: the train loop with checkpoint/restart, and
the verbs transport's wire faults."""

from repro_torch.runtime.fault import (
    FaultInjector,
    RunReport,
    SimulatedFailure,
    WireFault,
    run_loop,
)

__all__ = ["run_loop", "FaultInjector", "SimulatedFailure", "RunReport",
           "WireFault"]
