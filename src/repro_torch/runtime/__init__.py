"""Fault-tolerant runtime: the train loop with checkpoint/restart, the
verbs transport's wire faults, and elastic scaling (the remesh and the
train and serve controllers of the control loop)."""

from repro_torch.runtime.elastic import (
    ElasticController,
    ServeElasticController,
    remesh,
    shrink_mesh,
    state_shardings,
)
from repro_torch.runtime.fault import (
    FaultInjector,
    RunReport,
    SimulatedFailure,
    WireFault,
    run_loop,
)

__all__ = ["run_loop", "FaultInjector", "SimulatedFailure", "RunReport",
           "WireFault", "remesh", "state_shardings", "shrink_mesh",
           "ElasticController", "ServeElasticController"]
