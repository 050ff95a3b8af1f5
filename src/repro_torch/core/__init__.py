"""CoRD core in PyTorch: the Converged Dataplane, its mediation pipeline,
policies, memory regions and telemetry."""

from repro_torch.core.dataplane import Dataplane
from repro_torch.core.mediation import (
    HostTokenBucket,
    MediationPipeline,
    MediationStage,
    build_pipeline,
)
from repro_torch.core.mr import MemoryRegion, MRError, MRRegistry
from repro_torch.core.policies import (
    Policy,
    PolicyContext,
    PolicyViolation,
    QoSPolicy,
    QuotaPolicy,
    SecurityPolicy,
    TelemetryPolicy,
)
from repro_torch.core.telemetry import OpRecord, Telemetry

__all__ = [
    "Dataplane",
    "MediationPipeline", "MediationStage", "build_pipeline",
    "HostTokenBucket",
    "MemoryRegion", "MRError", "MRRegistry",
    "Policy", "PolicyContext", "PolicyViolation",
    "QoSPolicy", "QuotaPolicy", "SecurityPolicy", "TelemetryPolicy",
    "OpRecord", "Telemetry",
]
