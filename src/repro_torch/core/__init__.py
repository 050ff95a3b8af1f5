"""CoRD core in PyTorch: the Converged Dataplane, its mediation pipeline,
policies, memory regions, telemetry, and in core/obs.py the per-tenant
counter timelines with their threshold watchers and the spans at the
port's layer boundaries."""

from repro_torch.core.dataplane import Dataplane
from repro_torch.core.mediation import (
    HostTokenBucket,
    MediationPipeline,
    MediationStage,
    build_pipeline,
)
from repro_torch.core.mr import MemoryRegion, MRError, MRRegistry
from repro_torch.core.obs import (
    CounterTimeline,
    Span,
    ThresholdWatcher,
    WatcherGroup,
    clear_spans,
    merge_timelines,
    record_span,
    recorded_spans,
    span,
    sparkline,
    TIMELINE_SCHEMA,
    tracing,
    validate_timeline,
)
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
    "CounterTimeline", "ThresholdWatcher", "WatcherGroup",
    "merge_timelines", "sparkline", "TIMELINE_SCHEMA",
    "validate_timeline",
    "Span", "span", "record_span", "recorded_spans", "clear_spans",
    "tracing",
    "Policy", "PolicyContext", "PolicyViolation",
    "QoSPolicy", "QuotaPolicy", "SecurityPolicy", "TelemetryPolicy",
    "OpRecord", "Telemetry",
]
