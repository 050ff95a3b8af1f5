"""Dataplane telemetry — the observability the paper gains by removing
kernel bypass (CoRD §1: "facilitate application observability").

Two mechanisms, mirroring ``repro.core.telemetry``:

* **Per-execution records** (`Telemetry`): every op issued through the
  Dataplane is recorded with its logical tag, collective kind, byte size
  and mesh axes.  PyTorch runs eagerly, so a record lands each time an
  edge *executes*.  The JAX package records at trace time instead, and a
  ``lax.scan`` layer body is traced once: where JAX holds one record per
  layer-body edge, this package holds ``num_layers`` of them, and a
  jit-cached JAX step that runs again adds no record while the port adds
  one per run.  Compare the two with that repetition in mind.  Totals
  (``by_kind`` / ``by_tag`` / ``total_bytes``) cover every execution;
  the list of records keeps only the newest ones.

* **Per-tenant counter blocks** (`tenant_counters_*`): a
  ``(num_tenants, NUM_COUNTERS)`` float32 tensor carried in the runtime
  state that the mediation pipeline and the QoS/quota policies bump.  The
  column order is ``COUNTER_NAMES`` everywhere, and every column is
  cumulative except ``cq_depth``, a high-water mark.
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np
import torch

CTR_OPS = 0          # number of dataplane ops issued
CTR_BYTES = 1        # bytes moved through the dataplane
CTR_DENIED = 2       # ops over a policy limit (quota) observed at run time
CTR_CHUNKS = 3       # chunks issued by the QoS scheduler
CTR_THROTTLED = 4    # ops stalled by the QoS token bucket
CTR_STALLS = 5       # sender ticks stalled on exhausted rx credits (verbs)
CTR_CREDITS = 6      # rx credits consumed by two-sided sends (verbs)
CTR_COMPLETIONS = 7  # CQEs drained from a completion queue (verbs)
CTR_CQ_DEPTH = 8     # CQ occupancy high-water mark (a peak, not a sum)
CTR_RETRANSMITS = 9  # WRs re-posted by the retransmission machine (verbs)
CTR_TIMEOUTS = 10    # RTO expiries (silent wire loss detected) (verbs)
CTR_SRQ_GRANTS = 11  # shared-receive-queue buffers granted to a delivery
CTR_CQE_ERRORS = 12  # error-status CQEs drained (CQE_ERR_*)
CTR_CQ_SHED = 13     # CQEs shed on CQ-ring overrun (lost completions)
CTR_KERNEL_ITERS = 14   # delay iterations burned in-kernel (mediated_cost)
CTR_KERNEL_COPIES = 15  # bounce-copy passes executed in-kernel
CTR_PREEMPTIONS = 16    # decode slots preempted (pool pressure / budget)
CTR_RESTORES = 17       # preempted requests resumed (recompute prefill)
NUM_COUNTERS = 18
COUNTER_NAMES = ("ops", "bytes", "denied", "chunks", "throttled",
                 "stalls", "credits", "completions", "cq_depth",
                 "retransmits", "timeouts", "srq_grants", "cqe_errors",
                 "cq_shed", "kernel_iters", "kernel_copies",
                 "preemptions", "restores")

_BUMP_FIELDS = ("ops", "bytes", "denied", "chunks", "throttled", "stalls",
                "credits", "completions", "retransmits", "timeouts",
                "srq_grants", "cqe_errors", "cq_shed", "kernel_iters",
                "kernel_copies", "preemptions", "restores")


@dataclass
class OpRecord:
    kind: str                 # all_reduce | all_gather | constraint | ...
    tag: str                  # logical name, e.g. "attn/q" or "embed/table"
    bytes: int                # payload bytes (per-shard operand size)
    axes: tuple[str, ...]     # mesh axes the op spans
    shape: tuple[int, ...] = ()
    dtype: str = ""
    mode: str = "cord"
    qos: str = "default"
    count: int = 1
    # QoS tokens for this op were already debited at chunk granularity;
    # the token-bucket stage must not charge it again.
    precharged: bool = False


# records a Telemetry keeps (the newest); its totals cover every record
KEEP_RECORDS = 1024


@dataclass
class Telemetry:
    """Per-execution op registry. Cheap, purely host-side, and bounded: a
    long-lived server records every executed edge, so the totals are kept
    as running ``(kind, tag)`` aggregates and ``records`` holds only the
    newest ``KEEP_RECORDS`` records."""

    enabled: bool = True
    records: deque[OpRecord] = field(init=False)
    # (kind, tag) -> [ops, bytes], over every record since the last reset
    _totals: dict[tuple[str, str], list[int]] = field(init=False,
                                                      default_factory=dict)

    def __post_init__(self) -> None:
        self.records = deque(maxlen=KEEP_RECORDS)

    def record(self, rec: OpRecord) -> None:
        if self.enabled:
            self.records.append(rec)
            tot = self._totals.setdefault((rec.kind, rec.tag), [0, 0])
            tot[0] += rec.count
            tot[1] += rec.bytes * rec.count

    def reset(self) -> None:
        self.records.clear()
        self._totals.clear()

    def total_bytes(self, kinds: tuple[str, ...] | None = None) -> int:
        return sum(b for (kind, _), (_, b) in self._totals.items()
                   if kinds is None or kind in kinds)

    def _group(self, i: int) -> dict[str, dict[str, int]]:
        agg: dict[str, dict[str, int]] = defaultdict(lambda: {"ops": 0, "bytes": 0})
        for key, (ops, nbytes) in self._totals.items():
            agg[key[i]]["ops"] += ops
            agg[key[i]]["bytes"] += nbytes
        return dict(agg)

    def by_kind(self) -> dict[str, dict[str, int]]:
        return self._group(0)

    def by_tag(self) -> dict[str, dict[str, int]]:
        return self._group(1)

    def report(self) -> str:
        lines = [f"{'kind':18s} {'ops':>8s} {'MiB':>12s}"]
        for kind, v in sorted(self.by_kind().items()):
            lines.append(f"{kind:18s} {int(v['ops']):8d} {v['bytes']/2**20:12.3f}")
        lines.append(f"{'TOTAL':18s} {sum(int(v['ops']) for v in self.by_kind().values()):8d}"
                     f" {self.total_bytes()/2**20:12.3f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Per-tenant counter blocks
# ---------------------------------------------------------------------------

def tenant_counters_init(num_tenants: int, device=None) -> torch.Tensor:
    """A (num_tenants, NUM_COUNTERS) float32 counter block."""
    return torch.zeros((num_tenants, NUM_COUNTERS), dtype=torch.float32,
                       device=device)


def tenant_counters_bump(ctrs: torch.Tensor, tenant_idx,
                         **bumps) -> torch.Tensor:
    """Return ``ctrs`` with one tenant's row bumped.  ``tenant_idx`` is an
    int or a 0-d integer tensor (a winner picked on the device, as
    ``repro``'s traced index).  Each bump value is a Python number or a
    0-d tensor, taken as float32 before the add (as ``repro`` converts
    with ``jnp.asarray(v, float32)``).  A Python number is added as a
    scalar and a tensor in place on a copy, so a bump on the card copies
    nothing from the host and never waits for the device."""
    unknown = set(bumps) - set(_BUMP_FIELDS)
    if unknown:
        raise TypeError(f"unknown counter bump(s): {sorted(unknown)}")
    out = ctrs.clone()
    if isinstance(tenant_idx, torch.Tensor):
        row = torch.zeros_like(out[0])
    else:
        row = out[tenant_idx]
    for name, v in bumps.items():
        j = COUNTER_NAMES.index(name)
        if isinstance(v, torch.Tensor):
            row[j] += v.to(torch.float32).reshape(())
        elif v:
            row[j] += v
    if isinstance(tenant_idx, torch.Tensor):
        out.index_add_(0, tenant_idx.reshape(1).long(), row[None])
    return out


def tenant_counters_peak(ctrs: torch.Tensor, tenant_idx: int, *,
                         cq_depth) -> torch.Tensor:
    """Fold a completion-queue occupancy sample (a Python number or a 0-d
    tensor) into one tenant's ``cq_depth`` high-water mark: a max, unlike
    every additive counter."""
    out = ctrs.clone()
    cell = out[tenant_idx, CTR_CQ_DEPTH]
    if isinstance(cq_depth, torch.Tensor):
        cell.copy_(torch.maximum(cell, cq_depth.to(torch.float32)))
    else:
        cell.clamp_(min=float(cq_depth))
    return out


def tenant_counters_report(ctrs, tenants: tuple[str, ...]) -> dict:
    """Host-side view: {tenant: {counter name: value}}."""
    c = ctrs.detach().cpu().numpy() if isinstance(ctrs, torch.Tensor) \
        else np.asarray(ctrs)
    return {t: {name: float(c[i, j]) for j, name in enumerate(COUNTER_NAMES)}
            for i, t in enumerate(tenants)}


_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style dtype name ``repro`` records (``"float32"``...)."""
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def nbytes(x: torch.Tensor) -> int:
    """Payload size of a tensor."""
    return int(x.numel()) * x.element_size()


def describe(x: torch.Tensor) -> tuple[tuple[int, ...], str]:
    return tuple(x.shape), dtype_name(x.dtype)


def normalize_axes(axes) -> tuple[str, ...]:
    """Flatten an axes description — a string or a (possibly nested)
    tuple of axis names, with ``None`` for unsharded dims — into the
    tuple of mesh-axis names an OpRecord stores."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,) if axes else ()
    out: list[str] = []
    for a in axes:
        out.extend(normalize_axes(a))
    return tuple(out)


__all__ = [
    "OpRecord", "Telemetry", "KEEP_RECORDS", "tenant_counters_init",
    "tenant_counters_bump", "tenant_counters_peak",
    "tenant_counters_report", "nbytes", "describe", "dtype_name",
    "normalize_axes", "CTR_OPS", "CTR_BYTES", "CTR_DENIED", "CTR_CHUNKS",
    "CTR_THROTTLED", "CTR_STALLS", "CTR_CREDITS", "CTR_COMPLETIONS",
    "CTR_CQ_DEPTH", "CTR_RETRANSMITS", "CTR_TIMEOUTS", "CTR_SRQ_GRANTS",
    "CTR_CQE_ERRORS", "CTR_CQ_SHED", "CTR_KERNEL_ITERS",
    "CTR_KERNEL_COPIES", "CTR_PREEMPTIONS", "CTR_RESTORES",
    "NUM_COUNTERS", "COUNTER_NAMES",
]
