"""The composable mediation pipeline — CoRD's "kernel on the data path"
as one reusable artifact.

A :class:`MediationPipeline` is an ordered list of :class:`MediationStage`
objects, compiled once per :class:`~repro_torch.core.dataplane.Dataplane`
from its mode, technique toggles and policy set by :func:`build_pipeline`.

  ============== ========================================== ==============
  stage          emulates                                   side
  ============== ========================================== ==============
  syscall-cost   user→kernel crossing (kernel bypass off)   send
  socket-stack   full kernel network stack + per-byte cost  send
  staged-copy    bounce-buffer copies (zero copy off)       send+complete
  interrupt-wait interrupt delivery + wakeup (polling off)  complete
  token-bucket   per-tenant QoS rate limiting (QoSPolicy)   send
  counter-bump   per-tenant runtime accounting + quota mark send
  ============== ========================================== ==============

Every stage preserves values bit-exactly: mediation changes *cost* and
*state*, never results.  Runtime state is a dict of tensors threaded with
the uniform ``(x, state)`` convention; ``state=None`` disables the
stateful stages (the constraint path passes None).

On a CUDA device a fused pure-cost side is ONE launch of the dataplane
kernel (``mediated_cost``); :class:`HostTokenBucket` is the host-side
token bucket the serving engine uses for tenant admission.
"""

from __future__ import annotations

from repro_torch.core import techniques as tech
from repro_torch.core import telemetry as tl
from repro_torch.core.policies import Policy, QoSPolicy, QuotaPolicy


class MediationStage:
    """One composable mediation technique.

    ``send`` runs on the issue side, ``complete`` on the completion side;
    both return ``x`` value-identical.  ``stateful = False`` declares a
    *pure cost* stage whose whole effect is the delay iterations and
    copy passes it reports, so a fused pipeline may sum them."""

    name = "stage"
    stateful = True

    def send(self, x, rec: tl.OpRecord, state, tenant_idx: int):
        return x, state

    def complete(self, x, rec: tl.OpRecord, state, tenant_idx: int):
        return x, state

    def send_delay_iters(self, rec: tl.OpRecord) -> int:
        return 0

    def complete_delay_iters(self, rec: tl.OpRecord) -> int:
        return 0

    def send_copies(self, rec: tl.OpRecord) -> int:
        return 0

    def complete_copies(self, rec: tl.OpRecord) -> int:
        return 0

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class SyscallCostStage(MediationStage):
    """The user→kernel crossing paid per op when kernel bypass is off."""

    name = "syscall-cost"
    stateful = False

    def __init__(self, syscall_ns: float, device="cuda"):
        self.syscall_ns = float(syscall_ns)
        self.device = device

    def send(self, x, rec, state, tenant_idx):
        return tech.delay_chain(x, self.send_delay_iters(rec)), state

    def send_delay_iters(self, rec):
        return tech.iters_for_ns(self.syscall_ns, device=self.device)


class SocketStackStage(MediationStage):
    """The extra cost of the full kernel network stack (socket mode): a
    fixed per-op term plus a per-payload-byte term."""

    name = "socket-stack"
    stateful = False

    def __init__(self, stack_ns: float, ns_per_byte: float, device="cuda"):
        self.stack_ns = float(stack_ns)
        self.ns_per_byte = float(ns_per_byte)
        self.device = device

    def send(self, x, rec, state, tenant_idx):
        return tech.delay_chain(x, self.send_delay_iters(rec)), state

    def send_delay_iters(self, rec):
        return tech.iters_for_ns(self.stack_ns + rec.bytes * self.ns_per_byte,
                                 device=self.device)


class StagedCopyStage(MediationStage):
    """Bounce-buffer copies on both sides when zero copy is removed.  With
    ``pallas=True`` the copies go through ``bounce_copy`` (the kernel on a
    CUDA tensor); otherwise through ``techniques.staged_copy``."""

    name = "staged-copy"
    stateful = False

    def __init__(self, copies: int = 1, pallas: bool = False):
        self.copies = int(copies)
        self.pallas = bool(pallas)

    def _copy(self, x):
        if self.pallas:
            from repro_torch.kernels import dataplane as dk
            return dk.bounce_copy(x, copies=self.copies)
        return tech.staged_copy(x, copies=self.copies)

    def send(self, x, rec, state, tenant_idx):
        return self._copy(x), state

    def complete(self, x, rec, state, tenant_idx):
        return self._copy(x), state

    def send_copies(self, rec):
        return self.copies

    def complete_copies(self, rec):
        return self.copies


class InterruptWaitStage(MediationStage):
    """Wait-for-event completion: interrupt delivery + wakeup."""

    name = "interrupt-wait"
    stateful = False

    def __init__(self, interrupt_us: float, device="cuda"):
        self.interrupt_us = float(interrupt_us)
        self.device = device

    def complete(self, x, rec, state, tenant_idx):
        return tech.delay_chain(x, self.complete_delay_iters(rec)), state

    def complete_delay_iters(self, rec):
        return tech.iters_for_ns(self.interrupt_us * 1e3, device=self.device)


class TokenBucketStage(MediationStage):
    """Per-tenant QoS throttling: delegates to QoSPolicy.on_op_runtime."""

    name = "token-bucket"

    def __init__(self, policy: QoSPolicy, tenants: tuple[str, ...]):
        self.policy = policy
        self.tenants = tenants

    def send(self, x, rec, state, tenant_idx):
        if rec.precharged:
            return x, state
        return self.policy.on_op_runtime(x, state, rec,
                                         self.tenants[tenant_idx], tenant_idx)


class CounterBumpStage(MediationStage):
    """The 'syscall body': bump the issuing tenant's runtime counters, then
    let the quota policy mark over-budget traffic."""

    name = "counter-bump"

    def __init__(self, tenants: tuple[str, ...],
                 quota: QuotaPolicy | None = None):
        self.tenants = tenants
        self.quota = quota

    def send(self, x, rec, state, tenant_idx):
        if state is None or "counters" not in state:
            return x, state
        ctrs = tl.tenant_counters_bump(state["counters"], tenant_idx,
                                       ops=rec.count,
                                       bytes=rec.bytes * rec.count)
        state = {**state, "counters": ctrs}
        if self.quota is not None:
            x, state = self.quota.on_op_runtime(
                x, state, rec, self.tenants[tenant_idx], tenant_idx)
        return x, state


class MediationPipeline:
    """An ordered composition of mediation stages.

    ``fused=True`` sums the pure-cost stages' delay iterations and copy
    passes per side into ONE delay chain and ONE staged copy — or, with
    ``pallas=True``, ONE ``mediated_cost`` call (one kernel launch on the
    card).  Stateful stages still run their hooks in declared order."""

    def __init__(self, stages=(), fused: bool = True, pallas: bool = False):
        self.stages: tuple[MediationStage, ...] = tuple(stages)
        self.fused = bool(fused)
        self.pallas = bool(pallas)

    @property
    def stage_names(self) -> tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def _pure_cost(self, rec, side: str) -> tuple[int, int]:
        iters = sum(getattr(s, f"{side}_delay_iters")(rec)
                    for s in self.stages if not s.stateful)
        copies = sum(getattr(s, f"{side}_copies")(rec)
                     for s in self.stages if not s.stateful)
        return iters, copies

    def _kernel_ctr_bump(self, state, tenant_idx, kernel_iters,
                         kernel_copies):
        if state is None or "counters" not in state:
            return state
        ctrs = tl.tenant_counters_bump(state["counters"], tenant_idx,
                                       kernel_iters=kernel_iters,
                                       kernel_copies=kernel_copies)
        return {**state, "counters": ctrs}

    def _static_cost_bump(self, x, rec, state, tenant_idx, side: str):
        """Bump the totals the cost kernel's counters *would* sum to, so
        reports are identical across pallas on/off and fused/unfused."""
        iters, copies = self._pure_cost(rec, side)
        if not (iters or copies) or state is None or "counters" not in state:
            return state
        from repro_torch.kernels.dataplane import kernel_cost_totals
        kit, kcp = kernel_cost_totals(x.numel(), iters, copies)
        return self._kernel_ctr_bump(state, tenant_idx, kit, kcp)

    def _fused_side(self, x, rec, state, tenant_idx, side: str):
        iters, copies = self._pure_cost(rec, side)
        if self.pallas and (iters or copies):
            from repro_torch.kernels import dataplane as dk
            x, kctrs = dk.mediated_cost(x, dk.rescale_iters(iters), copies)
            if state is not None and "counters" in state:
                # what the kernel actually burned / copied, chunk by chunk
                state = self._kernel_ctr_bump(
                    state, tenant_idx,
                    kctrs[:, dk.COST_ITERS].sum(),
                    kctrs[:, dk.COST_COPIES].sum())
        else:
            if iters:
                x = tech.delay_chain(x, iters)
            if copies:
                x = tech.staged_copy(x, copies=copies)
            state = self._static_cost_bump(x, rec, state, tenant_idx, side)
        for s in self.stages:
            if s.stateful:
                x, state = getattr(s, side)(x, rec, state, tenant_idx)
        return x, state

    def send(self, x, rec: tl.OpRecord, state=None, tenant_idx: int = 0):
        if self.fused:
            return self._fused_side(x, rec, state, tenant_idx, "send")
        for s in self.stages:
            x, state = s.send(x, rec, state, tenant_idx)
        return x, self._static_cost_bump(x, rec, state, tenant_idx, "send")

    def complete(self, x, rec: tl.OpRecord, state=None, tenant_idx: int = 0):
        if self.fused:
            return self._fused_side(x, rec, state, tenant_idx, "complete")
        for s in self.stages:
            x, state = s.complete(x, rec, state, tenant_idx)
        return x, self._static_cost_bump(x, rec, state, tenant_idx,
                                         "complete")

    def send_delay_iters(self, rec: tl.OpRecord) -> int:
        return sum(s.send_delay_iters(rec) for s in self.stages)

    def complete_delay_iters(self, rec: tl.OpRecord) -> int:
        return sum(s.complete_delay_iters(rec) for s in self.stages)

    def send_copies(self, rec: tl.OpRecord) -> int:
        return sum(s.send_copies(rec) for s in self.stages)

    def complete_copies(self, rec: tl.OpRecord) -> int:
        return sum(s.complete_copies(rec) for s in self.stages)

    def __repr__(self) -> str:
        fused = "" if self.fused else " unfused"
        return f"MediationPipeline{self.stage_names}{fused}"


def build_pipeline(dp) -> MediationPipeline:
    """Compile a dataplane's effective techniques + policies into stages.

    ``dp`` duck-types a Dataplane: cfg, mode, kernel_bypass, zero_copy,
    polling, enforce, policies, tenants, device."""
    from repro_torch.kernels.dataplane import use_pallas_dataplane
    cfg = dp.cfg
    dev = dp.device
    pallas = use_pallas_dataplane(getattr(cfg, "pallas_dataplane", "auto"),
                                  device=dev)
    stages: list[MediationStage] = []
    mediated = not dp.kernel_bypass        # the OS sees this traffic
    if mediated and cfg.emulate_costs:
        stages.append(SyscallCostStage(cfg.syscall_cost_ns, device=dev))
        if dp.mode == "socket":
            stages.append(SocketStackStage(cfg.socket_stack_ns,
                                           cfg.socket_ns_per_byte,
                                           device=dev))
    if not dp.zero_copy:
        stages.append(StagedCopyStage(pallas=pallas))
    if not dp.polling and cfg.emulate_costs:
        stages.append(InterruptWaitStage(cfg.interrupt_cost_us, device=dev))
    if dp.enforce:
        qos = next((p for p in dp.policies
                    if isinstance(p, QoSPolicy) and p.rates), None)
        if qos is not None:
            stages.append(TokenBucketStage(qos, dp.tenants))
    if mediated:
        quota = next((p for p in dp.policies
                      if isinstance(p, QuotaPolicy)), None) \
            if dp.enforce else None
        stages.append(CounterBumpStage(dp.tenants, quota))
    return MediationPipeline(stages,
                             fused=getattr(cfg, "fuse_mediation", True),
                             pallas=pallas)


def runtime_state_init(tenants: tuple[str, ...], policies: list[Policy],
                       device=None) -> dict:
    """The per-tenant runtime state: a counter block plus each stateful
    policy's slice keyed by name."""
    state = {"counters": tl.tenant_counters_init(len(tenants), device=device)}
    for p in policies:
        ps = p.init_state(len(tenants), device=device)
        if ps is not None:
            state[p.name] = ps
    return state


class HostTokenBucket:
    """Host-side token bucket for serving admission control.  The engine
    refills explicitly once per batching round; ``from_policy`` scales
    rate and burst by ``scale`` tokens per rate unit."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)

    def refill(self) -> None:
        self.tokens = min(self.tokens + self.rate, self.burst)

    def can_take(self, n: float = 1.0) -> bool:
        return self.tokens >= n

    def take(self, n: float = 1.0) -> bool:
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    @classmethod
    def from_policy(cls, qos: QoSPolicy | None,
                    scale: float = 1.0) -> dict[str, "HostTokenBucket"]:
        if qos is None:
            return {}
        return {t: cls(rate * scale, qos.burst * scale)
                for t, rate in qos.rates.items() if rate > 0}


__all__ = [
    "MediationStage", "MediationPipeline", "build_pipeline",
    "runtime_state_init", "SyscallCostStage", "SocketStackStage",
    "StagedCopyStage", "InterruptWaitStage", "TokenBucketStage",
    "CounterBumpStage", "HostTokenBucket",
]
