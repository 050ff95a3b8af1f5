"""CoRD policies (paper §3): "lightweight, non-blocking policies ...
powerful enough to implement QoS, security, and isolation".

A policy sees every dataplane op at issue time and may
  * account it        (TelemetryPolicy — observability)
  * validate it       (SecurityPolicy — registered memory regions only)
  * meter it          (QuotaPolicy — per-tenant byte budgets)
  * throttle it       (QoSPolicy — priority classes + token-bucket limiter)

Each policy has two planes, as in ``repro.core.policies``:

* **issue-time hook** ``on_op`` — the kernel inspecting the WQE; may
  refuse the op by raising :class:`PolicyViolation`.
* **runtime hooks** ``init_state`` / ``on_op_runtime`` — contribute a
  tensor slice to the dataplane's per-tenant runtime state and transform
  ``(x, state)``.  State dicts are never mutated: a hook returns a new
  dict, so a caller's earlier state stays valid.

Runtime hooks are invoked by the mediation pipeline stages
(core/mediation.py), never directly by user code.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from repro_torch.core import techniques as tech
from repro_torch.core import telemetry as tl
from repro_torch.core.mr import MRError, MRRegistry


class PolicyViolation(Exception):
    pass


@dataclass
class PolicyContext:
    """Everything a policy may consult when an op is issued."""
    rec: tl.OpRecord
    tenant: str = "default"
    mr_name: str | None = None
    operand: object | None = None


class Policy:
    """Base policy: no-op on both planes."""

    name = "policy"

    def on_op(self, ctx: PolicyContext) -> None:
        """Issue-time hook. Raise PolicyViolation to reject the op."""

    def reset(self) -> None:
        pass

    def init_state(self, num_tenants: int, device=None):
        """This policy's slice of the runtime state, or None."""
        return None

    def on_op_runtime(self, x, state, rec: tl.OpRecord, tenant: str,
                      tenant_idx: int):
        """Transform ``(x, state)`` for one issued op; keeps ``x``
        value-identical."""
        return x, state


@dataclass
class TelemetryPolicy(Policy):
    """Record every op into the host-side telemetry registry."""

    telemetry: tl.Telemetry = field(default_factory=tl.Telemetry)
    name: str = "telemetry"

    def on_op(self, ctx: PolicyContext) -> None:
        self.telemetry.record(ctx.rec)

    def reset(self) -> None:
        self.telemetry.reset()


@dataclass
class SecurityPolicy(Policy):
    """Only registered memory regions may cross the dataplane."""

    registry: MRRegistry = field(default_factory=MRRegistry)
    strict: bool = False   # strict: unnamed operands are rejected too
    name: str = "security"

    def on_op(self, ctx: PolicyContext) -> None:
        if ctx.mr_name is None:
            if self.strict:
                raise PolicyViolation(
                    f"op {ctx.rec.tag!r}: anonymous operand under strict security")
            return
        try:
            self.registry.check(ctx.mr_name, ctx.operand)
        except MRError as e:
            raise PolicyViolation(str(e)) from e


@dataclass
class QuotaPolicy(Policy):
    """Per-tenant communication byte budgets.

    ``hard=True``: exceeding the budget at issue time raises
    PolicyViolation.  At run time the counter-bump stage calls
    :meth:`on_op_runtime` after bumping the tenant's byte counter, marking
    over-budget traffic in the tenant's ``denied`` counter."""

    limits: dict[str, int] = field(default_factory=dict)   # tenant -> bytes
    used: dict[str, int] = field(default_factory=dict)
    hard: bool = True
    name: str = "quota"

    def on_op(self, ctx: PolicyContext) -> None:
        lim = self.limits.get(ctx.tenant)
        if lim is None:
            return
        used = self.used.get(ctx.tenant, 0) + ctx.rec.bytes * ctx.rec.count
        if used > lim and self.hard:
            raise PolicyViolation(
                f"tenant {ctx.tenant!r} exceeded dataplane quota "
                f"({used} > {lim} bytes)")
        self.used[ctx.tenant] = used

    def on_op_runtime(self, x, state, rec, tenant, tenant_idx):
        lim = self.limits.get(tenant)
        if state is None or lim is None or "counters" not in state:
            return x, state
        ctrs = state["counters"].clone()
        over = (ctrs[tenant_idx, tl.CTR_BYTES] > lim).to(torch.float32)
        ctrs[tenant_idx, tl.CTR_DENIED] += over
        return x, {**state, "counters": ctrs}

    def reset(self) -> None:
        self.used.clear()


@dataclass
class QoSPolicy(Policy):
    """Priority classes + per-tenant token-bucket rate limiting.

    Tenants listed in ``rates`` are limited by a token bucket held in the
    runtime state: each op refills ``rates[tenant]`` tokens (capacity
    ``burst``) and consumes one.  An op on an empty bucket is stalled by a
    serial delay proportional to the deficit (``stall_ns`` per missing
    token) and counted in the tenant's ``throttled`` counter."""

    classes: dict[str, int] = field(default_factory=lambda: {"default": 100})
    rates: dict[str, float] = field(default_factory=dict)  # tenant -> tokens/op
    burst: float = 4.0
    stall_ns: float = 0.0   # emulated stall per missing token; 0 = account only
    name: str = "qos"

    def __post_init__(self):
        self._stall_iters = 0

    def priority(self, qos_class: str) -> int:
        """Issue priority of a class (lower is sooner; unknown: 100)."""
        return self.classes.get(qos_class, 100)

    def on_op(self, ctx: PolicyContext) -> None:
        ctx.rec.qos = ctx.rec.qos or "default"

    def init_state(self, num_tenants: int, device=None):
        if not self.rates:
            return None
        dev = torch.device("cuda" if device is None else device)
        self._stall_iters = tech.iters_for_ns(self.stall_ns, device=dev) \
            if self.stall_ns > 0 else 0
        return {"tokens": torch.full((num_tenants,), float(self.burst),
                                     dtype=torch.float32, device=dev)}

    def on_op_runtime(self, x, state, rec, tenant, tenant_idx):
        rate = self.rates.get(tenant)
        if state is None or rate is None or self.name not in state:
            return x, state
        tokens = state[self.name]["tokens"]
        tk = torch.clamp(tokens[tenant_idx] + rate, max=float(self.burst))
        ok = tk >= 1.0
        zero = torch.zeros_like(tk)
        new_tk = torch.where(ok, tk - 1.0, zero)
        deficit = torch.where(ok, zero, 1.0 - tk)
        if self._stall_iters:
            x = tech.delay_chain_dyn(
                x, (deficit * self._stall_iters).to(torch.int32))
        tokens = tokens.clone()
        tokens[tenant_idx] = new_tk
        state = {**state, self.name: {"tokens": tokens}}
        if "counters" in state:
            ctrs = tl.tenant_counters_bump(
                state["counters"], tenant_idx,
                throttled=(~ok).to(torch.float32))
            state = {**state, "counters": ctrs}
        return x, state

    def on_chunk_runtime(self, x, state, rec, tenant, tenant_idx):
        """The bucket consulted once per chunk of a chunked collective
        (``core/chunking.chunked_psum``): one token a chunk, and a chunk
        that meets a dry bucket stalls on the deficit and is counted as
        throttled before it is issued.  The token arithmetic is
        :meth:`on_op_runtime`'s, so N chunks cost what N ops do; the
        chunks are issued ``precharged`` so the pipeline does not debit
        them again."""
        return self.on_op_runtime(x, state, rec, tenant, tenant_idx)

    def governs(self, tenant: str) -> bool:
        """True if this policy rate-limits ``tenant``."""
        return bool(self.rates.get(tenant))

    # ---- connection-table plane (core/verbs.py conn_send) ---------------
    # The multi-QP transport arbitrates post order across tenants' QPs
    # with this same bucket; the winning QP is known only at run time, so
    # the static on_op_runtime hook cannot serve it.

    def rates_for(self, tenants: tuple[str, ...]) -> tuple[float, ...]:
        """Per-QP refill rates (0.0 = ungoverned) in QP order."""
        return tuple(float(self.rates.get(t) or 0.0) for t in tenants)

    def arb_scores(self, state, tenant_idx_arr, rates_arr):
        """Tokens-after-refill per QP, the score ``conn_send`` ranks posts
        by.  Ungoverned QPs (rate 0) score above any governed bucket, so
        QoS only ever demotes governed tenants.  Reads the same
        ``state["qos"]["tokens"]`` the token-bucket stage debits."""
        tokens = state[self.name]["tokens"]
        tk = torch.clamp(tokens[tenant_idx_arr] + rates_arr,
                         max=float(self.burst))
        return torch.where(rates_arr > 0, tk,
                           torch.full_like(tk, float(self.burst) + 1.0))

    def charge_wr(self, state, tenant_idx, rate, mask, bump_mask=None):
        """Token-bucket refill and debit for one arbitrated WR.
        ``tenant_idx`` is an int or a 0-d integer tensor; ``rate``, ``mask``
        and ``bump_mask`` are Python values or tensors.  ``mask`` gates the
        token update, which the caller applies to every rank's state (the
        bucket is connection state for the arbitration loop);
        ``bump_mask`` also gates the ``throttled`` bump (runtime state, the
        active rank only).  No stall: arbitration already prefers
        token-rich QPs, and a dry winner is only counted."""
        if state is None or self.name not in state:
            return state
        m = mask & (rate > 0)
        if m is False:
            return state
        tokens = state[self.name]["tokens"]
        tk = torch.clamp(tokens[tenant_idx] + rate, max=float(self.burst))
        ok = tk >= 1.0
        new_tk = torch.where(ok, tk - 1.0, torch.zeros_like(tk))
        tokens = tokens.clone()
        tokens[tenant_idx] = new_tk if m is True else \
            torch.where(m, new_tk, tokens[tenant_idx])
        state = {**state, self.name: {"tokens": tokens}}
        bm = m if bump_mask is None else (m & bump_mask)
        if "counters" in state and bm is not False:
            ctrs = tl.tenant_counters_bump(
                state["counters"], tenant_idx,
                throttled=(bm & ~ok).to(torch.float32))
            state = {**state, "counters": ctrs}
        return state


def default_policies() -> list[Policy]:
    return [TelemetryPolicy()]


__all__ = [
    "Policy", "PolicyContext", "PolicyViolation",
    "TelemetryPolicy", "SecurityPolicy", "QuotaPolicy", "QoSPolicy",
    "default_policies",
]
