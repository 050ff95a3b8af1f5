"""The Converged Dataplane — the paper's contribution, in PyTorch.

Every communication edge of the model is issued through a
:class:`Dataplane`: the model code calls :meth:`constrain` with logical
axis names, the dataplane resolves them against its sharding rules,
records the edge, runs its mediation pipeline's send side, and places the
tensor on the mesh.  The port's mesh is one card (``launch/mesh.py``), so
the placement is the identity, while the mediation work is real: with
``emulate_costs=True`` in ``cord`` mode every edge launches the dataplane
kernel on the card.

The explicit collectives (:meth:`psum`, :meth:`all_gather`,
:meth:`reduce_scatter`, :meth:`all_to_all`, :meth:`ppermute`; the
gradient sync's path) take and return *rank-stacked* tensors: the mesh
axis they span has R ranks on the one card, and slice ``r`` of the
leading dim is rank ``r``'s shard.  Each is one :meth:`_mediate`, as in
``repro``'s ``shard_map`` body: one record describing one rank's shard;
the pipeline's send and complete sides once per rank on that rank's
slice (so the dataplane kernel launches once per rank and side with
work, and its counters cover one shard as in ``repro``); the collective
itself over the leading dim in plain torch.  Given one runtime state,
rank 0 carries it; ranks 1..R-1 run the same pipeline from the same
incoming state and their result state is dropped, as ``out_specs=P()``
keeps one of ``repro``'s replicated copies.  Given a list of R states,
one per rank (the verbs transport's, whose ranks diverge by design),
each rank's pipeline runs on its own state and the R results come back.

Three modes (paper Fig. 2):

====== ============= ========= ============ =========================
mode   kernel-bypass zero-copy polling      policies enforced
====== ============= ========= ============ =========================
bypass yes           yes       yes          none (OS has no control)
cord   **no**        yes       yes          all configured policies
socket **no**        **no**    **no**       all + heavy stack cost
====== ============= ========= ============ =========================

Technique toggles in :class:`DataplaneConfig` override the mode presets.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Sequence

import torch

from repro_torch.configs.base import DataplaneConfig
from repro_torch.core import techniques as tech
from repro_torch.core import telemetry as tl
from repro_torch.core.mediation import build_pipeline, runtime_state_init
from repro_torch.core.mr import MRRegistry
from repro_torch.core.obs import span
from repro_torch.core.policies import (
    Policy,
    PolicyContext,
    PolicyViolation,
    QoSPolicy,
    QuotaPolicy,
    SecurityPolicy,
    TelemetryPolicy,
)
from repro_torch.device import resolve_device

_MODE_PRESETS = {
    "bypass": dict(kernel_bypass=True, zero_copy=True, polling=True, enforce=False),
    "cord": dict(kernel_bypass=False, zero_copy=True, polling=True, enforce=True),
    "socket": dict(kernel_bypass=False, zero_copy=False, polling=False, enforce=True),
}

_POLICY_FACTORIES: dict[str, Callable[[], Policy]] = {
    "telemetry": TelemetryPolicy,
    "security": SecurityPolicy,
    "quota": QuotaPolicy,
    "qos": QoSPolicy,
}


class Dataplane:
    """The narrow waist: all framework communication flows through here.

    ``device`` is where the runtime state lives and what the delay chain
    is calibrated on; it defaults to ``cuda``."""

    def __init__(
        self,
        cfg: DataplaneConfig | None = None,
        mesh=None,
        rules: dict[str, Any] | None = None,
        tenant: str = "default",
        tenants: Sequence[str] | None = None,
        policies: Sequence[Policy] | None = None,
        device=None,
    ) -> None:
        self.cfg = cfg or DataplaneConfig()
        self.mesh = mesh
        self.rules = dict(rules or {})
        self.tenant = tenant
        self.device = resolve_device(device)
        names = list(tenants if tenants is not None else self.cfg.tenants)
        if tenant not in names:
            names.insert(0, tenant)
        self.tenants: tuple[str, ...] = tuple(names)
        if self.cfg.mode not in _MODE_PRESETS:
            raise ValueError(f"unknown dataplane mode {self.cfg.mode!r}")
        preset = _MODE_PRESETS[self.cfg.mode]
        self.kernel_bypass = preset["kernel_bypass"] and self.cfg.kernel_bypass
        self.zero_copy = preset["zero_copy"] and self.cfg.zero_copy
        self.polling = preset["polling"] and self.cfg.polling
        self.enforce = preset["enforce"]
        if policies is not None:
            self.policies = list(policies)
        else:
            self.policies = [_POLICY_FACTORIES[p]() for p in self.cfg.policies]
        self._telemetry = next(
            (p.telemetry for p in self.policies if isinstance(p, TelemetryPolicy)),
            tl.Telemetry(enabled=False))
        self._security = next(
            (p for p in self.policies if isinstance(p, SecurityPolicy)), None)
        self.registry: MRRegistry = (self._security.registry
                                     if self._security else MRRegistry())
        if self.cfg.emulate_costs:
            # calibrate now, outside any timed region
            tech.calibrate(device=self.device)
        self.pipeline = build_pipeline(self)
        self._recomputing = 0

    @property
    def telemetry(self) -> tl.Telemetry:
        return self._telemetry

    @property
    def mode(self) -> str:
        return self.cfg.mode

    def with_mode(self, mode: str) -> "Dataplane":
        return Dataplane(dataclasses.replace(self.cfg, mode=mode),
                         mesh=self.mesh, rules=self.rules, tenant=self.tenant,
                         tenants=self.tenants, device=self.device)

    def axis_size(self, axis) -> int:
        """Ranks that mesh axis (or axes) ``axis`` spans: the leading dim
        of a rank-stacked tensor there."""
        if self.mesh is None:
            raise ValueError("explicit collectives need a mesh")
        return self.mesh.axis_size(tl.normalize_axes(axis))

    # ------------------------------------------------------------------
    # per-tenant runtime state
    # ------------------------------------------------------------------
    def tenant_index(self, tenant: str | None = None) -> int:
        name = tenant or self.tenant
        try:
            return self.tenants.index(name)
        except ValueError:
            raise KeyError(
                f"unknown tenant {name!r}; known tenants: {self.tenants}")

    def runtime_init(self) -> dict:
        """Per-tenant runtime state on this dataplane's device."""
        return runtime_state_init(self.tenants, self.policies,
                                  device=self.device)

    def runtime_report(self, state) -> dict:
        return tl.tenant_counters_report(state["counters"], self.tenants)

    # ------------------------------------------------------------------
    # mediation core
    # ------------------------------------------------------------------
    def _policy_pass(self, rec: tl.OpRecord, operand, mr_name: str | None,
                     tenant: str) -> None:
        if not self.enforce:
            return
        ctx = PolicyContext(rec=rec, tenant=tenant, mr_name=mr_name,
                            operand=operand)
        for p in self.policies:
            p.on_op(ctx)    # raises PolicyViolation to refuse the op

    @contextlib.contextmanager
    def recomputing(self):
        """Run a recomputed forward (``torch.utils.checkpoint``'s second
        pass): its edges still run the pipeline, so the cost kernel
        launches again, as XLA reruns a rematerialised body; but nothing
        is recorded and no policy sees the edge twice.  ``repro`` records
        an edge when it traces it, once however often it runs."""
        self._recomputing += 1
        try:
            yield
        finally:
            self._recomputing -= 1

    def _record(self, kind: str, tag: str, x, axes, qos: str = "default",
                mr: str | None = None, count: int = 1,
                tenant: str | None = None,
                precharged: bool = False) -> tl.OpRecord:
        shape, dtype = tl.describe(x)
        rec = tl.OpRecord(kind=kind, tag=tag, bytes=tl.nbytes(x),
                          axes=tl.normalize_axes(axes),
                          shape=shape, dtype=dtype, mode=self.cfg.mode,
                          qos=qos, count=count, precharged=precharged)
        if not self._recomputing:
            self._policy_pass(rec, x, mr, tenant or self.tenant)
        return rec

    def spec(self, names: Sequence[str | None | tuple]) -> tuple:
        """Resolve logical axis names to a partition spec (a tuple with one
        entry per dim: None, an axis name, or a tuple of names) via the
        rules.  A mesh axis appears at most once — first occurrence wins."""
        out: list = []
        used: set[str] = set()

        def take(axes):
            kept = [a for a in axes if a not in used]
            used.update(kept)
            return kept

        for n in names:
            if n is None:
                out.append(None)
                continue
            subs = n if isinstance(n, (tuple, list)) else [n]
            merged: list[str] = []
            for sub in subs:
                r = self.rules.get(sub)
                if r is None:
                    continue
                merged.extend(take(list(r) if isinstance(r, (tuple, list))
                                  else [r]))
            out.append(tuple(merged) if len(merged) > 1
                       else (merged[0] if merged else None))
        return tuple(out)

    def constrain(self, x, names: Sequence[str | None | tuple],
                  tag: str = "constraint", qos: str = "default",
                  tenant: str | None = None):
        """Issue a sharding edge through the dataplane: record it, run the
        pipeline's send side (state None: stateful stages are inert), and
        place it on the mesh — the identity on one card.  Without a mesh
        the edge is not a dataplane op and ``x`` is returned untouched."""
        if self.mesh is None:
            return x
        with span("dataplane.edge", kind="constraint", tag=tag) as s:
            spec = self.spec(names)
            rec = self._record("constraint", tag, x, spec, qos,
                               tenant=tenant)
            s.note(bytes=rec.bytes)
            x, _ = self.pipeline.send(x, rec, None, self.tenant_index(tenant))
            return x

    # ------------------------------------------------------------------
    # explicit collectives over rank-stacked tensors — uniform (out, state)
    # ------------------------------------------------------------------
    def _mediate(self, collective, kind: str, x, axis, tag: str, *,
                 mr: str | None, state, qos: str, tenant: str | None,
                 precharged: bool = False):
        """One dataplane op: record (one rank's shard) → pipeline.send per
        rank → collective → pipeline.complete per rank.  All five explicit
        collectives are this.  ``collective`` maps the list of the ranks'
        sent shards to the list of their outputs.  ``state`` is one state
        (rank 0's result is returned) or a list of R, one per rank (the
        list of results is returned)."""
        r = self.axis_size(axis)
        if x.dim() < 1 or x.shape[0] != r:
            raise ValueError(f"{kind} over {axis!r} wants a rank-stacked "
                             f"tensor with leading dim {r}, got "
                             f"{tuple(x.shape)}")
        per_rank = isinstance(state, (list, tuple))
        if per_rank and len(state) != r:
            raise ValueError(f"{kind} over {axis!r} wants {r} per-rank "
                             f"states, got {len(state)}")
        with span("dataplane.edge", kind=kind, tag=tag) as s:
            rec = self._record(kind, tag, x[0], axis, qos, mr, tenant=tenant,
                               precharged=precharged)
            s.note(bytes=rec.bytes)
            ti = self.tenant_index(tenant)
            sent, states = [], []
            for i in range(r):
                xi, st = self.pipeline.send(
                    x[i], rec, state[i] if per_rank else state, ti)
                sent.append(xi)
                states.append(st)
            outs = collective(sent)
            done = []
            for i in range(r):
                oi, st = self.pipeline.complete(outs[i], rec, states[i], ti)
                done.append(oi)
                states[i] = st
            return _stack_ranks(done), (states if per_rank else states[0])

    def psum(self, x, axis, tag: str = "psum", mr: str | None = None,
             state=None, qos: str = "default", tenant: str | None = None,
             precharged: bool = False):
        """Every rank gets the sum of the ranks' shards, added in rank
        order.  ``precharged=True`` marks an op whose QoS tokens were
        already debited at chunk granularity by the issuer — the
        token-bucket stage skips it."""
        return self._mediate(_sum_ranks, "all_reduce", x, axis, tag, mr=mr,
                             state=state, qos=qos, tenant=tenant,
                             precharged=precharged)

    def all_gather(self, x, axis, tag: str = "all_gather", *,
                   gather_axis: int = 0, tiled: bool = False,
                   mr: str | None = None, state=None, qos: str = "default",
                   tenant: str | None = None):
        def gather(xs):
            out = (torch.cat(xs, dim=gather_axis) if tiled
                   else torch.stack(xs, dim=gather_axis))
            return [out] * len(xs)
        return self._mediate(gather, "all_gather", x, axis, tag, mr=mr,
                             state=state, qos=qos, tenant=tenant)

    def reduce_scatter(self, x, axis, tag: str = "reduce_scatter", *,
                       scatter_axis: int = 0, mr: str | None = None,
                       state=None, qos: str = "default",
                       tenant: str | None = None):
        def scatter(xs):
            total = _sum_ranks(xs)[0]
            return [c.contiguous() for c in _split_ranks(total, len(xs),
                                                         scatter_axis)]
        return self._mediate(scatter, "reduce_scatter", x, axis, tag, mr=mr,
                             state=state, qos=qos, tenant=tenant)

    def all_to_all(self, x, axis, tag: str = "all_to_all", *,
                   split_axis: int = 0, concat_axis: int = 0,
                   mr: str | None = None, state=None, qos: str = "default",
                   tenant: str | None = None):
        def exchange(xs):
            parts = [_split_ranks(t, len(xs), split_axis) for t in xs]
            return [torch.cat([p[j] for p in parts], dim=concat_axis)
                    for j in range(len(xs))]
        return self._mediate(exchange, "all_to_all", x, axis, tag, mr=mr,
                             state=state, qos=qos, tenant=tenant)

    def ppermute(self, x, axis, perm, tag: str = "ppermute",
                 mr: str | None = None, state=None, qos: str = "default",
                 tenant: str | None = None):
        """Rank ``dst`` gets rank ``src``'s shard for each ``(src, dst)``
        of ``perm``; a rank that is no destination gets zeros."""
        def permute(xs):
            out = [torch.zeros_like(xs[0])] * len(xs)
            for src, dst in perm:
                out[dst] = xs[src]
            return out
        return self._mediate(permute, "collective_permute", x, axis, tag,
                             mr=mr, state=state, qos=qos, tenant=tenant)

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------
    def reg_mr(self, name: str, x, tenant: str | None = None):
        """Control-plane memory registration (ioctl path in the paper)."""
        return self.registry.reg_mr(name, x, tenant or self.tenant)


def _sum_ranks(xs: list) -> list:
    total = xs[0]
    for t in xs[1:]:
        total = total + t
    return [total] * len(xs)


def _split_ranks(t: torch.Tensor, r: int, dim: int) -> tuple:
    n = t.shape[dim]
    if n % r:
        raise ValueError(f"dim {dim} of extent {n} does not split over {r} "
                         f"ranks")
    return torch.split(t, n // r, dim=dim)


def _stack_ranks(outs: list) -> torch.Tensor:
    """The ranks' outputs as one rank-stacked tensor; when every rank
    holds the same tensor (a psum's sum), a broadcast view of it."""
    first = outs[0]
    if all(o is first for o in outs):
        return first.unsqueeze(0).expand(len(outs), *first.shape)
    return torch.stack(outs)


__all__ = ["Dataplane", "PolicyViolation"]
