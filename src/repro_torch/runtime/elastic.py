"""Elastic scaling, the port of ``repro.runtime.elastic``: move a training
state onto a different mesh, and the closed control loop that decides
*when* (docs/elasticity.md).

The port's mesh is a descriptor (``launch/mesh.py``): axis names and
sizes over ranks that share one card.  Specs stay *logical*
(``parallel/sharding.py``), so growing or shrinking the mesh is: derive
the specs for the new mesh, check them against the shapes, and place
the state, which on one card is the identity.

* :func:`shrink_mesh` carves a smaller mesh out of a mesh (same axis
  names, fewer ranks): the elastic response's target.
* :class:`ElasticController` closes the loop: a
  :class:`~repro_torch.core.obs.ThresholdWatcher` over a
  :class:`~repro_torch.core.obs.CounterTimeline`'s rate series
  (``denied_pct``, ``throttled_pct``, ``stalls_pct``) trips on sustained
  over-threshold windows, and the controller moves the state onto a
  shrunken mesh with :func:`remesh` mid-run, recording
  ``trigger``/``remesh`` events into the timeline artifact.  In-flight
  verbs connections survive a move through live QP migration
  (``qp_quiesce``/``qp_snapshot``/``qp_restore`` in core/verbs.py).
* :class:`ServeElasticController` answers the same signal on the serve
  side by moving the engine's per-tenant slot budget.

Two equal descriptors describe the same mesh (``Mesh`` is a frozen
dataclass), so nothing here decides by comparing meshes: the controller
keeps its own stack of the meshes it shrank from.
"""

from __future__ import annotations

import math

from repro_torch.core.obs import CounterTimeline, ThresholdWatcher
from repro_torch.launch.mesh import Mesh, make_mesh, mesh_axis_sizes
from repro_torch.parallel.sharding import P, param_specs
from repro_torch.train.step import _check_specs


def state_shardings(state, mesh: Mesh, *, fsdp: bool = False):
    """The spec pytree of a ``TrainState`` on ``mesh``, each spec checked
    against its leaf's shape for ``mesh``'s sizes (what ``repro``'s
    ``NamedSharding`` of the same specs requires)."""
    sizes = mesh_axis_sizes(mesh)
    pspec = param_specs(state.params, fsdp=fsdp, mesh_sizes=sizes)
    _check_specs(pspec, state.params, sizes, "parameter")
    err = None
    if state.err is not None:
        err = param_specs(state.err, fsdp=fsdp, mesh_sizes=sizes)
        _check_specs(err, state.err, sizes, "error-feedback")
    return type(state)(
        params=pspec,
        opt=type(state.opt)(step=P(), mu=pspec, nu=pspec),
        step=P(), err=err)


def remesh(state, new_mesh: Mesh, *, fsdp: bool = False):
    """Move a live ``TrainState`` onto ``new_mesh`` (elastic grow/shrink).

    Every rank of a mesh shares the one card, and a ``TrainState``
    carries no rank dim: params, moments, step and error feedback are
    held once (``train/step.py``).  So after the specs are checked for
    the new mesh, placement is the identity and every leaf comes back
    bit for bit, as the same tensor.  What does carry a rank dim is built
    by the step, not held in the state: the (R, ...) gradient buffers of
    ``rank_grads`` / ``sync_grads`` and the rank-expanded error feedback.
    The caller's rebuild of the step on the new mesh re-sizes them.  The
    explicit step's runtime state (``dp.runtime_init()``) is one state,
    not one per rank (every rank's pipeline starts from it and rank 0's
    result carries on, as ``repro``'s replicated state does), so it
    carries over unchanged."""
    state_shardings(state, new_mesh, fsdp=fsdp)
    return state


def shrink_mesh(mesh: Mesh, factor: int = 2, *,
                min_devices: int = 1) -> Mesh | None:
    """A shrunken slice of ``mesh``: same axis names, ``1/factor`` of the
    ranks, taken off the largest axis.  Returns ``None`` when no smaller
    mesh exists (the largest axis cannot absorb the factor, or the result
    would fall under ``min_devices``): the caller keeps the current
    mesh."""
    shape = list(mesh.shape)
    axis = max(range(len(shape)), key=lambda i: shape[i])
    if factor < 2 or shape[axis] < factor:
        return None
    new_shape = list(shape)
    new_shape[axis] = shape[axis] // factor
    n = math.prod(new_shape)
    if n < max(min_devices, 1):
        return None
    return make_mesh(new_shape, mesh.axis_names)


def _size(mesh: Mesh) -> int:
    return math.prod(mesh.shape)


class ElasticController:
    """The closed OS-control loop: timeline rates → threshold watcher →
    remesh onto a shrunken mesh (docs/elasticity.md).

    Built from an :class:`~repro_torch.configs.base.ElasticConfig`; call
    :meth:`drive` after each timeline snapshot.  It consumes any new
    windows through the watcher (logging ``trigger``/``recover`` events
    into the timeline); when a tenant trips and the remesh budget
    (``cfg.max_remesh``, shrinks only) allows, it shrinks the current
    mesh by ``cfg.shrink_factor``, moves ``state`` onto it with
    :func:`remesh` and records a ``remesh`` event
    (``detail["direction"] == "shrink"``).  With the watcher's release
    arm configured (``cfg.release_thresholds``), a later ``recover``
    event drives :meth:`grow_mesh`: the state moves *back* onto the
    pre-shrink mesh (popped off a shrink-history stack), recorded as a
    ``remesh`` with ``direction == "grow"``.  The caller rebuilds what
    was built for the old mesh (the Dataplane, the step) whenever
    ``drive`` reports a move; see ``launch/train.py --elastic``."""

    def __init__(self, cfg, timeline: CounterTimeline, mesh: Mesh, *,
                 fsdp: bool = False):
        self.cfg = cfg
        self.timeline = timeline
        self.mesh = mesh
        self.fsdp = fsdp
        self.watcher = ThresholdWatcher.from_config(cfg)
        self.remeshes = 0              # shrink count (the budgeted kind)
        self.grows = 0
        self._mesh_stack: list[Mesh] = []   # pre-shrink meshes, LIFO

    def _skip(self, ev, step: int, reason: str) -> None:
        """A trigger the controller cannot answer is recorded, not
        swallowed: the artifact explains why the remesh never happened."""
        self.timeline.record_event("remesh-skipped", step,
                                   tenant=(ev or {}).get("tenant"),
                                   detail={"reason": reason})

    def drive(self, state, step: int):
        """Observe → record → respond.  Returns ``(state, moved)``; when
        ``moved`` the state now lives on the updated ``self.mesh``."""
        events = self.watcher.observe(self.timeline)
        for ev in events:
            self.timeline.record_event(ev["kind"], ev["step"],
                                       tenant=ev["tenant"], t=ev["t"],
                                       detail=ev["detail"])
        return self.respond(state, step, events)

    def respond(self, state, step: int, events):
        """Apply already-recorded watcher events (the entry point for a
        :class:`~repro_torch.core.obs.WatcherGroup`)."""
        moved = False
        for ev in events:
            if ev["kind"] == "trigger":
                state, m = self._shrink(state, step, ev)
            elif ev["kind"] == "recover":
                state, m = self.grow_mesh(state, step, ev)
            else:
                continue
            moved = moved or m
        return state, moved

    def _shrink(self, state, step: int, ev):
        if self.cfg.max_remesh and self.remeshes >= self.cfg.max_remesh:
            self._skip(ev, step, "max_remesh budget exhausted")
            return state, False
        new_mesh = shrink_mesh(self.mesh, self.cfg.shrink_factor,
                               min_devices=self.cfg.min_devices)
        if new_mesh is None:
            self._skip(ev, step,
                       f"no smaller mesh: shape "
                       f"{tuple(self.mesh.shape)} cannot shrink by "
                       f"{self.cfg.shrink_factor} above min_devices="
                       f"{self.cfg.min_devices}")
            return state, False
        state = remesh(state, new_mesh, fsdp=self.fsdp)
        old_mesh, self.mesh = self.mesh, new_mesh
        self._mesh_stack.append(old_mesh)
        self.remeshes += 1
        self.timeline.record_event(
            "remesh", step, tenant=ev["tenant"],
            detail={"direction": "shrink",
                    "devices_before": _size(old_mesh),
                    "devices_after": _size(new_mesh),
                    "mesh_shape": list(new_mesh.shape)})
        return state, True

    def grow_mesh(self, state, step: int, ev=None):
        """Grow-back: move ``state`` onto the most recently shrunken-from
        mesh (LIFO, so nested shrinks unwind in order).  Returns ``(state,
        moved)``; a recover with no shrink on record logs a
        ``remesh-skipped``."""
        if not self._mesh_stack:
            self._skip(ev, step, "nothing to grow back to: no shrink on "
                                 "record for this controller")
            return state, False
        new_mesh = self._mesh_stack.pop()
        state = remesh(state, new_mesh, fsdp=self.fsdp)
        old_mesh, self.mesh = self.mesh, new_mesh
        self.grows += 1
        self.timeline.record_event(
            "remesh", step, tenant=(ev or {}).get("tenant"),
            detail={"direction": "grow",
                    "devices_before": _size(old_mesh),
                    "devices_after": _size(new_mesh),
                    "mesh_shape": list(new_mesh.shape)})
        return state, True


class ServeElasticController:
    """Serve-side elasticity: the same watcher signal, a far cheaper
    response (docs/elasticity.md).  Instead of remeshing, a trigger
    shrinks the engine's per-tenant slot budget
    (:meth:`~repro_torch.serve.engine.Engine.set_slot_budget`, enforced
    by preemption with exact temperature-0 resume) and a ``recover``
    restores the pre-shrink budget.  Attach to a running engine with
    ``Engine(..., obs=timeline)`` and ``engine.on_tick = ctl.tick`` (what
    ``launch/serve.py --elastic`` wires), or hand a
    :class:`~repro_torch.core.obs.WatcherGroup`'s serve slice to
    :meth:`respond`."""

    def __init__(self, cfg, timeline: CounterTimeline, engine):
        self.cfg = cfg
        self.timeline = timeline
        self.engine = engine
        self.watcher = ThresholdWatcher.from_config(cfg)
        self.shrinks = 0
        self.grows = 0
        self._saved_cap: int | None = None  # raw pre-shrink budget override

    def tick(self, engine=None) -> None:
        """Engine ``on_tick`` hook: observe any new timeline windows,
        record the fired events, apply the budget response."""
        events = self.watcher.observe(self.timeline)
        for ev in events:
            self.timeline.record_event(ev["kind"], ev["step"],
                                       tenant=ev["tenant"], t=ev["t"],
                                       detail=ev["detail"])
        self.respond(events)

    def respond(self, events) -> None:
        """Apply already-recorded watcher events (the
        :class:`~repro_torch.core.obs.WatcherGroup` entry point)."""
        for ev in events:
            if ev["kind"] == "trigger":
                self._shrink_budget(ev)
            elif ev["kind"] == "recover":
                self._grow_budget(ev)

    def _skip(self, ev, reason: str) -> None:
        self.timeline.record_event("budget-skipped", ev["step"],
                                   tenant=ev.get("tenant"),
                                   detail={"reason": reason})

    def _shrink_budget(self, ev) -> None:
        if self._saved_cap is not None:
            self._skip(ev, "slot budget already shrunk; awaiting recover")
            return
        if self.cfg.max_remesh and self.shrinks >= self.cfg.max_remesh:
            self._skip(ev, "max_remesh budget exhausted")
            return
        before = self.engine.slot_budget()
        after = max(before // self.cfg.shrink_factor, 1)
        if after >= before:
            self._skip(ev, f"slot budget already at the floor ({before})")
            return
        self._saved_cap = self.engine.set_slot_budget(after)
        self.shrinks += 1
        self.timeline.record_event(
            "budget", ev["step"], tenant=ev.get("tenant"),
            detail={"direction": "shrink",
                    "slots_before": int(before), "slots_after": int(after)})

    def _grow_budget(self, ev) -> None:
        if self._saved_cap is None:
            self._skip(ev, "nothing to grow back to: no budget shrink on "
                           "record for this controller")
            return
        before = self.engine.slot_budget()
        self.engine.set_slot_budget(self._saved_cap)
        self._saved_cap = None
        self.grows += 1
        self.timeline.record_event(
            "budget", ev["step"], tenant=ev.get("tenant"),
            detail={"direction": "grow", "slots_before": int(before),
                    "slots_after": int(self.engine.slot_budget())})


__all__ = ["state_shardings", "remesh", "shrink_mesh", "ElasticController",
           "ServeElasticController"]
