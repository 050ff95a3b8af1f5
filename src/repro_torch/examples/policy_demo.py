"""CoRD policies in action, in four acts; the port of
``examples/policy_demo.py``:

1. telemetry, quotas and memory-region security enforced on a live
   dataplane — the OS-level control the paper regains;
2. runtime QoS throttling of a noisy tenant, observed through a
   two-tenant timeline;
3. the elastic response: a ThresholdWatcher trips on the noisy tenant's
   sustained throttle rate and the run remeshes it onto a shrunken
   2-rank mesh slice, after which the victim's throughput recovers;
4. the pod-scale hierarchy: two "hosts" stream per-process timelines
   that merge step-aligned into ONE pod timeline, and a WatcherGroup
   runs a train-remesh watcher and a serve-budget watcher over the
   merged rates — shrink on sustained pressure, grow back on sustained
   quiet, the full closed cycle.

    python -m repro_torch.examples.policy_demo [--device cpu]

``repro``'s ``shard_map`` bodies over 8 host devices become rank-stacked
calls on the port's mesh descriptor (``launch/mesh.py``): a tensor's
leading dim holds the ranks, and the dataplane's ``psum`` reduces over
it, as ``bench/control_plane.py`` does.  Its jitted ``lax.scan`` of 16
bursts is a Python loop of 16.  ``repro`` checks the quota when a
program is traced, the port when an op runs: act 1's loop is refused at
the same iteration, with the bytes of the executed ops in the message.
"""

from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs.base import DataplaneConfig, ElasticConfig
from repro_torch.core import (
    CounterTimeline,
    Dataplane,
    PolicyViolation,
    ThresholdWatcher,
    WatcherGroup,
    merge_timelines,
)
from repro_torch.core.policies import (
    QoSPolicy,
    QuotaPolicy,
    SecurityPolicy,
    TelemetryPolicy,
)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import ServeElasticController, shrink_mesh

RANKS = 8
BURST = 16          # repro's lax.scan length


def _size(mesh) -> int:
    return math.prod(mesh.shape)


def _shards(n: int, mesh, device) -> torch.Tensor:
    """``jnp.ones((n,))`` sharded ``P("data")`` over ``mesh``: a
    rank-stacked (R, n / R) tensor of ones."""
    r = _size(mesh)
    return torch.ones((r, n // r), device=device)


def _burst(dp, tenants, g, rt):
    """``repro``'s scanned burst body, 16 times: one psum of the shard's
    sum for each tenant in turn, threading the runtime state."""
    for _ in range(BURST):
        outs = []
        for tenant in tenants:
            s, rt = dp.psum(g.sum(dim=1), "data", tag=f"{tenant}/op",
                            state=rt, tenant=tenant)
            outs.append(s)
        for s in outs:
            g = g + 0 * s[:, None]
    return g, rt


def _noisy_qos(tenant: str) -> list:
    return [TelemetryPolicy(),
            QoSPolicy(rates={tenant: 0.25}, burst=2.0, stall_ns=5e6)]


def act1(device) -> dict:
    """Telemetry, quota and strict security on a live dataplane."""
    mesh = make_mesh((RANKS,), ("data",))
    dp = Dataplane(
        DataplaneConfig(mode="cord"), mesh=mesh, tenant="team-a",
        policies=[TelemetryPolicy(), SecurityPolicy(),
                  QuotaPolicy(limits={"team-a": 4096})], device=device)

    grads = _shards(512, mesh, device)
    dp.reg_mr("grads", torch.ones(64, device=device))   # the per-shard region

    def sync(g):
        out, _ = dp.psum(g, "data", tag="grads/allreduce",
                         mr="grads" if g.shape[1:] == (64,) else None)
        return out

    out = sync(grads)
    print("allreduce under full policy stack ok:", float(out[0, 0]))
    print(dp.telemetry.report())

    # quota exhaustion: repro enforces at op-issue (trace) time, the port
    # when each op runs — issue progressively larger payloads until the
    # tenant's byte budget runs out
    refused_at = None
    try:
        for i in range(1, 32):
            g = _shards(512 * i, mesh, device)
            dp.reg_mr("grads", torch.ones(64 * i, device=device))
            refused_at = i
            sync(g)
        refused_at = None
        print("quota never hit (unexpected)")
    except PolicyViolation as e:
        print(f"\nquota enforced: {e}")

    # security: unregistered traffic is refused
    dp2 = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh,
                    policies=[SecurityPolicy(strict=True)], device=device)
    security_msg = None
    try:
        dp2.psum(grads, "data", tag="rogue")
        print("rogue op allowed (unexpected)")
    except PolicyViolation as e:
        security_msg = str(e)
        print(f"strict security refused anonymous op: {e}")
    return {"quota_refused_at": refused_at, "security_msg": security_msg}


def act2(device) -> dict:
    """Runtime QoS: the mediation pipeline's token bucket throttles the
    "noisy" tenant's op rate; the per-tenant counters come back in the
    runtime state, snapshotted between bursts into a timeline.  stall_ns
    is the emulated cost a throttled op pays in the program, large enough
    that noisy's stalls tax any tenant sharing a program with it (the
    act-3 remesh undoes that)."""
    mesh = make_mesh((RANKS,), ("data",))
    dp3 = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh,
                    tenant="victim", tenants=("victim", "noisy"),
                    policies=_noisy_qos("noisy"), device=device)
    grads = _shards(512, mesh, device)
    rt = dp3.runtime_init()
    timeline = CounterTimeline(source="policy-demo")
    for round_ in range(1, 7):
        _, rt = _burst(dp3, ("noisy", "victim"), grads, rt)
        timeline.snapshot(round_, dp3.runtime_report(rt))
    report = dp3.runtime_report(rt)
    print("\nper-tenant runtime accounting:")
    for tenant, ctrs in report.items():
        print(f"  {tenant:8s} {ctrs}")
    print("\ntwo-tenant timeline (6 burst rounds, noisy throttled):")
    print(timeline.panel(width=24))
    return {"mesh": mesh, "grads": grads, "report": report,
            "timeline": timeline}


def act3(device, a2: dict) -> dict:
    """The elastic response: a watcher trips on noisy's sustained
    throttle rate, and the remesh moves noisy onto a shrunken 2-rank
    slice while victim keeps the full mesh; the victim's throughput
    recovers because its burst no longer carries noisy's stalls."""
    mesh, grads, timeline = a2["mesh"], a2["grads"], a2["timeline"]
    watcher = ThresholdWatcher({"throttled_pct": 90.0}, sustain=3,
                               cooldown=8, tenants=("noisy",))
    for ev in watcher.observe(timeline):
        timeline.record_event(ev["kind"], ev["step"], tenant=ev["tenant"],
                              t=ev["t"], detail=ev["detail"])
    small = shrink_mesh(mesh, factor=4)          # 8 ranks -> a 2-rank slice
    timeline.record_event("remesh", step=6, tenant="noisy",
                          detail={"devices_before": _size(mesh),
                                  "devices_after": _size(small)})
    dp_victim = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh,
                          tenant="victim", policies=[TelemetryPolicy()],
                          device=device)
    dp_noisy = Dataplane(DataplaneConfig(mode="cord"), mesh=small,
                         tenant="noisy", policies=_noisy_qos("noisy"),
                         device=device)
    rtv, rtn = dp_victim.runtime_init(), dp_noisy.runtime_init()
    base = a2["report"]                 # act-2 totals stay cumulative
    small_grads = _shards(128, small, device)
    v_wall = v_ops = 0
    for round_ in range(7, 11):
        t0 = time.perf_counter()
        _, rtv = _burst(dp_victim, ("victim",), grads, rtv)
        rep_v = dp_victim.runtime_report(rtv)["victim"]  # waits for the burst
        if round_ > 7:                  # round 7 warms up, as repro's compile
            v_wall += time.perf_counter() - t0
            v_ops += BURST
        _, rtn = _burst(dp_noisy, ("noisy",), small_grads, rtn)
        rep_n = dp_noisy.runtime_report(rtn)["noisy"]
        timeline.snapshot(
            round_,
            {"victim": {k: base["victim"][k] + rep_v[k] for k in rep_v},
             "noisy": {k: base["noisy"][k] + rep_n[k] for k in rep_n}},
            gauges=watcher.gauges())
        # keep watching: post-remesh windows tick the cooldown down, and
        # a still-misbehaving tenant can re-trigger once it expires
        for ev in watcher.observe(timeline):
            timeline.record_event(ev["kind"], ev["step"],
                                  tenant=ev["tenant"], t=ev["t"],
                                  detail=ev["detail"])

    print("\ntimeline events (watcher trigger -> remesh):")
    for ev in timeline.events:
        print(f"  round {ev['step']} {ev['kind']:8s} "
              f"{ev['tenant']}: {ev['detail']}")
    print("\nthree-act timeline (rounds 7-10 after noisy's remesh):")
    print(timeline.panel(width=24))
    # pre-remesh the victim's ops share a burst with noisy's (its wall
    # clock includes noisy's stalls); post-remesh the victim's burst is
    # timed alone — the wall it actually experiences
    pre = timeline.rates()["victim"]["ops_s"][1:5]       # windows 2-5
    print(f"victim ops_s: pre-remesh {sum(pre) / len(pre):.0f} "
          f"(sharing a program with throttled noisy) -> "
          f"post-remesh {v_ops / v_wall:.0f} (alone on the full mesh)")
    return {"events": list(timeline.events), "remeshed_to": _size(small)}


class SlotKnob:
    """Stands in for a serving Engine's slot-budget interface — the real
    thing is Engine.slot_budget/set_slot_budget, driven the same way by
    launch/serve.py --elastic and bench/control_plane.py."""

    def __init__(self, cap=4):
        self._cap, self._default = 0, cap

    def slot_budget(self):
        return self._cap or self._default

    def set_slot_budget(self, n):
        prev, self._cap = self._cap, max(int(n), 0)
        return prev


def act4(device) -> dict:
    """Two 4-rank "hosts" snapshot their own timelines; the controller
    host merges them step-aligned and one WatcherGroup reads the merged
    pod rates: a train-remesh watcher and a serve-budget watcher, each
    with a release arm, each driving its own response."""
    mesh_h0 = make_mesh((4,), ("data",))
    mesh_h1 = make_mesh((4,), ("data",))
    dp_h0 = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh_h0,
                      tenant="noisy", policies=_noisy_qos("noisy"),
                      device=device)
    dp_h1 = Dataplane(DataplaneConfig(mode="cord"), mesh=mesh_h1,
                      tenant="api", policies=_noisy_qos("api"),
                      device=device)
    small_grads = _shards(128, mesh_h0, device)
    rt0, rt1 = dp_h0.runtime_init(), dp_h1.runtime_init()
    tl_h0 = CounterTimeline(source="host0")  # controller host: events here
    tl_h1 = CounterTimeline(source="host1")

    knob = SlotKnob()
    group = WatcherGroup({
        "train": ThresholdWatcher({"throttled_pct": 50.0}, sustain=2,
                                  cooldown=1, tenants=("noisy",),
                                  release={"throttled_pct": 5.0},
                                  release_sustain=2),
        "serve": ThresholdWatcher({"throttled_pct": 50.0}, sustain=2,
                                  cooldown=1, tenants=("api",),
                                  release={"throttled_pct": 5.0},
                                  release_sustain=2),
    })
    serve_ctl = ServeElasticController(
        ElasticConfig(enabled=True, shrink_factor=2), tl_h0, knob)
    mesh_stack = []                     # the train response's grow-back state
    moves = []

    print("\nact 4 — pod-scale watcher hierarchy over a merged timeline:")
    for i in range(1, 7):
        if i <= 3:                      # noisy phase: both hosts loaded
            _, rt0 = _burst(dp_h0, ("noisy",), small_grads, rt0)
            _, rt1 = _burst(dp_h1, ("api",), small_grads, rt1)
        tl_h0.snapshot(i, dp_h0.runtime_report(rt0),
                       gauges=group.gauges(), t=float(i))
        tl_h1.snapshot(i, dp_h1.runtime_report(rt1), t=float(i))
        pod = merge_timelines([tl_h0, tl_h1], source="pod")
        evs = group.observe(pod, record=False)
        for ev in evs["train"] + evs["serve"]:
            tl_h0.record_event(ev["kind"], ev["step"], tenant=ev["tenant"],
                               t=ev["t"], detail=ev["detail"])
        for ev in evs["train"]:
            if ev["kind"] == "trigger":
                small4 = shrink_mesh(mesh_h0, factor=2)
                mesh_stack.append(mesh_h0)
                moves.append(("shrink", i, _size(small4)))
                print(f"  round {i}: train watcher tripped -> remesh "
                      f"noisy {_size(mesh_h0)} -> {_size(small4)} devices")
                tl_h0.record_event("remesh", i, tenant="noisy",
                                   t=float(i) + 0.5,
                                   detail={"watcher": "train",
                                           "direction": "shrink"})
            elif ev["kind"] == "recover" and mesh_stack:
                back = mesh_stack.pop()
                moves.append(("grow", i, _size(back)))
                print(f"  round {i}: sustained quiet -> grow noisy back "
                      f"to {_size(back)} devices")
                tl_h0.record_event("remesh", i, tenant="noisy",
                                   t=float(i) + 0.5,
                                   detail={"watcher": "train",
                                           "direction": "grow"})
        before = knob.slot_budget()
        serve_ctl.respond(evs["serve"])
        if knob.slot_budget() != before:
            print(f"  round {i}: serve watcher -> slot budget "
                  f"{before} -> {knob.slot_budget()}")

    pod = merge_timelines([tl_h0, tl_h1], source="pod")
    print("pod events (merged from both hosts, origin-tagged):")
    for ev in pod.events:
        print(f"  round {ev['step']} {ev['kind']:8s} {ev['tenant']}: "
              f"{ev['detail']}")
    print(f"slot budget closed the cycle: back at {knob.slot_budget()}")
    return {"events": list(pod.events), "moves": moves,
            "slot_budget": knob.slot_budget(), "shrinks": serve_ctl.shrinks,
            "grows": serve_ctl.grows}


def run(device=None) -> dict:
    """All four acts on ``device`` (default ``cuda``); returns each act's
    outcome."""
    device = resolve_device(device)
    out = {"act1": act1(device)}
    a2 = act2(device)
    out["act2"] = a2
    out["act3"] = act3(device, a2)
    out["act4"] = act4(device)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
