"""Control-plane smokes, the port of ``benchmarks/run.py``'s
``elastic_smoke`` and ``control_plane_smoke``: the watchers over
per-tenant timelines trip, and the response (a live QP migration, a
slot-budget move) runs on the device the caller names.

    python -m repro_torch.bench.control_plane [--device cpu]

Each smoke asserts its storyline and prints one JSON row.  ``repro``'s
two "hosts" are disjoint 2-device meshes; here each is a ``("rank",)``
mesh descriptor of 2 ranks on the one device with its own
:class:`~repro_torch.core.dataplane.Dataplane`, runtime state and QP.
Two such descriptors are equal (``Mesh`` is a frozen dataclass), so a
migration shows in the other dataplane, state and QP that the transfer
continues on, never in which descriptor it names.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.bench import perftest
from repro_torch.configs.base import DataplaneConfig, ElasticConfig
from repro_torch.core import verbs
from repro_torch.core.dataplane import Dataplane
from repro_torch.core.obs import (CounterTimeline, ThresholdWatcher,
                                  WatcherGroup, merge_timelines)
from repro_torch.core.policies import QoSPolicy, QuotaPolicy, TelemetryPolicy
from repro_torch.device import resolve_device
from repro_torch.runtime import ServeElasticController

N_MSGS, MSG_BYTES, WINDOW = 8, 1024, 4
QUOTA_BYTES = 2048       # observe-only: every round's runtime bytes blow it
SNAP_KEYS = ("sq_head", "cq_sent", "credits", "rx_owed")


def accumulate_report(totals: dict, report: dict) -> dict:
    """Fold one per-tenant counter report into host-side cumulative
    totals: additive columns sum, the ``cq_depth`` high-water mark takes
    the max.  The smokes rebuild a cumulative timeline from repeated
    fresh-state transfers with it."""
    for tenant, ctrs in report.items():
        acc = totals.setdefault(tenant, dict.fromkeys(ctrs, 0.0))
        for k, v in ctrs.items():
            acc[k] = max(acc[k], v) if k == "cq_depth" else acc[k] + v
    return totals


def _metered_dp(device, quota: bool = True) -> Dataplane:
    """A cord dataplane with cost emulation on a 2-rank ``("rank",)``
    mesh; with ``quota``, an observe-only 2 KiB budget marks the traffic
    over it in the tenant's ``denied`` counter."""
    policies = [TelemetryPolicy()]
    if quota:
        policies.append(QuotaPolicy(hard=False,
                                    limits={"default": QUOTA_BYTES}))
    return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                     mesh=perftest.make_mesh2(), policies=policies,
                     device=device)


def _payload(device):
    payload = np.arange(N_MSGS * MSG_BYTES, dtype=np.uint8) \
        .reshape(N_MSGS, MSG_BYTES)
    msgs = torch.from_numpy(np.stack([payload, np.zeros_like(payload)])) \
        .to(device)
    return msgs, payload


def _delivered(out) -> np.ndarray:
    return out[1].cpu().numpy()


def _check_snap(qp, qp_full, what: str) -> None:
    snap_l, snap_f = verbs.qp_snapshot(qp), verbs.qp_snapshot(qp_full)
    for key in SNAP_KEYS:
        if int(snap_l[key]) != int(snap_f[key]):
            raise AssertionError(f"{key} diverged across {what}")


def elastic_smoke(device=None,
                  out_path: str = "runs/torch/elastic_timeline.json"
                  ) -> dict:
    """A sustained ``denied`` rate trips the ThresholdWatcher exactly once
    (hysteresis + cooldown hold), a windowed transfer in flight at
    trigger time survives a live QP migration onto another 2-rank mesh
    (its own dataplane and state) bit for bit, and the saved v2 timeline
    artifact validates with the remesh event recorded."""
    device = resolve_device(device)
    dp_a, dp_b = _metered_dp(device), _metered_dp(device)
    mesh_b = dp_b.mesh
    msgs, payload = _payload(device)
    conn_a = perftest.build_migratable(dp_a.mesh, dp_a, MSG_BYTES, WINDOW,
                                       credits=N_MSGS)
    conn_b = perftest.build_migratable(mesh_b, dp_b, MSG_BYTES, WINDOW)

    # watched run: repeated transfers, denied% over the threshold in
    # every window; hysteresis must fire exactly once
    timeline = CounterTimeline(source="bench-elastic")
    watcher = ThresholdWatcher({"denied_pct": 40.0}, sustain=2, cooldown=16)
    totals: dict[str, dict[str, float]] = {}
    for i in range(1, 7):
        qp, _ = conn_a["init"](dp_a.runtime_init())
        _, _, rt = conn_a["xfer"](msgs, qp, dp_a.runtime_init())
        accumulate_report(totals, dp_a.runtime_report(rt))
        timeline.snapshot(i, {t: dict(a) for t, a in totals.items()},
                          gauges=watcher.gauges())
        for ev in watcher.observe(timeline):
            timeline.record_event(ev["kind"], ev["step"],
                                  tenant=ev["tenant"], t=ev["t"],
                                  detail=ev["detail"])
    if len(watcher.triggers) != 1:
        raise AssertionError(f"hysteresis broke: {len(watcher.triggers)} "
                             f"triggers, expected 1")
    trigger_step = watcher.triggers[0]["step"]
    if trigger_step != 1 + watcher.sustain:
        raise AssertionError(f"trigger at step {trigger_step}, expected "
                             f"{1 + watcher.sustain}")

    # the response: live QP migration of an in-flight transfer, against
    # one uninterrupted transfer on host A
    qp, _ = conn_a["init"](dp_a.runtime_init())
    full_out, qp_full, _ = conn_a["xfer"](msgs, qp, dp_a.runtime_init())
    k = N_MSGS // 2
    qp, _ = conn_a["init"](dp_a.runtime_init())
    out1, qp, _ = conn_a["xfer"](msgs[:, :k], qp, dp_a.runtime_init())
    qp, _ = conn_a["quiesce"](qp, dp_a.runtime_init())
    snap = verbs.qp_snapshot(qp)
    if int(snap["cq_head"] - snap["cq_tail"]) != 0:
        raise AssertionError("CQ not quiesced")
    if int(snap["credits"]) != N_MSGS - k:
        raise AssertionError("credits lost in migration")
    qp_b = verbs.qp_restore(snap, mesh_b, device=device)
    out2, qp_b, _ = conn_b["xfer"](msgs[:, k:], qp_b, dp_b.runtime_init())
    moved = np.concatenate([_delivered(out1), _delivered(out2)])
    np.testing.assert_array_equal(moved, _delivered(full_out))
    np.testing.assert_array_equal(moved, payload)
    _check_snap(qp_b, qp_full, "the migration")
    timeline.record_event(
        "remesh", trigger_step, tenant="default",
        detail={"from": "mesh_a", "to": "mesh_b", "migrated_msgs": k})

    path = timeline.save(out_path)
    doc = CounterTimeline.load(path)              # schema validation (v2)
    kinds = [e["kind"] for e in doc["events"]]
    if kinds.count("trigger") != 1 or kinds.count("remesh") != 1:
        raise AssertionError(f"events {kinds}")
    row = {"table": "dryrun", "elastic_timeline": path,
           "trigger_step": trigger_step, "migrated_bit_identical": True,
           "events": kinds}
    print(json.dumps(row))
    return {**row, "doc": doc}


def control_plane_smoke(
        device=None, *, smoke: bool = True,
        out_path: str = "runs/torch/control_plane_timeline.json") -> dict:
    """Pod-scale control-plane smoke: two "hosts", one carrying
    quota-metered train-side verbs traffic, the other a serving engine
    (gemma3-1b, the smoke config unless ``smoke=False``) with a
    rate-limited tenant, stream per-process timelines that merge
    step-aligned into ONE pod timeline each round.  A
    :class:`WatcherGroup` runs a train-remesh watcher and a serve-budget
    watcher over the merged rates:

    * the noisy phase trips BOTH.  The train response live-migrates an
      in-flight windowed QP transfer onto the spare host (shrink); the
      serve response halves the engine's per-tenant slot budget.
    * the quiet phase fires both release arms: the still-in-flight
      transfer migrates BACK onto its original host (grow) and the
      budget is restored.

    The migrated transfer must complete bit for bit an uninterrupted one
    across BOTH migrations, and the saved merged pod artifact must
    validate with trigger→remesh(shrink)→recover→remesh(grow) and both
    budget moves recorded."""
    from repro_torch.configs import get_model_config
    from repro_torch.configs.base import ServeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, Request

    device = resolve_device(device)
    # host 0: train-side traffic over the observe-only quota; host 1's
    # spare ranks carry it unmetered after the shrink
    dp_a, dp_b = _metered_dp(device), _metered_dp(device, quota=False)
    mesh_a, mesh_b = dp_a.mesh, dp_b.mesh
    conn_a = perftest.build_migratable(mesh_a, dp_a, MSG_BYTES, WINDOW,
                                       credits=N_MSGS)
    conn_b = perftest.build_migratable(mesh_b, dp_b, MSG_BYTES, WINDOW)
    msgs, _ = _payload(device)

    # host 1: an engine whose "burst" tenant is admission-limited, so its
    # deferrals (the throttled column) climb while requests queue
    cfg = get_model_config("gemma3-1b", smoke=smoke)
    model = build_model(cfg, device=device)
    params = model.init(0)
    dp_serve = Dataplane(
        DataplaneConfig(mode="cord", emulate_costs=True),
        mesh=make_mesh((8,), ("data",)), tenant="steady",
        tenants=("steady", "burst"),
        policies=[TelemetryPolicy(),
                  QoSPolicy(rates={"burst": 0.1}, burst=1.0)],
        device=device)
    eng = Engine(model, params, cfg,
                 ServeConfig(max_batch=2, max_new_tokens=4,
                             kv_cache_len=64),
                 dp=dp_serve, eos_id=-1)

    tl_a = CounterTimeline(source="host0")   # controller host: events here
    tl_b = CounterTimeline(source="host1")
    group = WatcherGroup({
        "train": ThresholdWatcher({"denied_pct": 40.0}, sustain=2,
                                  cooldown=1, tenants=("default",),
                                  release={"denied_pct": 5.0},
                                  release_sustain=2, release_cooldown=8),
        "serve": ThresholdWatcher({"throttled_pct": 10.0}, sustain=2,
                                  cooldown=1, tenants=("burst",),
                                  release={"throttled_pct": 1.0},
                                  release_sustain=2, release_cooldown=8),
    })
    serve_ctl = ServeElasticController(
        ElasticConfig(enabled=True, shrink_factor=2), tl_a, eng)

    # the in-flight migratable transfer and its uninterrupted baseline
    qp_full, _ = conn_a["init"](dp_a.runtime_init())
    full_out, qp_full, _ = conn_a["xfer"](msgs, qp_full, dp_a.runtime_init())
    k1, k2 = 3, 6                       # migration points: A | B | A again
    parts: list[np.ndarray] = []
    qp_live = None                      # in-flight QP, wherever it lives

    def wave(i):
        return [Request(rid=10 * i + j,
                        prompt=np.asarray((np.arange(8) + i + j) % 97,
                                          np.int32),
                        max_new_tokens=4,
                        tenant="burst" if j == 2 else "steady")
                for j in range(3)]

    totals: dict[str, dict[str, float]] = {}
    seen: list[str] = []                # the pod-level event storyline
    for i in range(1, 7):
        if i <= 3:
            # host 0 under pressure: a fresh quota-blowing transfer
            qp, _ = conn_a["init"](dp_a.runtime_init())
            _, _, rt = conn_a["xfer"](msgs, qp, dp_a.runtime_init())
            accumulate_report(totals, dp_a.runtime_report(rt))
            eng.run(wave(i))            # host 1 under pressure too
        else:
            # post-shrink quiet: host 0's tenant runs clean on the spare
            # ranks (no quota there), host 1 goes idle
            if qp_live is not None and len(parts) == 1:
                out, qp_live, rt = conn_b["xfer"](msgs[:, k1:k2], qp_live,
                                                  dp_b.runtime_init())
                parts.append(_delivered(out))
            else:
                qp, _ = conn_b["init"](dp_b.runtime_init())
                _, _, rt = conn_b["xfer"](msgs, qp, dp_b.runtime_init())
            accumulate_report(totals, dp_b.runtime_report(rt))
        tl_a.snapshot(i, {t: dict(a) for t, a in totals.items()},
                      gauges=group.gauges(), t=float(i))
        tl_b.snapshot_block(i, *eng.runtime_counters(), t=float(i))

        pod = merge_timelines([tl_a, tl_b], source="pod")
        evs = group.observe(pod, record=False)
        for ev in evs["train"] + evs["serve"]:
            tl_a.record_event(ev["kind"], ev["step"], tenant=ev["tenant"],
                              t=ev["t"], detail=ev["detail"])
            seen.append(f"{ev['detail']['watcher']}:{ev['kind']}")
        for ev in evs["train"]:
            if ev["kind"] == "trigger":
                # shrink response: migrate the in-flight transfer A → B
                qp_live, _ = conn_a["init"](dp_a.runtime_init())
                out, qp_live, _ = conn_a["xfer"](msgs[:, :k1], qp_live,
                                                 dp_a.runtime_init())
                parts.append(_delivered(out))
                qp_live, _ = conn_a["quiesce"](qp_live, dp_a.runtime_init())
                snap = verbs.qp_snapshot(qp_live)
                if int(snap["credits"]) != N_MSGS - k1:
                    raise AssertionError(f"credits {snap['credits']}")
                qp_live = verbs.qp_restore(snap, mesh_b, device=device)
                tl_a.record_event("remesh", i, tenant="default",
                                  t=float(i) + 0.5,
                                  detail={"watcher": "train",
                                          "direction": "shrink",
                                          "from": "mesh_a", "to": "mesh_b",
                                          "migrated_msgs": k1})
                seen.append("train:remesh-shrink")
            elif ev["kind"] == "recover":
                # grow-back: migrate the STILL-in-flight transfer B → A
                qp_live, _ = conn_b["quiesce"](qp_live, dp_b.runtime_init())
                snap = verbs.qp_snapshot(qp_live)
                if int(snap["credits"]) != N_MSGS - k2:
                    raise AssertionError(f"credits {snap['credits']}")
                qp_live = verbs.qp_restore(snap, mesh_a, device=device)
                out, qp_live, _ = conn_a["xfer"](msgs[:, k2:], qp_live,
                                                 dp_a.runtime_init())
                parts.append(_delivered(out))
                tl_a.record_event("remesh", i, tenant="default",
                                  t=float(i) + 0.5,
                                  detail={"watcher": "train",
                                          "direction": "grow",
                                          "from": "mesh_b", "to": "mesh_a",
                                          "migrated_msgs": N_MSGS - k2})
                seen.append("train:remesh-grow")
        serve_ctl.respond(evs["serve"])

    # the storyline closed in order, once each
    head = ["train:trigger", "serve:trigger", "train:remesh-shrink"]
    if seen not in (head + ["train:recover", "serve:recover",
                            "train:remesh-grow"],
                    head + ["serve:recover", "train:recover",
                            "train:remesh-grow"]):
        raise AssertionError(f"storyline {seen}")
    if not (serve_ctl.shrinks == 1 and serve_ctl.grows == 1):
        raise AssertionError(f"budget moves {serve_ctl.shrinks} / "
                             f"{serve_ctl.grows}")
    if eng.slot_budget() != 2:
        raise AssertionError(f"slot budget {eng.slot_budget()} not restored")

    # bit for bit across BOTH migrations
    moved = np.concatenate(parts)
    np.testing.assert_array_equal(moved, _delivered(full_out))
    _check_snap(qp_live, qp_full, "shrink+grow migration")

    # the merged pod artifact records the whole cycle
    pod = merge_timelines([tl_a, tl_b], source="pod")
    path = pod.save(out_path)
    doc = CounterTimeline.load(path)             # schema validation (v2)
    kinds = [e["kind"] for e in doc["events"]]
    dirs = [e["detail"]["direction"] for e in doc["events"]
            if e["kind"] == "remesh"]
    budget_dirs = [e["detail"]["direction"] for e in doc["events"]
                   if e["kind"] == "budget"]
    if dirs != ["shrink", "grow"] or budget_dirs != ["shrink", "grow"]:
        raise AssertionError(f"remesh {dirs}, budget {budget_dirs}")
    if kinds.count("trigger") != 2 or kinds.count("recover") != 2:
        raise AssertionError(f"events {kinds}")
    if not {"default", "steady", "burst"} <= set(doc["tenants"]):
        raise AssertionError(f"merged tenants {doc['tenants']}")
    row = {"table": "dryrun", "control_plane_timeline": path,
           "storyline": seen, "slot_budget": eng.slot_budget(),
           "migrated_bit_identical": True}
    print(json.dumps(row))
    return {**row, "doc": doc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    control_plane_smoke(args.device)
    elastic_smoke(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
