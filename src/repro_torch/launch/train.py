"""Training launcher: ``python -m repro_torch.launch.train --arch gemma3-1b
[--mode cord] [--smoke | --full] [--ranks N] [--timeline]
[--timeline-sink PATH] [--timeline-rotate BYTES] [--elastic]
[--device cuda|cpu] [key=value overrides...]``

Runs the explicit-DP step (``train/step.make_explicit_dp_step``) over
``make_local_mesh(N)``: ``--ranks N`` ranks (default 1) on the one card,
in place of ``repro``'s count of host devices.  It runs through a
dataplane of the chosen mode, on synthetic data from ``seed``, inside the
fault-tolerant ``run_loop``: ``checkpoint_every``, ``checkpoint_dir`` and
``async_checkpoint`` checkpoint it, and a second run with the same
``checkpoint_dir`` resumes from the latest checkpoint.  It prints the
final loss and the telemetry report.  The overrides set
``TrainConfig`` fields (``steps=3 seq_len=256 global_batch=4``), as
``repro.launch.train``'s do; ``elastic.*`` overrides set
``ElasticConfig`` fields; ``model.*`` overrides are accepted and
ignored, as ``repro``'s launcher ignores them.

``--timeline`` switches the step to ``runtime_accounting=True`` (the
per-tenant runtime state threaded through the gradient sync) and
snapshots ``dp.runtime_report`` into a
:class:`~repro_torch.core.obs.CounterTimeline` every ``obs.every`` steps,
strictly between steps: one device-to-host copy of the counter block a
snapshot, so the trained state is bit-identical to a run without the
flag.  The run writes ``runs/torch/<arch>_timeline.json`` (the port's
artifacts sit in ``<obs.out_dir>/torch/``, beside ``repro``'s) and
prints per-tenant sparkline panels.  ``--timeline-sink PATH`` also
streams every snapshot/event to a JSONL file as the run goes;
``--timeline-rotate BYTES`` seals the sink into ``PATH.1..N`` segments
once each passes the size (``CounterTimeline.read_rotated`` stitches
them back together).

``--elastic`` (implies ``--timeline``) closes the control loop: an
:class:`~repro_torch.runtime.elastic.ElasticController` watches the
timeline's rate series against ``ElasticConfig`` thresholds with
hysteresis, and on a sustained over-threshold signal moves the live
``TrainState`` onto a shrunken mesh mid-run, rebuilding the dataplane
and the step for the new rank count and recording ``trigger`` /
``remesh`` events into the artifact.  With ``elastic.meter_quota_bytes``
set, an observe-only ``QuotaPolicy`` marks the traffic over that budget
in the tenant's ``denied`` counter, the default trigger signal, e.g.
``elastic.thresholds=denied_pct=50 elastic.sustain=3
elastic.meter_quota_bytes=1000000``.
"""

from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import apply_overrides, get_model_config
from repro_torch.configs.base import (
    DataplaneConfig,
    ElasticConfig,
    ObsConfig,
    RunConfig,
    TrainConfig,
)
from repro_torch.core import CounterTimeline, Dataplane
from repro_torch.core.policies import QuotaPolicy, TelemetryPolicy
from repro_torch.core.tree import tree_map
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM, to_torch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.runtime import ElasticController, run_loop
from repro_torch.train import init_state, make_explicit_dp_step


def main(argv=None):
    """Run the launcher; returns ``(state, report)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--mode", default="cord",
                    choices=["bypass", "cord", "socket"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ranks", type=int, default=1,
                    help="data-parallel ranks on the one card (default 1); "
                         "stands in for repro's count of host devices")
    ap.add_argument("--timeline", action="store_true",
                    help="thread per-tenant runtime accounting through the "
                         "step and write runs/torch/<arch>_timeline.json")
    ap.add_argument("--timeline-sink", default=None, metavar="PATH",
                    help="stream timeline snapshots/events to a JSONL file "
                         "as the run progresses")
    ap.add_argument("--timeline-rotate", type=int, default=0,
                    metavar="BYTES",
                    help="rotate the JSONL sink into PATH.1..N segments "
                         "once each passes this many bytes (0 = never)")
    ap.add_argument("--elastic", action="store_true",
                    help="watch the timeline rate series and remesh onto a "
                         "shrunken mesh on sustained over-threshold "
                         "windows (implies --timeline)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    # model.* overrides are filtered out and applied nowhere, as in repro:
    # the run goes on with the arch's config
    train = apply_overrides(TrainConfig(), [
        o for o in args.overrides
        if not o.startswith(("model.", "elastic."))])
    elastic = apply_overrides(
        ElasticConfig(enabled=args.elastic),
        [o[len("elastic."):] for o in args.overrides
         if o.startswith("elastic.")])
    obs = ObsConfig(timeline=args.timeline or elastic.enabled
                    or bool(args.timeline_sink))
    run = RunConfig(train=train, obs=obs, elastic=elastic)
    mesh = make_local_mesh(args.ranks)
    policies = None
    if elastic.enabled and elastic.meter_quota_bytes:
        # observe-only metering: runtime traffic over the budget marks the
        # tenant's `denied` counter, the watcher's default trigger signal
        policies = [TelemetryPolicy(),
                    QuotaPolicy(hard=False,
                                limits={"default": elastic.meter_quota_bytes})]
    ctx = {"dp": Dataplane(DataplaneConfig(mode=args.mode), mesh=mesh,
                           policies=policies, device=model.device)}
    ctx["step"] = make_explicit_dp_step(model, run, ctx["dp"], axis="data",
                                        runtime_accounting=obs.timeline)
    def initial_state():
        state = init_state(model, train.seed,
                           compression=train.grad_compression,
                           opt_dtype=train.opt_dtype)
        # the step hands back its error-feedback state as a tree (0-d
        # zeros without compression) even when given None: start in that
        # shape, so that a later run restores a checkpoint of any step
        # into a fresh state
        int8 = train.grad_compression == "int8"
        return state._replace(err=tree_map(
            lambda p: torch.zeros(p.shape if int8 else (),
                                  dtype=torch.float32, device=p.device),
            state.params))

    loader = ShardedLoader(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=train.seq_len,
        global_batch=train.global_batch, seed=train.seed)))

    timeline = CounterTimeline(source=f"train/{args.arch}",
                               sink=args.timeline_sink,
                               rotate_bytes=args.timeline_rotate
                               if args.timeline_sink else 0) \
        if obs.timeline else None
    controller = ElasticController(elastic, timeline, mesh) \
        if elastic.enabled else None
    rt = {"state": ctx["dp"].runtime_init(), "step": 0} \
        if obs.timeline else None

    def rebuild(new_mesh) -> None:
        """Rebuild the dataplane and the step for the new rank count,
        keeping the policy objects (cumulative metering)."""
        ctx["dp"] = Dataplane(DataplaneConfig(mode=args.mode), mesh=new_mesh,
                              policies=ctx["dp"].policies,
                              device=model.device)
        ctx["step"] = make_explicit_dp_step(model, run, ctx["dp"],
                                            axis="data",
                                            runtime_accounting=True)

    def on_device(s, batch):
        batch = to_torch(batch, model.device)
        if rt is None:
            return ctx["step"](s, batch)
        s, metrics, rt["state"] = ctx["step"](s, batch, rt["state"])
        rt["step"] += 1
        if rt["step"] % obs.every == 0:
            # one host read of the counter block, strictly between steps
            gauges = controller.watcher.gauges() if controller else None
            timeline.snapshot(rt["step"],
                              ctx["dp"].runtime_report(rt["state"]),
                              gauges=gauges)
            if controller is not None:
                s, moved = controller.drive(s, rt["step"])
                if moved:
                    # the runtime state is one state, not one per rank:
                    # it carries over to the rebuilt step unchanged
                    rebuild(controller.mesh)
                    print(f"[elastic] remeshed onto {controller.mesh.shape} "
                          f"at step {rt['step']}")
        return s, metrics

    # the state goes to run_loop with no other reference held here: the
    # step updates it in place, as repro's steps donate it
    state, report = run_loop(
        on_device, initial_state(), loader, steps=train.steps,
        ckpt_dir=train.checkpoint_dir if train.checkpoint_every else None,
        checkpoint_every=train.checkpoint_every,
        async_ckpt=train.async_checkpoint, log_every=train.log_every)
    final = report.metrics[-1]["loss"] if report.metrics else float("nan")
    print(f"done: {report.steps_run} steps, final loss {final:.4f}")
    print(ctx["dp"].telemetry.report())
    if timeline is not None:
        path = timeline.save(os.path.join(obs.out_dir, "torch",
                                          f"{args.arch}_timeline.json"))
        timeline.close()
        print(f"timeline artifact: {path} ({len(timeline.samples)} samples, "
              f"{len(timeline.events)} events)")
        for ev in timeline.events:
            print(f"  event step {ev['step']:4d} {ev['kind']:8s} "
                  f"{ev['tenant']}: {ev['detail']}")
        if obs.panel:
            print(timeline.panel(width=obs.spark_width))
    return state, report


if __name__ == "__main__":
    main()
