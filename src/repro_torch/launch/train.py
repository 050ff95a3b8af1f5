"""Training launcher: ``python -m repro_torch.launch.train --arch gemma3-1b
[--mode cord] [--smoke | --full] [--device cuda|cpu] [key=value
overrides...]``

Runs the explicit-DP step (``train/step.make_explicit_dp_step``) over
``make_local_mesh()`` (one rank, the card) through a dataplane of the
chosen mode, on synthetic data from ``seed``, inside the fault-tolerant
``run_loop``: ``checkpoint_every``, ``checkpoint_dir`` and
``async_checkpoint`` checkpoint it, and a second run with the same
``checkpoint_dir`` resumes from the latest checkpoint.  It prints the
final loss and the telemetry report.  The overrides set
``TrainConfig`` fields (``steps=3 seq_len=256 global_batch=4``), as
``repro.launch.train``'s do.

``--timeline``, ``--timeline-sink``, ``--timeline-rotate`` and
``--elastic`` belong to the port's timeline and control-plane slices and
raise.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import apply_overrides, get_model_config
from repro_torch.configs.base import DataplaneConfig, RunConfig, TrainConfig
from repro_torch.core import Dataplane
from repro_torch.core.tree import tree_map
from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM, to_torch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.runtime import run_loop
from repro_torch.train import init_state, make_explicit_dp_step


def main(argv=None):
    """Run the launcher; returns ``(state, report)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--mode", default="cord",
                    choices=["bypass", "cord", "socket"])
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--timeline", action="store_true",
                    help="per-step counter timelines (a later slice)")
    ap.add_argument("--timeline-sink", default=None, metavar="PATH",
                    help="stream timeline snapshots to JSONL (a later "
                         "slice)")
    ap.add_argument("--timeline-rotate", type=int, default=0,
                    metavar="BYTES",
                    help="rotate the JSONL sink (a later slice)")
    ap.add_argument("--elastic", action="store_true",
                    help="remesh on sustained over-threshold windows (a "
                         "later slice)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("overrides", nargs="*", default=[])
    args = ap.parse_args(argv)
    if (args.timeline or args.timeline_sink or args.timeline_rotate
            or args.elastic):
        raise NotImplementedError(
            "--timeline, --timeline-sink, --timeline-rotate and --elastic "
            "are ported with the timelines and control-plane slices "
            "(ROADMAP Queue 1 items 3 and 5)")
    if any(o.startswith(("model.", "elastic.")) for o in args.overrides):
        raise NotImplementedError("model.* and elastic.* overrides are not "
                                  "ported")

    cfg = get_model_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, device=args.device)
    train = apply_overrides(TrainConfig(), args.overrides)
    run = RunConfig(train=train)
    dp = Dataplane(DataplaneConfig(mode=args.mode), mesh=make_local_mesh(),
                   device=model.device)
    step = make_explicit_dp_step(model, run, dp, axis="data")
    state = init_state(model, train.seed,
                       compression=train.grad_compression,
                       opt_dtype=train.opt_dtype)
    # the step hands back its error-feedback state as a tree (0-d zeros
    # without compression) even when given None: start in that shape, so
    # that a later run restores a checkpoint of any step into a fresh state
    int8 = train.grad_compression == "int8"
    state = state._replace(err=tree_map(
        lambda p: torch.zeros(p.shape if int8 else (), dtype=torch.float32,
                              device=p.device), state.params))
    loader = ShardedLoader(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=train.seq_len,
        global_batch=train.global_batch, seed=train.seed)))

    def on_device(s, batch):
        return step(s, to_torch(batch, model.device))

    state, report = run_loop(
        on_device, state, loader, steps=train.steps,
        ckpt_dir=train.checkpoint_dir if train.checkpoint_every else None,
        checkpoint_every=train.checkpoint_every,
        async_ckpt=train.async_checkpoint, log_every=train.log_every)
    final = report.metrics[-1]["loss"] if report.metrics else float("nan")
    print(f"done: {report.steps_run} steps, final loss {final:.4f}")
    print(dp.telemetry.report())
    return state, report


if __name__ == "__main__":
    main()
