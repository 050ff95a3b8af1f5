"""Converged train+serve benchmark: one dataplane, contending tenants; the
port of ``benchmarks/converged.py``.

    python -m repro_torch.bench.converged [--fast] [--dry-run] [--device cpu]

The converged-cloud scenario the paper argues for: a data-parallel train
job and latency-sensitive serve tenants share ONE dataplane, with the
kernel-owned control plane (QoS classes + per-tenant token buckets)
arbitrating between them instead of static partitioning.  Each round
interleaves one explicit-DP train step (gradient all-reduce issued
through the dataplane, runtime accounting on) with a wave of serve
requests from two tenants on a continuous-batching engine.

``repro`` runs the train step on an 8-device ``("data",)`` mesh; here the
8 ranks are the leading dim of rank-stacked tensors on one device
(``launch/mesh.py``), as in the port's train launcher.  The model is
``repro``'s smoke gemma3 unless the caller passes another config (the
card runs full-width gemma3-1b).  The engine serves parameters from seed
0 and the train state starts from seed 1, two separate parameter sets
as in ``repro``.

The run emits one schema-versioned timeline artifact
(``runs/torch/converged_timeline.json``): per-tick serve snapshots from
the engine plus a ``train_step`` control-plane event per round carrying
the loss and the train tenant's cumulative throttle count.  The A/B rows
go to ``runs/torch/BENCH_converged.json``.

``--dry-run`` is the CI smoke: with the train tenant rate-limited by a
:class:`~repro_torch.core.policies.QoSPolicy` token bucket, every round
must (a) complete its train step with a finite loss, (b) serve a nonzero
token count to EACH serve tenant — serving never starves while training
runs — and (c) account train throttling in the shared runtime state; the
final artifact must validate round-trip.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_model_config
from repro_torch.configs.base import (DataplaneConfig, RunConfig,
                                      ServeConfig, TrainConfig)
from repro_torch.core import Dataplane, QoSPolicy, TelemetryPolicy
from repro_torch.core.obs import CounterTimeline, validate_timeline
from repro_torch.data import DataConfig, SyntheticLM, to_torch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request
from repro_torch.train import init_state, make_explicit_dp_step

ARCH = "gemma3-1b"
TENANTS = ("train", "alice", "bob")
ROUNDS = 6
WAVE = 4                       # serve requests per round (2 per tenant)
MAX_NEW = 4
GLOBAL_BATCH = 16
SEQ_LEN = 32
RANKS = 8                      # repro's 8 host devices
OUT_DIR = "runs/torch"


def _build(cfg=None, device=None):
    """``cfg`` (``repro``'s smoke gemma3 by default), its model on
    ``device`` and the engine's parameters from seed 0."""
    cfg = cfg or get_model_config(ARCH, smoke=True)
    model = build_model(cfg, device=device)
    return cfg, model, model.init(0)


def _dataplane(throttle_train: bool, device=None):
    """One shared dataplane: the train job is tenant ``train``; serve
    traffic rides tenants ``alice``/``bob``.  ``throttle_train`` arms the
    QoS token bucket on the train tenant (the arbitration under test);
    off, the same topology runs unarbitrated for the A/B row."""
    policies = [TelemetryPolicy()]
    if throttle_train:
        policies.append(QoSPolicy(rates={"train": 0.25}, burst=2.0,
                                  stall_ns=200.0))
    return Dataplane(DataplaneConfig(mode="cord", emulate_costs=True),
                     mesh=make_mesh((RANKS,), ("data",)), tenant="train",
                     tenants=TENANTS, policies=policies, device=device)


def _train_setup(model, dp):
    run = RunConfig(train=TrainConfig(steps=ROUNDS, learning_rate=5e-3,
                                      warmup_steps=2))
    step = make_explicit_dp_step(model, run, dp, axis="data",
                                 runtime_accounting=True)
    state = init_state(model, 1)
    ds = SyntheticLM(DataConfig(vocab_size=model.cfg.vocab_size,
                                seq_len=SEQ_LEN, global_batch=GLOBAL_BATCH))
    return step, state, ds


def _serve_engine(cfg, model, params, dp, timeline):
    return Engine(model, params, cfg,
                  ServeConfig(max_batch=2, max_new_tokens=MAX_NEW,
                              kv_cache_len=64),
                  dp=dp, eos_id=-1, obs=timeline)


def _wave(round_i: int) -> list[Request]:
    """One round's serve wave: WAVE requests alternating alice/bob."""
    return [Request(rid=round_i * WAVE + i,
                    prompt=np.asarray((np.arange(8) + 3 * i + round_i) % 97,
                                      np.int32),
                    max_new_tokens=MAX_NEW,
                    tenant=TENANTS[1 + i % 2])
            for i in range(WAVE)]


def _served_tokens(eng) -> dict[str, int]:
    rep = eng.tenant_report()
    return {t: int(rep.get(t, {}).get("tokens", 0)) for t in TENANTS[1:]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def converged_run(throttle_train: bool, rounds: int = ROUNDS,
                  timeline=None, *, cfg=None, device=None) -> dict:
    """Round-interleaved train+serve on one dataplane; returns the row.
    ``cfg`` defaults to ``repro``'s smoke gemma3, ``device`` to the
    card."""
    cfg, model, params = _build(cfg, device)
    dev = model.device
    dp = _dataplane(throttle_train, dev)
    step, state, ds = _train_setup(model, dp)
    eng = _serve_engine(cfg, model, params, dp, timeline)
    rt = dp.runtime_init()

    losses, per_round, train_wall = [], [], 0.0
    for i in range(rounds):
        before = _served_tokens(eng)
        batch = to_torch(ds.batch_at(i), dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics, rt = step(state, batch, rt)
        _sync(dev)
        train_wall += time.perf_counter() - t0
        losses.append(float(metrics["loss"]))

        t0 = time.perf_counter()
        done = eng.run(_wave(i))
        serve_wall = time.perf_counter() - t0
        after = _served_tokens(eng)
        delta = {t: after[t] - before[t] for t in after}
        per_round.append({"round": i, "loss": losses[-1],
                          "served": delta, "serve_wall_s": serve_wall,
                          "completed": len(done)})
        if timeline is not None:
            tick = timeline.samples[-1]["step"] if timeline.samples else i
            timeline.record_event(
                "train_step", tick, tenant="train",
                detail={"round": i, "loss": losses[-1],
                        "throttled": float(
                            dp.runtime_report(rt)["train"]["throttled"])})

    report = dp.runtime_report(rt)
    served = _served_tokens(eng)
    return {"table": "converged", "throttle_train": throttle_train,
            "rounds": rounds, "losses": [round(v, 4) for v in losses],
            "train_wall_s": round(train_wall, 3),
            "served_tokens": served,
            "train_throttled": float(report["train"]["throttled"]),
            "train_ops": float(report["train"]["ops"]),
            "rounds_detail": per_round}


def run_all(fast: bool = False, *, cfg=None, device=None) -> list[dict]:
    """A/B rows: the same converged workload with the train tenant's QoS
    bucket off and on — what arbitration costs the train job and buys the
    serve tenants."""
    rows = []
    rounds = 3 if fast else ROUNDS
    for throttle in (False, True):
        row = converged_run(throttle, rounds=rounds, cfg=cfg, device=device)
        rows.append(row)
        print(json.dumps({k: v for k, v in row.items()
                          if k != "rounds_detail"}))
    path = os.path.join(OUT_DIR, "BENCH_converged.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"bench": "converged", "rows": rows}, f, indent=1)
    print(json.dumps({"table": "converged", "artifact": path}))
    return rows


def dry_run(*, cfg=None, device=None) -> dict:
    """CI smoke for the converged dataplane (see module docstring);
    returns the row and the saved timeline."""
    timeline = CounterTimeline(source="bench-converged")
    row = converged_run(True, rounds=4, timeline=timeline, cfg=cfg,
                        device=device)

    if not all(math.isfinite(v) for v in row["losses"]):
        raise AssertionError(f"a loss is not finite: {row['losses']}")
    for r in row["rounds_detail"]:
        if r["completed"] != WAVE:
            raise AssertionError(f"round {r['round']} completed "
                                 f"{r['completed']} of {WAVE}: {r}")
        for tenant, toks in r["served"].items():
            if not toks > 0:
                raise AssertionError(f"serve tenant {tenant} starved in "
                                     f"round {r['round']}: {r}")
    if not row["train_throttled"] > 0:
        raise AssertionError("QoS bucket never throttled the train tenant "
                             "— arbitration is idle")
    if not row["train_ops"] > 0:
        raise AssertionError("the train tenant issued no dataplane op")

    path = timeline.save(os.path.join(OUT_DIR, "converged_timeline.json"))
    doc = CounterTimeline.load(path)               # schema validation
    validate_timeline(doc)
    if not doc["samples"]:
        raise AssertionError("no serve ticks captured")
    events = [e for e in doc["events"] if e["kind"] == "train_step"]
    if len(events) != 4 or not all("loss" in e["detail"] for e in events):
        raise AssertionError(f"train_step events {events}")
    # serve traffic is visible in the shared artifact (tokens ride the
    # counter block's bytes column, Engine.runtime_counters)
    last = doc["samples"][-1]["tenants"]
    if not any(last.get(t, {}).get("bytes", 0) > 0 for t in TENANTS[1:]):
        raise AssertionError(f"no served bytes in the last sample: {last}")

    print(json.dumps({"table": "converged_dryrun", "timeline": path,
                      "ticks": len(doc["samples"]),
                      "losses": row["losses"],
                      "served_tokens": row["served_tokens"],
                      "train_throttled": row["train_throttled"]}))
    print("converged dry-run ok")
    return {"row": row, "doc": doc, "timeline": path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="the CI smoke: 4 throttled rounds and their gates")
    ap.add_argument("--fast", action="store_true",
                    help="3 rounds a row instead of 6")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.dry_run:
        dry_run(device=args.device)
    else:
        run_all(fast=args.fast, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
