#!/usr/bin/env python3
"""Where the explicit train step's peak device memory goes, on one card.

    python3 tools/train_memory.py ROOT [ROOT ...] [--ranks 4] [--steps 2]
                                  [--out results.json]

Each ROOT is a checkout of this repository (its ``src/`` holds
``repro_torch``).  The roots run one after another, each in a fresh
process, so two commits are compared on the same card in one call.  For
each root the training launcher runs ``--full --ranks R --timeline`` on
gemma3-1b at ``chip_smoke.py`` phase 8b's sizes (global batch 4, seq
256) through phase 8b's dataplane (cost emulation and a QoS bucket),
with the caching allocator's history recorded (Python stacks).  It
replays the history to the moment the most bytes were allocated and
groups the blocks live then by the innermost two frames of
``repro_torch`` that allocated them.  It prints, and writes to
``--out``, the peak (``torch.cuda.max_memory_allocated`` and the
replayed one), each step's loss, and the largest groups at the peak.
It needs a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_ENTRIES = 2_000_000
TOP = 15


def _site(frames) -> str:
    """The innermost two ``repro_torch`` frames of an allocation."""
    port = [f for f in frames if "/repro_torch/" in f["filename"]]
    return " < ".join(
        f"{f['filename'].split('/src/')[-1]}:{f['line']} {f['name']}"
        for f in port[:2]) or "(outside repro_torch)"


def at_peak(trace) -> tuple[int, list]:
    """The most bytes allocated at once in ``trace`` and the blocks live
    then, grouped by allocation site, largest first."""
    live, total, best, best_i = {}, 0, -1, -1
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            total += ev["size"] - live.pop(ev["addr"], 0)
            live[ev["addr"]] = ev["size"]
        elif ev["action"] == "free_completed":
            total -= live.pop(ev["addr"], 0)
        if total > best:
            best, best_i = total, i
    blocks: dict = {}
    for ev in trace[:best_i + 1]:
        if ev["action"] == "alloc":
            blocks[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            blocks.pop(ev["addr"], None)
    groups: dict = {}
    for ev in blocks.values():
        g = groups.setdefault(_site(ev.get("frames", [])), [0, 0])
        g[0] += ev["size"]
        g[1] += 1
    rows = [{"site": k, "gb": v[0] / 1e9, "blocks": v[1]}
            for k, v in groups.items()]
    return best, sorted(rows, key=lambda r: -r["gb"])


def worker(root: str, ranks: int, steps: int) -> dict:
    """One root's launcher run under the allocator's history, in this
    process."""
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    import contextlib
    import dataclasses
    import os
    import tempfile

    import torch
    import repro_torch
    from repro_torch.core import QoSPolicy, TelemetryPolicy
    from repro_torch.launch import train as launch_train

    real_dp = launch_train.Dataplane

    def converged_dp(cfg, mesh=None, policies=None, device=None, **kw):
        pol = list(policies) if policies is not None else [TelemetryPolicy()]
        if not any(isinstance(p, QoSPolicy) for p in pol):
            pol.append(QoSPolicy(rates={"default": 0.25}, burst=2.0,
                                 stall_ns=200.0))
        return real_dp(dataclasses.replace(cfg, emulate_costs=True),
                       mesh=mesh, policies=pol, device=device, **kw)

    launch_train.Dataplane = converged_dp
    torch.cuda.memory._record_memory_history(max_entries=MAX_ENTRIES,
                                             stacks="python")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, \
            open(os.devnull, "w") as devnull, \
            contextlib.redirect_stdout(devnull):
        os.chdir(tmp)
        try:
            _, rep = launch_train.main(
                ["--full", "--ranks", str(ranks), "--timeline",
                 f"steps={steps}", "seq_len=256", "global_batch=4"])
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()
    trace = torch.cuda.memory._snapshot()["device_traces"][0]
    torch.cuda.memory._record_memory_history(enabled=None)
    best, rows = at_peak(trace)
    return {"root": root, "package": repro_torch.__file__, "ranks": ranks,
            "steps": steps, "losses": [m["loss"] for m in rep.metrics],
            "peak_gb": peak / 1e9, "replayed_peak_gb": best / 1e9,
            "trace_events": len(trace),
            "trace_truncated": len(trace) >= MAX_ENTRIES,
            "at_peak": rows[:TOP]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker, args.ranks, args.steps)),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("train_memory: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for root in args.roots:
        r = subprocess.run([sys.executable, __file__, "--worker",
                            str(pathlib.Path(root).resolve()), "--ranks",
                            str(args.ranks), "--steps", str(args.steps)],
                           capture_output=True, text=True, timeout=1200)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(r.stdout.strip().splitlines()[-1])
        runs.append(res)
        print(f"{root} ({res['package']}): {res['ranks']} ranks, "
              f"{res['steps']} steps, losses {res['losses']}; peak "
              f"{res['peak_gb']:.3f} GB (replayed "
              f"{res['replayed_peak_gb']:.3f} GB, {res['trace_events']} "
              f"events, truncated {res['trace_truncated']})", flush=True)
        for row in res["at_peak"]:
            print(f"  {row['gb']:8.3f} GB {row['blocks']:6d} blocks  "
                  f"{row['site']}", flush=True)
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
