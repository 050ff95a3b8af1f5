"""Readings that the limits in `limits/<workload>.json` are set from: the
program's compared numbers over many seeds, the control's (the plain
reference computed from float8 products put in the program's place), and
each planted fault's (`faults.py`).  The benchmark's own runs never run
this.

    python3 cordbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 0] \
        [--out FILE.jsonl]

One process takes every seed: each program run is its set-up and a
window of ``--seconds`` (0: one wave or one step), at the cell's own
sizes.  Each reading is printed as a JSON line (and appended to ``--out``).
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
for _p in (os.path.join(os.path.dirname(HERE), "src"),
           os.path.dirname(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def readings(ctx, seeds, control_seeds, fault_seeds, emit) -> None:
    from cordbench import cells, check, faults, weights
    from cordbench.common import release
    drv = cells.driver(ctx.cell)
    names = faults.FAULTS[drv.KIND]
    cfg = ctx.cell.model_config()
    for seed in seeds:
        ctx.seed = seed
        if drv.KIND == "serve":
            params = weights.make(cfg, seed, ctx.device)
            p = drv.program(ctx, params)
            emit(seed, "program", drv.reference_readings(
                ctx, params, p["rows"], look=True), p["e2e"])
            if seed in control_seeds:
                emit(seed, "control", drv.reference_readings(
                    ctx, params, p["rows"], control=True), None)
            for f in names if seed in fault_seeds else ():
                with faults.planted(f):
                    q = drv.program(ctx, params)
                emit(seed, f, drv.reference_readings(ctx, params, q["rows"]),
                     None)
            del params, p
            release(ctx.device)
            continue
        params = weights.make(cfg, seed, ctx.device)
        p = drv.program(ctx, params)
        del params
        release(ctx.device)
        ref = drv.reference(ctx, p["batches"])
        emit(seed, "program", {**check.train_readings(p["prog"], ref),
                               "losses": p["prog"]["losses"],
                               "reference_losses": ref["losses"],
                               "reference_s": ref["seconds"]}, p["e2e"])
        if seed in control_seeds:
            ctl = drv.reference(ctx, p["batches"], prec="fp8")
            emit(seed, "control", {**check.train_readings(ctl, ref),
                                   "losses": ctl["losses"]}, None)
        for f in names if seed in fault_seeds else ():
            params = weights.make(cfg, seed, ctx.device)
            with faults.planted(f):
                q = drv.program(ctx, params)
            del params
            release(ctx.device)
            emit(seed, f, {**check.train_readings(q["prog"], ref),
                           "losses": q["prog"]["losses"]}, None)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Readings for a cell's limits.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from cordbench import run
    run._environment()
    import torch

    from cordbench import cells
    from cordbench.common import Ctx
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    ctx = Ctx(cell=cells.load(args.workload), seed=0, seconds=args.seconds,
              trace=False, device=torch.device("cuda", 0),
              t_start=time.perf_counter())
    card = run.card_line()

    def emit(seed, what, values, e2e):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "what": what, "card": card, "readings": values,
                           "e2e": e2e})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    readings(ctx, args.seeds, set(args.control_seeds),
             set(args.fault_seeds), emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
