"""Run one cell of `BENCHMARK.json` once, on the machine it starts on.

    python3 cordbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights from the seed, the program's build, warm-up of every
shape the cell's traffic uses) is timed as `setup_s` from the process's
start; then the cell's driver measures for `--seconds`; then the plain
reference judges what the timed path produced.  The last line of
standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer metrics), `device`, with `--trace 1` a `breakdown`, and last
`checks`, each compared number with its limit.  Everything else goes to
standard error.  Without a CUDA device, or with fewer than the cell asks
for, the run prints no result and exits with 3; if `jax`, `jaxlib`,
`flax` or the JAX package `repro` is loaded when the window has closed,
it exits with 4.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """perf_counter's reading at the process's start (from /proc where it
    is readable, else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


T_START = _process_start()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)            # no module of the harness shadows another
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Keep libraries from loading JAX, and every build and kernel cache
    inside the checkout, at fixed paths."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    cache = os.path.join(ROOT, "build", "cordbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)


def forbidden_modules(names=None) -> list[str]:
    """The FORBIDDEN top-level names among the loaded modules (or
    ``names``), each name's part before its first dot compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def result(ctx, out, ok: bool, rows: list) -> dict:
    """The contract's result line for ``out``, a driver's Outcome."""
    import torch

    from cordbench import cells
    cell = ctx.cell
    if ctx.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cells.reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu",
              "count": int(cell.workload["chips"]),
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(ok and out.failed == 0),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": device}
    if ctx.trace and out.busy_s is not None:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
        line["breakdown"] = out.breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line


def execute(ctx):
    """Run ``ctx``'s cell through its driver and judge it: (Outcome,
    correct, [(name, value, limit)])."""
    from cordbench import cells, check
    out = cells.driver(ctx.cell).run(ctx)
    ok, rows = check.judge(out.readings, ctx.cell.limits)
    return out, ok, rows


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    try:
        import torch

        import repro_torch  # noqa: F401
        from cordbench import cells
        from cordbench.common import Ctx, log
    except ImportError as e:
        print(f"cordbench: cannot import the program or the harness: {e}",
              file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"cordbench: the cell needs {need} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device("cuda", 0),
              t_start=T_START)
    out, ok, rows = execute(ctx)
    bad = forbidden_modules()
    if bad:
        log(f"cordbench: forbidden modules loaded: {bad}")
        return 4
    import json
    line = result(ctx, out, ok, rows)
    for k, v in out.readings.items():
        log(f"reading {k}: {v}")
    for name, v, lim in rows:
        log(f"check {name} {v!r} limit {lim!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
