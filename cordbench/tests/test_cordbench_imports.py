"""Nothing the harness runs loads JAX or the JAX package, compared by
whole top-level module names; without a card, or without the program
beside it, a run prints no result and exits nonzero."""

import os
import pathlib
import shutil
import subprocess
import sys

from cordbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]

PROBE = """
import sys, runpy
sys.argv = ["cordbench/run.py"]
sys.path[:0] = [{root!r}, {src!r}]
import cordbench.run, cordbench.calibrate, cordbench.faults
import cordbench.drivers.serve_waves, cordbench.drivers.train_steps
import cordbench.reference.moe_lm, cordbench.reference.train
from cordbench import cells
for f in ("moe", "dense", "hybrid"):
    cells.family(f)
for m in cells.load("grok1-serve-burst").per_layer + \\
        cells.load("hymba-train-dp2").per_layer:
    cells.reader(m["name"])
import repro_torch.serve, repro_torch.train
print(sorted({{n.split(".")[0] for n in sys.modules}}
             & {{"jax", "jaxlib", "flax", "repro"}}))
"""


def test_forbidden_names_compare_whole_top_levels():
    assert run.forbidden_modules(["repro_torch", "repro_torch.serve",
                                  "reprox", "jax_like", "torch"]) == []
    assert run.forbidden_modules(["repro.core.dataplane", "jaxlib.xla",
                                  "flax", "jax"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_harness_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(ROOT),
                                            src=str(ROOT / "src"))],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "cordbench/run.py", "--workload",
         "grok1-serve-burst", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cordbench", tmp_path / "cordbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "cordbench/run.py", "--workload",
         "hymba-train-dp2", "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout == ""
