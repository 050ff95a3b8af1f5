"""BENCHMARK.json against the benchmark's contract, and every file a cell
names found where the harness looks for it."""

import dataclasses
import json
import pathlib
import re

import pytest

from cordbench import cells

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cordbench"]
    assert BENCH["command"] == ["python3", "cordbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # a full check: 2 + 14 runs a cell of run_seconds + 60, 2 x 90 s of
    # compile a cell, 1200 s spare, within 43200 s with 24 cells
    for cells_n in (n, 24):
        runs = 2 + 14 * cells_n
        assert runs * (BENCH["run_seconds"] + 60) + cells_n * 180 + 1200 \
            <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_and_metrics(w):
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cell = cells.load(w["name"])
    assert cell.mix["driver"] in ("serve_waves", "train_steps")
    assert cells.driver(cell).run
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cells.reader(m["name"]))
        assert m["moves"] in e2e, m
    assert cell.limits["compared"], "a cell compares at least one number"


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_their_cuts(c):
    from repro_torch.configs import get_model_config
    path = ROOT / c["file"]
    assert path.is_relative_to(ROOT / "cordbench")
    doc = json.loads(path.read_text())
    assert doc["source"] == c["source"]
    assert sorted(doc["reduced"]) == sorted(c["reduced"])
    port = dataclasses.asdict(get_model_config(doc["arch"]))
    differ = sorted(k for k in port if port[k] != doc["model"][k])
    assert differ == sorted(c["reduced"])
    for k in c["reduced"]:
        assert not (k.endswith("_dim") or k.endswith("_rank"))
    used = {w["config"] for w in BENCH["workloads"]}
    assert c["name"] in used
