"""Port parity for the control-plane smokes (``repro_torch.bench.
control_plane`` against ``benchmarks/run.py``'s ``control_plane_smoke``
and ``elastic_smoke``) at smoke size on the CPU.

Two "hosts", each a 2-rank ``("rank",)`` mesh with its own dataplane,
state and QP, stream per-process timelines merged into one pod timeline;
a WatcherGroup drives a QP migration there and back and a slot-budget
shrink and grow.  The delay calibration is pinned in both packages.
Tolerance: exact — the event storyline, the merged artifact's samples
and events (kind, step, tenant, detail; a controller's own events carry
the clock's stamp, which is not compared), and the migrated transfers
bit for bit (asserted inside each smoke)."""

import json

import pytest

from benchmarks import run as jbench

from repro_torch.bench import control_plane as tbench
from repro_torch.core import obs as tobs

from torch_port_util import pin_calibration


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_calibration(monkeypatch)


def _events(doc):
    return [(e["kind"], e["step"], e["tenant"], e["detail"])
            for e in doc["events"]]


def _jax_row(capsys, key):
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    return next(r for r in rows if key in r)


def test_control_plane_smoke_matches_jax(tmp_path, monkeypatch, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jbench.control_plane_smoke()
    jrow = _jax_row(capsys, "storyline")
    with open("runs/control_plane_timeline.json") as f:
        jdoc = json.load(f)
    monkeypatch.chdir(tmp_path / "port")
    trow = tbench.control_plane_smoke(device="cpu")
    assert trow["storyline"] == jrow["storyline"]
    assert trow["storyline"][:3] == ["train:trigger", "serve:trigger",
                                     "train:remesh-shrink"]
    assert trow["slot_budget"] == jrow["slot_budget"] == 2
    assert trow["migrated_bit_identical"]
    tdoc = trow["doc"]
    assert _events(tdoc) == _events(jdoc)
    assert tdoc["samples"] == jdoc["samples"]
    assert tdoc["tenants"] == jdoc["tenants"]
    assert tdoc["rates"] == jdoc["rates"]
    with open("runs/torch/control_plane_timeline.json") as f:
        assert tobs.validate_timeline(json.load(f))["source"] == "pod"


def test_elastic_smoke_matches_jax(tmp_path, monkeypatch, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    jbench.elastic_smoke()
    jrow = _jax_row(capsys, "elastic_timeline")
    with open("runs/elastic_timeline.json") as f:
        jdoc = json.load(f)
    monkeypatch.chdir(tmp_path / "port")
    trow = tbench.elastic_smoke(device="cpu")
    assert trow["trigger_step"] == jrow["trigger_step"] == 3
    assert trow["events"] == jrow["events"] == ["trigger", "remesh"]
    # the watched run's samples carry the clock's stamps; the counters
    # and every event but the stamps are equal
    tdoc = trow["doc"]
    assert [(s["step"], s["tenants"], s["gauges"]) for s in tdoc["samples"]] \
        == [(s["step"], s["tenants"], s["gauges"]) for s in jdoc["samples"]]
    assert _events(tdoc) == _events(jdoc)


def test_accumulate_report_matches_jax():
    reports = [{"a": {"ops": 2.0, "cq_depth": 3.0}},
               {"a": {"ops": 1.0, "cq_depth": 1.0},
                "b": {"ops": 4.0, "cq_depth": 0.0}},
               {"b": {"ops": 0.5, "cq_depth": 9.0}}]
    jt, tt = {}, {}
    for r in reports:
        jbench.accumulate_report(jt, r)
        tbench.accumulate_report(tt, r)
    assert tt == jt == {"a": {"ops": 3.0, "cq_depth": 3.0},
                        "b": {"ops": 4.5, "cq_depth": 9.0}}
