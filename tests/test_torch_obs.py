"""Port parity for the per-tenant counter timelines (``core/obs.py``).

The same report sequence, with pinned wall stamps ``t``, goes through
``repro.core.obs`` and ``repro_torch.core.obs``.  Tolerance: exact —
rates, windows, gauges, axes, sparklines, panels and documents are
equal; an artifact or a JSONL sink written by either package loads in
the other; both refuse the same malformed documents and misaligned
merges with the same message."""

import json

import numpy as np
import pytest
import torch

from repro.core import obs as jobs
from repro.core import telemetry as jtl

from repro_torch.core import obs as tobs
from repro_torch.core import telemetry as ttl

PACKAGES = {"repro": jobs, "port": tobs}


def _feed(mod, source="feed", **kw):
    """A timeline over five samples: a tenant that arrives late, counters
    that move at different rates, a ``cq_depth`` level, an equal-stamp
    window (the step-delta fallback), gauges and two events."""
    t = mod.CounterTimeline(source=source, **kw)
    t.snapshot(0, {"a": {"ops": 0, "bytes": 0}}, t=0.0,
               gauges={"active_slots": 2})
    t.snapshot(1, {"a": {"ops": 4, "bytes": 4096, "throttled": 1,
                         "denied": 2, "stalls": 3, "chunks": 8,
                         "cq_depth": 3}}, t=2.0)
    t.record_event("trigger", 1, tenant="a", t=2.5,
                   detail={"over": {"denied_pct": 50.0}})
    t.snapshot(2, {"a": {"ops": 8, "bytes": 8192, "throttled": 1,
                         "denied": 2, "stalls": 3, "chunks": 8,
                         "cq_depth": 7, "completions": 4},
                   "b": {"ops": 5, "retransmits": 2, "completions": 4,
                         "cqe_errors": 1}}, t=3.0, gauges={"queued": 1})
    t.snapshot(6, {"a": {"ops": 16, "bytes": 9000, "denied": 10,
                         "preemptions": 1, "restores": 1},
                   "b": {"ops": 9, "timeouts": 1, "srq_grants": 3}},
               t=3.0, gauges={"active_slots": 1, "queued": 0})
    t.record_event("remesh", 6, tenant="a", t=3.5,
                   detail={"direction": "shrink"})
    t.snapshot(7, {"a": {"ops": 20}, "b": {"ops": 9}}, t=4.25)
    return t


def test_series_and_documents_equal():
    j, t = _feed(jobs), _feed(tobs)
    assert t.tenants == j.tenants == ("a", "b")
    assert t.rates() == j.rates()
    assert t.rate_axis() == j.rate_axis()
    assert t.gauge_series() == j.gauge_series()
    for i in (1, 2, 3, 4, -1, -3):
        assert t.window_rates(i) == j.window_rates(i)
        assert t.window_rates(i, tenants=("b", "ghost")) == \
            j.window_rates(i, tenants=("b", "ghost"))
    assert t.to_doc() == j.to_doc()
    assert t.panel() == j.panel()
    assert t.panel(width=8, fields=("ops_s", "denied_pct")) == \
        j.panel(width=8, fields=("ops_s", "denied_pct"))
    for mod in PACKAGES.values():
        with pytest.raises(IndexError):
            _feed(mod).window_rates(0)
        assert mod.CounterTimeline().window_rates() == {}
    assert tobs.RATE_FIELDS == jobs.RATE_FIELDS
    assert tobs.TIMELINE_SCHEMAS == jobs.TIMELINE_SCHEMAS
    assert t.counter_names == j.counter_names == jtl.COUNTER_NAMES


@pytest.mark.parametrize("values, width", [
    ([], 8), ([0, 0, 0], 8), ([5, 5], 8), (list(range(100)), 16),
    ([1, 9], 8), ([3.5, -1.0, 2.25, 7.0, 0.0], 48),
    (np.linspace(0, 1, 97).tolist(), 48), ([float("inf"), 1.0], 8)])
def test_sparkline_equal(values, width):
    assert tobs.sparkline(values, width) == jobs.sparkline(values, width)


def test_snapshot_block_reads_a_tensor_once_as_a_report():
    jctrs = jtl.tenant_counters_init(2)
    jctrs = jtl.tenant_counters_bump(jctrs, 0, ops=2, bytes=128)
    jctrs = jtl.tenant_counters_bump(jctrs, 1, ops=1, throttled=1)
    tctrs = torch.from_numpy(np.asarray(jctrs).copy())
    j = jobs.CounterTimeline(source="blk")
    j.snapshot_block(0, jctrs, ("x", "y"), t=0.0)
    t = tobs.CounterTimeline(source="blk")
    t.snapshot_block(0, tctrs, ("x", "y"), t=0.0)
    t2 = tobs.CounterTimeline(source="blk")
    t2.snapshot(0, ttl.tenant_counters_report(tctrs, ("x", "y")), t=0.0)
    assert t.samples == j.samples == t2.samples
    assert all(type(v) is float
               for s in t.samples for c in s["tenants"].values()
               for v in c.values())


@pytest.mark.parametrize("writer, reader", [("repro", "port"),
                                            ("port", "repro")])
def test_artifact_loads_in_the_other_package(writer, reader, tmp_path):
    w = _feed(PACKAGES[writer], source=writer)
    path = w.save(str(tmp_path / f"{writer}_timeline.json"))
    doc = PACKAGES[reader].CounterTimeline.load(path)
    assert doc == w.to_doc()
    assert doc["schema"] == "cord-timeline/v2"
    # the v1 layout (no events) loads in both
    v1 = {k: v for k, v in doc.items() if k != "events"}
    v1["schema"] = "cord-timeline/v1"
    p1 = tmp_path / "v1.json"
    p1.write_text(json.dumps(v1))
    assert PACKAGES[reader].CounterTimeline.load(str(p1)) == v1


def _malformed():
    """``tests/test_obs.py`` and ``tests/test_elastic_trigger.py``'s
    malformed documents, as (name, doc) pairs."""
    doc = _feed(jobs).to_doc()
    out = {"schema_v999": {**doc, "schema": "cord-timeline/v999"},
           "schema_v3": {**doc, "schema": "cord-timeline/v3"},
           "no_rates": {k: v for k, v in doc.items() if k != "rates"},
           "ghost_tenant": {**doc, "tenants": ["ghost"]},
           "v2_no_events": {k: v for k, v in doc.items() if k != "events"},
           "event_no_step": {**doc, "events": [{"kind": "remesh"}]},
           "not_a_dict": [doc]}
    short = json.loads(json.dumps(doc))
    short["rates"]["a"]["ops_s"] = []
    out["short_rate"] = short
    for what in ("gauges", "axis"):
        bad = json.loads(json.dumps(doc))
        if what == "gauges":
            bad["gauges"] = {"active_slots": [1.0]}
        else:
            bad["axis"]["t"] = bad["axis"]["t"][:-1]
        v1 = {k: v for k, v in bad.items() if k != "events"}
        v1["schema"] = "cord-timeline/v1"
        out[f"v1_short_{what}"] = v1
    no_key = json.loads(json.dumps(doc))
    del no_key["samples"][1]["gauges"]
    out["sample_no_gauges"] = no_key
    return out


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_validate_rejects_the_same_documents(name):
    doc = _malformed()[name]
    msgs = []
    for mod in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            mod.validate_timeline(doc)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("writer, reader", [("repro", "port"),
                                            ("port", "repro")])
def test_jsonl_sink_reads_back_in_the_other_package(writer, reader,
                                                    tmp_path):
    path = str(tmp_path / "run.jsonl")
    w = _feed(PACKAGES[writer], source=writer, sink=path)
    w.close()
    # an event after close joins the same stream, without a new header
    w.record_event("late", 7, tenant="a", t=5.0)
    w.close()
    back = PACKAGES[reader].CounterTimeline.read_jsonl(path)
    assert back.to_doc() == w.to_doc()
    # a second run on the same path is a new stream; the latest wins
    again = PACKAGES[writer].CounterTimeline(source="rerun", sink=path)
    again.snapshot(1, {"a": {"ops": 2}}, t=0.5)
    again.close()
    latest = PACKAGES[reader].CounterTimeline.read_jsonl(path)
    assert latest.source == "rerun" and len(latest.samples) == 1


@pytest.mark.parametrize("rotate", [700, 900, 2500])
def test_rotation_segments_equal(rotate, tmp_path):
    """Both packages seal the same segments at the same byte budget, and
    each package stitches the other's segments into the same run."""
    runs = {}
    for name, mod in PACKAGES.items():
        path = str(tmp_path / f"{name}.jsonl")
        t = mod.CounterTimeline(source="rot", sink=path, rotate_bytes=rotate)
        for i in range(12):
            t.snapshot(i, {"x": {"ops": 4.0 * i}}, t=float(i))
        t.record_event("late", 11, tenant="x", t=11.5)
        t.close()
        runs[name] = (path, t)
    (jp, jt), (tp, tt) = runs["repro"], runs["port"]
    assert tt.rotations == jt.rotations >= 1
    for k in range(1, tt.rotations + 1):
        with open(f"{jp}.{k}") as a, open(f"{tp}.{k}") as b:
            assert a.read() == b.read()
    with open(jp) as a, open(tp) as b:
        assert a.read() == b.read()
    for reader in PACKAGES.values():
        for path, t in runs.values():
            assert reader.CounterTimeline.read_rotated(path).to_doc() == \
                t.to_doc()
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="needs a sink"):
            mod.CounterTimeline(rotate_bytes=64)
        with pytest.raises(FileNotFoundError):
            mod.CounterTimeline.read_rotated(str(tmp_path / "none.jsonl"))


def _parts(mod):
    a = mod.CounterTimeline(source="host0")
    b = mod.CounterTimeline(source="host1")
    for i in range(4):
        a.snapshot(i, {"x": {"ops": 2.0 * i, "bytes": 10.0 * i,
                             "denied": 1.0 * i, "cq_depth": i}},
                   gauges={"queue": 1.0}, t=float(i))
        b.snapshot(i, {"x": {"ops": 6.0 * i, "cq_depth": 5.0},
                       "y": {"ops": 1.0 * i}},
                   gauges={"queue": 2.0}, t=float(i) + 0.25)
    a.record_event("trigger", 2, tenant="x", t=2.0)
    b.record_event("remesh", 2, tenant="x", t=1.5,
                   detail={"direction": "shrink"})
    a.record_event("recover", 3, tenant="x", t=3.5)
    return a, b


def test_merge_gives_equal_docs(tmp_path):
    j = jobs.merge_timelines(_parts(jobs), source="pod")
    t = tobs.merge_timelines(_parts(tobs), source="pod")
    assert t.to_doc() == j.to_doc()
    assert [e["detail"]["origin"] for e in t.events] == \
        ["host1", "host0", "host0"]
    a, _ = _parts(tobs)
    tobs.merge_timelines([a, _parts(tobs)[1]])
    assert "origin" not in a.events[0]["detail"]
    doc = jobs.CounterTimeline.load(t.save(str(tmp_path / "pod.json")))
    assert doc == j.to_doc()


def _misaligned(mod, case):
    ramp = _feed(mod, source="ramp")
    if case == "empty":
        return []
    if case == "lagging":
        short = mod.CounterTimeline(source="short")
        for s in ramp.samples[:-1]:
            short.snapshot(s["step"], s["tenants"], t=s["t"])
        return [ramp, short]
    if case == "skewed":
        skew = mod.CounterTimeline(source="skewed")
        for k, s in enumerate(ramp.samples):
            skew.snapshot(s["step"] + (k == 2), s["tenants"], t=s["t"])
        return [ramp, skew]
    thin = mod.CounterTimeline(source="thin", counter_names=("ops", "bytes"))
    return [ramp, thin]


@pytest.mark.parametrize("case", ["empty", "lagging", "skewed", "layouts"])
def test_merge_refuses_the_same_parts(case):
    msgs = []
    for mod in PACKAGES.values():
        with pytest.raises(ValueError) as e:
            mod.merge_timelines(_misaligned(mod, case))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
