"""Port parity for the threshold watchers (``ThresholdWatcher``,
``WatcherGroup`` in ``core/obs.py``) over ``repro``'s own scenarios
(``tests/test_elastic_trigger.py``, ``tests/test_control_plane.py``):
sustain, cooldown, re-arm, the release arm, on-threshold oscillation,
incremental ≡ batch observing and namespaced groups.  Tolerance: exact —
the same event lists (kind, step, t, tenant, detail), gauges, refusals
and error messages."""

import pytest

from repro.configs.base import ElasticConfig as JElastic
from repro.core import obs as jobs

from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.core import obs as tobs

PACKAGES = {"repro": jobs, "port": tobs}


def _ramp(mod, pcts, tenant="noisy", ops_per_window=4.0):
    """Timeline whose windows show the given denied_pct series."""
    t = mod.CounterTimeline(source="ramp")
    ops = den = 0.0
    t.snapshot(0, {tenant: {"ops": 0, "denied": 0}}, t=0.0)
    for i, pct in enumerate(pcts, start=1):
        ops += ops_per_window
        den += ops_per_window * pct / 100.0
        t.snapshot(i, {tenant: {"ops": ops, "denied": den}}, t=float(i))
    return t


def _release(**kw):
    kw.setdefault("sustain", 2)
    kw.setdefault("cooldown", 1)
    kw.setdefault("release_sustain", 2)
    kw.setdefault("release_cooldown", 0)
    return dict(thresholds={"denied_pct": 50.0},
                release={"denied_pct": 10.0}, **kw)


SCENARIOS = {
    # never a streak of 2 / one transient spike
    "alternating": (dict(thresholds={"denied_pct": 50.0}, sustain=2,
                         cooldown=4), [80, 0, 80, 0, 80, 0, 80]),
    "transient": (dict(thresholds={"denied_pct": 50.0}, sustain=2,
                       cooldown=0), [0, 0, 80, 0, 0]),
    # fires once, then the cooldown holds
    "cooldown_holds": (dict(thresholds={"denied_pct": 50.0}, sustain=3,
                            cooldown=10), [80] * 7),
    "rearm": (dict(thresholds={"denied_pct": 50.0}, sustain=2, cooldown=1),
              [80] * 8),
    "recover": (_release(), [80, 80, 0, 0, 0, 0]),
    "two_excursions": (_release(), [80, 80, 0, 0, 0, 80, 80, 0, 0, 0, 0]),
    "no_recover_in_cooldown": (_release(cooldown=4), [80, 80] + [0] * 6),
    "quiet_never_arms": (_release(), [0] * 8),
    "on_threshold": (dict(thresholds={"denied_pct": 50.0}, sustain=2,
                          cooldown=0, release={"denied_pct": 10.0},
                          release_sustain=1),
                     [50, 50, 10, 10, 30, 30, 9]),
    "release_cooldown": (_release(sustain=1, cooldown=0, release_sustain=1,
                                  release_cooldown=2),
                         [80, 0, 80, 0, 0, 0]),
}


def _watch(mod, scenario, incremental: bool):
    kw, pcts = SCENARIOS[scenario]
    kw = dict(kw)
    w = mod.ThresholdWatcher(kw.pop("thresholds"), **kw)
    gauges = []
    if not incremental:
        events = w.observe(_ramp(mod, pcts))
        return events, w.gauges(), w.triggers, w.releases
    t = _ramp(mod, [])
    events, ops, den = [], 0.0, 0.0
    for i, pct in enumerate(pcts, start=1):
        ops, den = ops + 4, den + 4 * pct / 100.0
        t.snapshot(i, {"noisy": {"ops": ops, "denied": den}}, t=float(i))
        events += w.observe(t)
        gauges.append(w.gauges())
    return events, gauges, w.triggers, w.releases


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_watcher_events_equal(scenario):
    j = _watch(jobs, scenario, incremental=False)
    t = _watch(tobs, scenario, incremental=False)
    assert t == j
    # incremental observing (one call a snapshot) fires the same events,
    # and the gauges after every call agree
    ji = _watch(jobs, scenario, incremental=True)
    ti = _watch(tobs, scenario, incremental=True)
    assert ti == ji
    assert ti[0] == t[0]


def test_each_window_is_consumed_once(monkeypatch):
    calls = []
    orig = tobs.CounterTimeline._window

    def counting(self, prev, cur, tenants=None):
        calls.append(cur["step"])
        return orig(self, prev, cur, tenants=tenants)

    monkeypatch.setattr(tobs.CounterTimeline, "_window", counting)
    t = _ramp(tobs, [80, 80, 0, 0, 0])
    kw = _release()
    w = tobs.ThresholdWatcher(kw.pop("thresholds"), **kw)
    w.observe(t)
    w.observe(t)
    assert calls == [1, 2, 3, 4, 5]


def _two_tenants(mod):
    t = mod.CounterTimeline(source="two")
    t.snapshot(0, {"a": {"ops": 0, "denied": 0},
                   "b": {"ops": 0, "throttled": 0}}, t=0.0)
    for i in range(1, 4):
        t.snapshot(i, {"a": {"ops": 4.0 * i, "denied": 4.0 * i},
                       "b": {"ops": 4.0 * i, "throttled": 4.0 * i}},
                   t=float(i))
    return t


def test_tenant_filter_and_multi_field():
    out = []
    for mod in PACKAGES.values():
        w = mod.ThresholdWatcher({"denied_pct": 50.0, "throttled_pct": 50.0},
                                 sustain=2, cooldown=4, tenants=("b",))
        out.append((w.observe(_two_tenants(mod)), w.gauges()))
    assert out[0] == out[1]
    assert [(e["tenant"], e["step"]) for e in out[1][0]] == [("b", 2)]


@pytest.mark.parametrize("kwargs", [
    dict(thresholds={"nope": 1.0}),
    dict(thresholds={}),
    dict(thresholds={"denied_pct": 1.0}, sustain=0),
    dict(thresholds={"denied_pct": 1.0}, cooldown=-1),
    dict(thresholds={"denied_pct": 50.0}, release={"denied_pct": 50.0}),
    dict(thresholds={"denied_pct": 50.0}, release={"bogus": 1.0}),
    dict(thresholds={"denied_pct": 50.0}, release={"denied_pct": 10.0},
         release_sustain=0),
])
def test_watcher_refuses_the_same_configs(kwargs):
    msgs = []
    for mod in PACKAGES.values():
        kw = dict(kwargs)
        with pytest.raises(ValueError) as e:
            mod.ThresholdWatcher(kw.pop("thresholds"), **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_from_config_equal():
    spec = dict(thresholds=("denied_pct=50", "stalls_pct=75.5"), sustain=4,
                cooldown=9, tenants=("x",),
                release_thresholds=("denied_pct=5",), release_sustain=2,
                release_cooldown=3)
    j = jobs.ThresholdWatcher.from_config(JElastic(**spec))
    t = tobs.ThresholdWatcher.from_config(TElastic(**spec))
    for attr in ("thresholds", "sustain", "cooldown", "tenants", "release",
                 "release_sustain", "release_cooldown"):
        assert getattr(t, attr) == getattr(j, attr), attr
    msgs = []
    for mod, cfg in ((jobs, JElastic), (tobs, TElastic)):
        with pytest.raises(ValueError) as e:
            mod.ThresholdWatcher.from_config(cfg(thresholds=("denied",)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _pod(mod):
    t = mod.CounterTimeline(source="pod")
    t.snapshot(0, {"t0": {"ops": 0, "denied": 0},
                   "s0": {"ops": 0, "throttled": 0}}, t=0.0)
    for i in range(1, 8):
        quiet = i > 3
        t.snapshot(i, {"t0": {"ops": 4.0 * i,
                              "denied": 4.0 * min(i, 3)},
                       "s0": {"ops": 4.0 * i,
                              "throttled": 4.0 * min(i, 3) + quiet}},
                   t=float(i))
    return t


def _group(mod, record: bool):
    group = mod.WatcherGroup({
        "train": mod.ThresholdWatcher({"denied_pct": 50.0}, sustain=2,
                                      cooldown=1, tenants=("t0",),
                                      release={"denied_pct": 5.0},
                                      release_sustain=2),
        "serve": mod.ThresholdWatcher({"throttled_pct": 50.0}, sustain=2,
                                      cooldown=1, tenants=("s0",),
                                      release={"throttled_pct": 1.0},
                                      release_sustain=2),
    })
    t = _pod(mod)
    evs = group.observe(t, record=record)
    return evs, t.events, group.gauges()


@pytest.mark.parametrize("record", [True, False])
def test_watcher_group_equal(record):
    j, t = _group(jobs, record), _group(tobs, record)
    assert t == j
    evs, recorded, gauges = t
    assert [e["kind"] for e in evs["train"]] == ["trigger", "recover"]
    assert all(e["detail"]["watcher"] == "serve" for e in evs["serve"])
    assert len(recorded) == (4 if record else 0)
    assert "train_watch_release_streak" in gauges
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="at least one"):
            mod.WatcherGroup({})
        with pytest.raises(ValueError, match="not a"):
            mod.WatcherGroup({"x": object()})
