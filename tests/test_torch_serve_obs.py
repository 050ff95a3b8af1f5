"""Port parity for the serving engine's timelines and the serve-side
control loop.

repro's Engine and repro_torch's, from the same parameters, serve the
same requests with a ``CounterTimeline`` attached: continuous and gang,
fixed stripes and the paged pool, with and without an admission-limited
tenant, every tick and every third.  Tolerance: exact — token streams
with the timeline on and off and across packages, every sample's step,
counters and gauges (the wall stamp ``t`` is the clock's), the
``ServeElasticController``'s exact-resume budget cycle and its events,
and the serve launcher's ``--timeline --elastic`` artifact against
``repro``'s launcher."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import ElasticConfig as JElastic
from repro.configs.base import ServeConfig as JServe
from repro.core import obs as jobs
from repro.core import policies as jpol
from repro.core.dataplane import Dataplane as JDataplane
from repro.launch import serve as jlaunch
from repro.models import build_model as jbuild
from repro.runtime import ServeElasticController as JServeCtl
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ElasticConfig as TElastic
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import obs as tobs
from repro_torch.core import policies as tpol
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.runtime import ServeElasticController as TServeCtl
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest

from torch_port_util import jax_params_np


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _requests(cls, n=4, length=8, max_new=5, burst=False):
    return [cls(rid=i, prompt=np.asarray((np.arange(length) + 3 * i) % 100,
                                         np.int32),
                max_new_tokens=max_new,
                tenant=("burst" if burst and i % 3 == 2 else
                        "steady" if burst else "default"))
            for i in range(n)]


def _dp(cls, cfg_cls, pol, mesh):
    """A cord dataplane whose "burst" tenant is admission-limited, as
    the control-plane smoke's serving host."""
    return cls(cfg_cls(mode="cord"), mesh=mesh, tenant="steady",
               tenants=("steady", "burst"),
               policies=[pol.TelemetryPolicy(),
                         pol.QoSPolicy(rates={"burst": 0.1}, burst=1.0)],
               **({"device": "cpu"} if cls is TDataplane else {}))


def _samples(timeline):
    return [(s["step"], s["tenants"], s["gauges"])
            for s in timeline.samples]


CASES = {
    "continuous": dict(serve={}, every=1),
    "every3": dict(serve={}, every=3),
    "gang": dict(serve={"scheduler": "gang"}, every=1),
    "paged": dict(serve={"block_size": 8}, every=1),
    "qos": dict(serve={}, every=1, qos=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_timeline_matches_jax(case, smoke, mesh8):
    jcfg, jm, jp, tcfg, tm, tp = smoke
    c = CASES[case]
    sc = dict(max_batch=2, max_new_tokens=5, kv_cache_len=64, **c["serve"])
    qos = c.get("qos", False)
    n = 6 if qos else 4
    jdp = _dp(JDataplane, JCfg, jpol, mesh8) if qos else None
    tdp = _dp(TDataplane, TCfg, tpol, make_mesh((8,), ("data",))) \
        if qos else None
    jt, tt = jobs.CounterTimeline(source="s"), tobs.CounterTimeline(source="s")
    jeng = JEngine(jm, jp, jcfg, JServe(**sc), dp=jdp, eos_id=-1, obs=jt,
                   obs_every=c["every"])
    teng = TEngine(tm, tp, tcfg, TServe(**sc), dp=tdp, eos_id=-1, obs=tt,
                   obs_every=c["every"])
    jout = {r.rid: r.out_tokens
            for r in jeng.run(_requests(JRequest, n, burst=qos))}
    tout = {r.rid: r.out_tokens
            for r in teng.run(_requests(TRequest, n, burst=qos))}
    assert tout == jout
    assert tt.samples and _samples(tt) == _samples(jt)
    assert tt.gauge_series() == jt.gauge_series()
    assert set(tt.gauge_series()) == (
        {"active_slots", "queued", "free_blocks"} if "block_size"
        in c["serve"] else {"active_slots", "queued"})
    assert teng._obs_tick_no == jeng._obs_tick_no
    # attaching the timeline changes no token
    plain = TEngine(tm, tp, tcfg, TServe(**sc),
                    dp=_dp(TDataplane, TCfg, tpol,
                           make_mesh((8,), ("data",))) if qos else None,
                    eos_id=-1)
    assert {r.rid: r.out_tokens
            for r in plain.run(_requests(TRequest, n, burst=qos))} == tout
    if qos:
        last = tt.samples[-1]["tenants"]["burst"]
        assert last["throttled"] > 0
    doc = json.loads(json.dumps(tt.to_doc()))
    assert jobs.validate_timeline(doc) is doc


def _ev(kind, step, tenant="default"):
    return {"kind": kind, "step": step, "tenant": tenant, "detail": {}}


def test_serve_budget_cycle_exact_resume_matches_jax(smoke):
    """``repro``'s exact-resume cycle on both engines: a budget shrink at
    tick 3 preempts running slots, the grow-back at tick 14 restores the
    budget, and every request emits the tokens of an undisturbed run."""
    jcfg, jm, jp, tcfg, tm, tp = smoke
    sc = dict(max_batch=3, max_new_tokens=10, kv_cache_len=64)
    cfg = dict(enabled=True, shrink_factor=2,
               thresholds=("throttled_pct=50",),
               release_thresholds=("throttled_pct=10",))
    out = {}
    for name, eng_cls, serve_cls, req_cls, ctl_cls, ecfg, mod, m, p, mc in (
            ("repro", JEngine, JServe, JRequest, JServeCtl, JElastic, jobs,
             jm, jp, jcfg),
            ("port", TEngine, TServe, TRequest, TServeCtl, TElastic, tobs,
             tm, tp, tcfg)):
        base = {r.rid: r.out_tokens for r in eng_cls(
            m, p, mc, serve_cls(**sc), eos_id=-1).run(
                _requests(req_cls, 3, max_new=10))}
        timeline = mod.CounterTimeline(source="elastic-serve")
        eng = eng_cls(m, p, mc, serve_cls(**sc), eos_id=-1, obs=timeline)
        ctl = ctl_cls(ecfg(**cfg), timeline, eng)
        ticks = {"n": 0}

        def hook(_eng, ctl=ctl, ticks=ticks):
            ticks["n"] += 1
            if ticks["n"] == 3:
                ctl.respond([_ev("trigger", ticks["n"])])
            elif ticks["n"] == 14:
                ctl.respond([_ev("recover", ticks["n"])])

        eng.on_tick = hook
        done = {r.rid: r.out_tokens
                for r in eng.run(_requests(req_cls, 3, max_new=10))}
        assert done == base
        out[name] = (done, ctl.shrinks, ctl.grows, eng.slot_budget(),
                     _samples(timeline),
                     [(e["kind"], e["step"], e["detail"])
                      for e in timeline.events])
    assert out["port"] == out["repro"]
    done, shrinks, grows, budget, samples, events = out["port"]
    assert (shrinks, grows, budget) == (1, 1, 3)
    assert [e[2]["direction"] for e in events if e[0] == "budget"] == \
        ["shrink", "grow"]
    last = samples[-1][1]["default"]
    assert last["preemptions"] >= 1 and last["restores"] >= 1


def test_serve_launcher_matches_jax(tmp_path, monkeypatch):
    """``--timeline --elastic``: the port's launcher on the CPU writes the
    artifact ``repro``'s launcher writes (steps, counters, gauges, events;
    the weights differ, the counters do not depend on them)."""
    argv = ["--elastic", "--requests", "6", "--max-new-tokens", "5",
            "--max-batch", "2", "elastic.sustain=2"]
    docs = {}
    for name in ("repro", "port"):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "repro":
            monkeypatch.setattr(sys, "argv", ["serve", *argv])
            jlaunch.main()
        else:
            eng, done, timeline = tlaunch.main([*argv, "--device", "cpu"])
            assert len(done) == 6 and eng.on_tick is not None
        out = "runs" if name == "repro" else "runs/torch"
        with open(f"{out}/gemma3-1b_serve_timeline.json") as f:
            docs[name] = jobs.validate_timeline(json.load(f))
    j, t = docs["repro"], docs["port"]
    assert [(s["step"], s["tenants"], s["gauges"]) for s in t["samples"]] \
        == [(s["step"], s["tenants"], s["gauges"]) for s in j["samples"]]
    assert t["events"] == j["events"] == []
    assert t["source"] == j["source"] == "serve/gemma3-1b"


@pytest.mark.cuda
def test_card_timeline_changes_no_token_and_reads_nothing():
    """On the card: the same tokens with a timeline and without, and a
    snapshot makes no stream sync (sync debug mode "error")."""
    from torch_port_util import cuda_device

    dev = cuda_device()
    cfg = tget("gemma3-1b", smoke=True)
    model = tbuild(cfg, device=dev)
    params = model.init(0)
    sc = TServe(max_batch=2, max_new_tokens=5, kv_cache_len=64)
    timeline = tobs.CounterTimeline(source="card")
    outs = []
    for obs in (None, timeline):
        eng = TEngine(model, params, cfg, sc, eos_id=-1, obs=obs)
        outs.append({r.rid: r.out_tokens
                     for r in eng.run(_requests(TRequest))})
    assert outs[0] == outs[1]
    n = len(timeline.samples)
    assert n == eng._obs_tick_no > 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._obs_snapshot(active=0, queued=0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(timeline.samples) == n + 1
