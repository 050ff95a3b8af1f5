"""Port parity for hymba serving: the engine on the hybrid family through
a CoRD dataplane.

repro's Engine and repro_torch's serve hymba-1.5b smoke with the same
parameters through one ``cord`` dataplane with ``emulate_costs``
(tenants train/alice/bob, a QoS policy rate-limiting ``train``), at
temperature 0.  Prompt lengths are no powers of two, so a bucketed
prefill would fold pad tokens into the mamba state and change the
tokens.  Tolerance: exact — token streams, tenant reports and counter
blocks are equal."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_model_config as jget
from repro.configs.base import DataplaneConfig as JCfg
from repro.configs.base import ServeConfig as JServe
from repro.core.dataplane import Dataplane as JDataplane
from repro.core import policies as jpol
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core import CounterTimeline
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core import policies as tpol
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeError

from torch_port_util import jax_params_np, pin_calibration

TENANTS = ("train", "alice", "bob")
LENGTHS = (5, 11, 6, 5, 11, 6)          # three distinct lengths
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=32)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget("hymba-1.5b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("hymba-1.5b", smoke=True)
    tm = tbuild(tcfg, device="cpu")
    tp = from_jax_params(jax_params_np(jp), tcfg, device="cpu")
    return jcfg, jm, jp, tcfg, tm, tp


def _policies(mod):
    return [mod.TelemetryPolicy(),
            mod.QoSPolicy(rates={"train": 0.25}, burst=2.0, stall_ns=200.0)]


def _requests(cls, lengths=LENGTHS, max_new=(6, 4, 6, 5, 6, 3)):
    return [cls(rid=i, prompt=np.asarray((np.arange(n) * 3 + 7 * i) % 97,
                                         np.int32),
                max_new_tokens=m, tenant=TENANTS[1 + i % 2])
            for i, (n, m) in enumerate(zip(lengths, max_new))]


def _torch_engine(smoke, model=None, obs=None, **serve):
    _, _, _, tcfg, tm, tp = smoke
    dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                    mesh=make_mesh((8,), ("data",)), tenant="train",
                    tenants=TENANTS, policies=_policies(tpol), device="cpu")
    return TEngine(model or tm, tp, tcfg, TServe(**{**SERVE, **serve}),
                   dp=dp, eos_id=-1, obs=obs)


def _recording(model, lengths):
    """``model`` with the token count of every prefill appended to
    ``lengths``; asserts that the last real token is the last position
    (no right padding)."""
    def prefill(params, batch, cache, **kw):
        n = batch["tokens"].shape[1]
        assert int(kw["last_pos"][0]) == n - 1
        lengths.append(n)
        return model.prefill(params, batch, cache, **kw)

    return dataclasses.replace(model, prefill=prefill)


def test_engine_matches_jax_through_cord_dataplane(smoke, mesh8, monkeypatch):
    pin_calibration(monkeypatch)
    jcfg, jm, jp, _, tm, _ = smoke
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=mesh8,
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))
    jeng = JEngine(jm, jp, jcfg, JServe(**SERVE), dp=jdp, eos_id=-1)
    jdone = jeng.run(_requests(JRequest))

    seen = []
    teng = _torch_engine(smoke, _recording(tm, seen))
    tdone = teng.run(_requests(TRequest))

    assert {r.rid: r.out_tokens for r in tdone} == \
        {r.rid: r.out_tokens for r in jdone}
    assert all(r.done for r in tdone) and len(tdone) == len(LENGTHS)
    assert teng.tenant_report() == jeng.tenant_report()
    tctrs, ttenants = teng.runtime_counters()
    jctrs, jtenants = jeng.runtime_counters()
    assert ttenants == jtenants
    np.testing.assert_array_equal(tctrs, jctrs)
    assert teng.decode_compile_count() == 1
    # every prompt was prefilled at its exact length, never a bucket
    assert sorted(seen) == sorted(LENGTHS)
    assert {r.mode for r in teng.dp.telemetry.records} == {"cord"}
    assert {"mamba/inner", "mamba/out"} <= set(teng.dp.telemetry.by_tag())


def test_continuous_equals_gang_uniform_prompts(smoke):
    cont = _torch_engine(smoke)
    gang = _torch_engine(smoke)
    lengths = (9,) * 5
    out_c = {r.rid: r.out_tokens
             for r in cont.run(_requests(TRequest, lengths),
                               scheduler="continuous")}
    out_g = {r.rid: r.out_tokens
             for r in gang.run(_requests(TRequest, lengths),
                               scheduler="gang")}
    assert out_c == out_g
    assert cont.decode_compile_count() == 1


def test_budget_preemption_resumes_exactly(smoke):
    """A slot budget lowered mid-run preempts a slot; its request is
    re-prefilled at its exact resume length and emits the tokens of an
    undisturbed run."""
    _, _, _, _, tm, _ = smoke
    calm = _torch_engine(smoke)
    want = {r.rid: r.out_tokens for r in calm.run(_requests(TRequest))}

    seen = []
    # the hook rides the timeline: it runs right after each snapshot
    eng = _torch_engine(smoke, _recording(tm, seen),
                        obs=CounterTimeline(source="squeeze"))
    reqs = _requests(TRequest)
    for r in reqs:
        r.tenant = "alice"

    def squeeze(e):
        if e._obs_tick_no == 2:
            e.set_slot_budget(1)

    eng.on_tick = squeeze
    got = {r.rid: r.out_tokens for r in eng.run(reqs)}
    assert got == want
    rep = eng.tenant_report()["alice"]
    assert rep["preemptions"] >= 1 and rep["restores"] >= 1
    # one exact-length prefill per start and per resume
    assert len(seen) == len(LENGTHS) + rep["restores"]


def test_capacity_uses_exact_length(smoke):
    """A 12-token prompt with 3 new tokens fits a 16-position stripe when
    it is prefilled at its length; a dense model's 16-token bucket does
    not."""
    _, _, _, _, tm, _ = smoke
    seen = []
    eng = _torch_engine(smoke, _recording(tm, seen), max_batch=1,
                        kv_cache_len=16, max_new_tokens=3)
    req = TRequest(rid=0, prompt=np.arange(12, dtype=np.int32),
                   max_new_tokens=3, tenant="alice")
    done = eng.run([req])
    assert len(done[0].out_tokens) == 3 and seen == [12]

    gcfg = tget("gemma3-1b", smoke=True)
    gm = tbuild(gcfg, device="cpu")
    dense = TEngine(gm, gm.init(0), gcfg,
                    TServe(max_batch=1, kv_cache_len=16, max_new_tokens=3))
    with pytest.raises(ServeError, match="prefill cover 16"):
        dense.run([TRequest(rid=0, prompt=np.arange(12, dtype=np.int32),
                            max_new_tokens=3)])
