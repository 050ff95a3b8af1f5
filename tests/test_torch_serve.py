"""Port parity for the slice as a whole: the serving engine through a
CoRD dataplane.

repro's Engine and repro_torch's are built the way benchmarks/converged.py
builds its serve half — one ``cord`` dataplane with ``emulate_costs``,
tenants train/alice/bob and a QoS policy rate-limiting ``train`` — with
the same parameters, and serve the same mixed-length requests from two
tenants at temperature 0.  Tolerance: exact — token streams, tenant
reports and counter blocks are equal."""

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
from repro.serve import WFQScheduler as JWFQ

from repro_torch.configs import get_model_config as tget
from repro_torch.configs.base import DataplaneConfig as TCfg
from repro_torch.configs.base import ServeConfig as TServe
from repro_torch.core.dataplane import Dataplane as TDataplane
from repro_torch.core import policies as tpol
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build_model as tbuild
from repro_torch.models import from_jax_params
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeError
from repro_torch.serve import WFQScheduler as TWFQ
from repro_torch.serve import prompt_bucket

from torch_port_util import jax_params_np, pin_calibration

TENANTS = ("train", "alice", "bob")
LENGTHS = (5, 9, 12, 3, 16, 7)
SERVE = dict(max_batch=2, max_new_tokens=6, kv_cache_len=32)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget("gemma3-1b", smoke=True)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = tget("gemma3-1b", smoke=True)
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


def _torch_engine(smoke, **serve):
    _, _, _, tcfg, tm, tp = smoke
    dp = TDataplane(TCfg(mode="cord", emulate_costs=True),
                    mesh=make_mesh((8,), ("data",)), tenant="train",
                    tenants=TENANTS, policies=_policies(tpol), device="cpu")
    return TEngine(tm, tp, tcfg, TServe(**{**SERVE, **serve}), dp=dp,
                   eos_id=-1)


def test_engine_matches_jax_through_cord_dataplane(smoke, mesh8, monkeypatch):
    pin_calibration(monkeypatch)
    jcfg, jm, jp, _, _, _ = smoke
    jdp = JDataplane(JCfg(mode="cord", emulate_costs=True), mesh=mesh8,
                     tenant="train", tenants=TENANTS,
                     policies=_policies(jpol))
    jeng = JEngine(jm, jp, jcfg, JServe(**SERVE), dp=jdp, eos_id=-1)
    jdone = jeng.run(_requests(JRequest))

    teng = _torch_engine(smoke)
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
    # every edge of every prefill and decode went through the dataplane
    assert teng.dp.telemetry.records
    assert {r.mode for r in teng.dp.telemetry.records} == {"cord"}


def test_continuous_equals_gang_uniform_prompts(smoke):
    cont = _torch_engine(smoke)
    gang = _torch_engine(smoke)
    lengths = (8,) * 5
    out_c = {r.rid: r.out_tokens
             for r in cont.run(_requests(TRequest, lengths),
                               scheduler="continuous")}
    out_g = {r.rid: r.out_tokens
             for r in gang.run(_requests(TRequest, lengths),
                               scheduler="gang")}
    assert out_c == out_g
    assert cont.decode_compile_count() == 1


def test_budget_preemption_resumes_exactly(smoke):
    """A slot budget lowered mid-run preempts a slot; its request resumes
    by recompute and emits the tokens of an undisturbed run."""
    calm = _torch_engine(smoke)
    want = {r.rid: r.out_tokens for r in calm.run(_requests(TRequest))}

    eng = _torch_engine(smoke)
    reqs = _requests(TRequest)
    for r in reqs:
        r.tenant = "alice"

    def squeeze(e):
        if e._tick_no == 2:
            e.set_slot_budget(1)

    eng.on_tick = squeeze
    got = {r.rid: r.out_tokens for r in eng.run(reqs)}
    assert got == want
    rep = eng.tenant_report()["alice"]
    assert rep["preemptions"] >= 1 and rep["restores"] >= 1
    assert eng.slot_budget() == 1


def test_unported_options_raise(smoke):
    _, _, _, tcfg, tm, tp = smoke
    with pytest.raises(ServeError, match="timelines"):
        TEngine(tm, tp, tcfg, TServe(), obs=object())
    for flag in ("--timeline", "--elastic"):
        with pytest.raises(ServeError, match="timelines"):
            serve_main([flag, "--device", "cpu"])
    eng = TEngine(tm, tp, tcfg, TServe(max_batch=1, kv_cache_len=16,
                                       max_new_tokens=4))
    with pytest.raises(ServeError, match="cache positions"):
        eng.run([TRequest(rid=0, prompt=np.arange(12, dtype=np.int32))])


def test_wfq_and_buckets_match_jax():
    for n in (0, 1, 8, 9, 300, 4096):
        assert prompt_bucket(n) == __import__(
            "repro.serve", fromlist=["prompt_bucket"]).prompt_bucket(n)
    j, t = JWFQ({"a": 0.25, "b": 2.0}), TWFQ({"a": 0.25, "b": 2.0})
    for tenant, cost in [("a", 3), ("b", 5), ("c", 1), ("a", 2), ("b", 1)]:
        for s in (j, t):
            s.note_backlog({"a", "b", "c"})
            s.grant(tenant, cost)
        assert t.vtime == j.vtime and t.vclock == j.vclock
        assert t.order(["a", "b", "c"]) == j.order(["a", "b", "c"])
